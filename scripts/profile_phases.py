"""Phase-timing probe for the pairwise pipeline on the current platform.

Drives the PRODUCTION phases of MauveAligner (device-resident K1/K2: SMLs
and mer merges never cross to the host).  Pass --host to also time the
host-transfer path (build_sml / find_multi_mums), which tools and
cross-validation use.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

t_import = time.time()
from mauvealigner_tpu.core.sml import build_sml
from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu.ops import matchops
from mauvealigner_tpu.seeds import default_mer_size, get_seed
from mauvealigner_tpu.utils import simulate

print(f"imports {time.time()-t_import:.1f}s", flush=True)

args = [a for a in sys.argv[1:] if not a.startswith("-")]
host_path = "--host" in sys.argv
N = int(args[0]) if args else 100_000
rng = np.random.default_rng(37)
anc = simulate.random_genome(rng, N)
der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)
genomes = [anc, der]

weight = default_mer_size(N)
seed = get_seed(weight, 0)
print(f"genome {N}bp, seed weight {weight} len {seed.length}", flush=True)

aligner = MauveAligner(AlignerOptions(seed_size=weight, use_sml_cache=False))

# pass 1 pays in-process one-time costs (tracing, persistent-cache load);
# pass 2 is the production steady state
for label in ("cold", "warm"):
    t0 = time.time()
    ml = aligner.find_mums(genomes)
    print(
        f"[{label}] K1+K2 device (SML build + multi-MUMs): {time.time()-t0:.2f}s "
        f"({len(ml)} matches)",
        flush=True,
    )

    t0 = time.time()
    ml2, lcbs = aligner.determine_lcbs(genomes, ml)
    print(
        f"[{label}] LCBs: {time.time()-t0:.2f}s ({len(lcbs)} LCBs, {len(ml2)} anchors)",
        flush=True,
    )

    t0 = time.time()
    ml3, lcbs = aligner.recursive_anchor(genomes, ml2, lcbs)
    print(f"[{label}] recursion: {time.time()-t0:.2f}s ({len(ml3)} anchors)", flush=True)

    t0 = time.time()
    ivl = aligner.build_intervals(genomes, ml3, lcbs)
    print(
        f"[{label}] closure: {time.time()-t0:.2f}s "
        f"({sum(iv.n_cols for iv in ivl.intervals)} cols)",
        flush=True,
    )

if host_path:
    t0 = time.time()
    smls = [build_sml(g, seed) for g in genomes]
    print(
        f"[host] K1 SML build+download: {time.time()-t0:.1f}s "
        f"({len(smls[0].keys)} mers)",
        flush=True,
    )
    t0 = time.time()
    ml_h = matchops.find_multi_mums(genomes, smls)
    print(f"[host] K2 multi-MUMs: {time.time()-t0:.1f}s ({len(ml_h)} matches)", flush=True)
