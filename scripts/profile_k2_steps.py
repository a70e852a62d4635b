"""Fence-synchronized step timing of the device K1+K2 path (anchor search).

Each step ends with a 1-element (or full) download so the wall-clock
attributes to the step that actually runs it (dispatch is asynchronous).

Usage: python scripts/profile_k2_steps.py [genome_size] [reps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from mauvealigner_tpu.core import sml as smlmod
from mauvealigner_tpu.ops import matchops, merops
from mauvealigner_tpu.seeds import default_mer_size, get_seed
from mauvealigner_tpu.utils import simulate


def fence(x) -> None:
    np.asarray(x[..., -1] if getattr(x, "ndim", 0) else x)


def main(size: int, reps: int):
    rng = np.random.default_rng(37)
    anc = simulate.random_genome(rng, size)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)
    genomes = [anc, der]
    weight = default_mer_size(size)
    seed = get_seed(weight, 0)

    for r in range(reps):
        label = "cold" if r == 0 else f"warm{r}"
        t_all = time.time()

        t0 = time.time()
        smls_dev = []
        for g in genomes:
            kp = smlmod.build_mer_list_device(g, seed)
            smls_dev.append(kp)
        for k, p in smls_dev:
            fence(k)
        t_k1 = time.time() - t0

        t0 = time.time()
        keys, seq_ids, pos = matchops._concat_device_smls(smls_dev)
        fence(keys)
        t_concat = time.time() - t0

        n_seqs = 2
        N = int(keys.shape[0])
        cap = max(1 << 14, N >> 3)
        pack_ok = all(int(k.shape[0]) <= (1 << 23) for k, _ in smls_dev)

        t0 = time.time()
        packed_tab = matchops.device_mum_candidates(
            keys, seq_ids, pos, jnp.asarray(np.ones(2, np.int32)), n_seqs,
            cap, 2, pack_sort=pack_ok,
        )
        first = min(1 + (1 << 12), cap + 1)
        head = np.asarray(packed_tab[:first])
        t_cand = time.time() - t0

        n_runs = int(head[0, 0])
        t0 = time.time()
        ml = matchops.decode_mum_table(
            head, n_seqs, cap, seed.length,
            fetch=lambda rb: np.asarray(packed_tab[:rb]),
        )
        t_decode = time.time() - t0

        t0 = time.time()
        ml2 = matchops.extend_matches_maximal(ml, [g.codes for g in genomes])
        t_ext = time.time() - t0

        print(
            f"[{label}] total {time.time()-t_all:6.2f}s | K1 pack {t_k1:6.2f} "
            f"concat+pad {t_concat:6.2f} candidates+head {t_cand:6.2f} "
            f"decode+fetch {t_decode:6.2f} extend {t_ext:6.2f} "
            f"(N={N} runs={n_runs} matches={len(ml2)})",
            flush=True,
        )


if __name__ == "__main__":
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 4_600_000
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    main(size, reps)
