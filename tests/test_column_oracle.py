"""Column-identity oracle: JAX pipeline vs the C++ reference-class pipeline.

native/reference_pipeline.cpp (--emit-aln) writes the exact column
structure of its chained collinear pairwise alignment — anchors plus
per-gap affine-traceback op strings under the shared tie convention
(diag > up > left, open beats extend).  The JAX MauveAligner in collinear
mode must reproduce it position-for-position on the collinear pairwise
config (the reference XMFA writer whose semantics
both realize: src/mauveAligner.cpp:702,750).
"""

import os
import subprocess
import tempfile

import numpy as np

from mauvealigner_tpu.analysis.score_alignment import pair_position_maps
from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu.seeds import default_mer_size, get_seed
from mauvealigner_tpu.utils import simulate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "native", "reference_pipeline.cpp")
BIN = os.path.join(ROOT, "native", "reference_pipeline")


def _build() -> str:
    if not (
        os.path.exists(BIN) and os.path.getmtime(BIN) >= os.path.getmtime(SRC)
    ):
        subprocess.run(["g++", "-O3", "-std=c++17", SRC, "-o", BIN], check=True)
    return BIN


def _ref_map(emit_path: str, len_a: int) -> np.ndarray:
    """1-based A-position -> B-position map from an --emit-aln file
    (0 = unaligned; forward-only: the collinear config has no inversions)."""
    amap = np.zeros(len_a + 1, np.int64)
    ga = gb = 0
    with open(emit_path) as fh:
        for line in fh:
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "A":
                a0, b0, ln = (int(x) for x in toks[1:4])
                amap[a0 + 1 : a0 + ln + 1] = np.arange(
                    b0 + 1, b0 + ln + 1, dtype=np.int64
                )
                ga, gb = a0 + ln, b0 + ln
            elif toks[0] == "G":
                ops = toks[1] if len(toks) > 1 else ""
                ia, ib = ga, gb
                for op in ops:
                    if op == "D":
                        amap[ia + 1] = ib + 1
                        ia += 1
                        ib += 1
                    elif op == "U":
                        ia += 1
                    else:
                        ib += 1
            # "S la lb": over-cap gap, both pipelines leave it unaligned
    return amap


def test_column_identity_collinear_pairwise(rng):
    size = 150_000
    anc = simulate.random_genome(rng, size, name="a")
    der, _ = simulate.evolve(
        anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005, name="b"
    )
    weight = default_mer_size((len(anc) + len(der)) // 2)
    seed = get_seed(weight, 0)
    binary = _build()
    with tempfile.TemporaryDirectory() as td:
        fa, fb, fo = (os.path.join(td, x) for x in ("a.raw", "b.raw", "aln.tsv"))
        anc.codes.astype(np.uint8).tofile(fa)
        der.codes.astype(np.uint8).tofile(fb)
        subprocess.run(
            [binary, seed.pattern, fa, fb, "--emit-aln", fo],
            check=True,
            capture_output=True,
        )
        ref = _ref_map(fo, len(anc))
    aligner = MauveAligner(
        AlignerOptions(
            seed_size=weight,
            collinear=True,
            recursive=False,
            lcb_extension=False,
            use_sml_cache=False,
        )
    )
    res = aligner.align([anc, der])
    ours = pair_position_maps(res.interval_list, [len(anc), len(der)])[(0, 1)]
    span = np.nonzero(ref)[0]
    assert len(span) > size // 2, "oracle chain covers too little"
    lo, hi = span[0], span[-1]
    mism = np.nonzero(ref[lo : hi + 1] != ours[lo : hi + 1])[0]
    assert len(mism) == 0, (
        f"{len(mism)} of {hi - lo + 1} columns differ from the C++ oracle "
        f"(first at A-position {lo + mism[0]}: ref={ref[lo + mism[0]]} "
        f"ours={ours[lo + mism[0]]})"
    )


def _ref_map_lcbs(emit_path: str, len_a: int) -> np.ndarray:
    """Signed 1-based A-position -> B-position map from an --emit-lcbs file
    (negative = reverse strand, 0 = unaligned)."""
    amap = np.zeros(len_a + 1, np.int64)
    fwd = True
    ga = gb = 0
    with open(emit_path) as fh:
        for line in fh:
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "L":
                fwd = toks[2] == "0"
            elif toks[0] == "A":
                a0, b0, ln = (int(x) for x in toks[1:4])
                if fwd:
                    amap[a0 + 1 : a0 + ln + 1] = np.arange(
                        b0 + 1, b0 + ln + 1, dtype=np.int64
                    )
                    gb = b0 + ln
                else:
                    amap[a0 + 1 : a0 + ln + 1] = -np.arange(
                        b0 + ln, b0, -1, dtype=np.int64
                    )
                    gb = b0 - 1
                ga = a0 + ln
            elif toks[0] == "G":
                ops = toks[1] if len(toks) > 1 else ""
                step = 1 if fwd else -1
                for op in ops:
                    if op == "D":
                        amap[ga + 1] = (gb + 1) * (1 if fwd else -1)
                        ga += 1
                        gb += step
                    elif op == "U":
                        ga += 1
                    else:
                        gb += step
            elif toks[0] == "S":
                la, lb = int(toks[1]), int(toks[2])
                ga += la
                gb += lb if fwd else -lb
    return amap


def test_column_identity_lcbs_with_inversion(rng):
    """LCB-mode oracle: breakpoint elimination +
    per-LCB gapped columns must match the C++ reference-class pipeline
    position-for-position on a pairwise config with an inversion."""
    size = 150_000
    anc = simulate.random_genome(rng, size, name="a")
    der, _ = simulate.evolve(
        anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005, name="b"
    )
    codes = der.codes.copy()
    codes[60_000:95_000] = (3 - np.minimum(codes[60_000:95_000], 3))[::-1]
    from mauvealigner_tpu.genome.sequence import Genome

    der = Genome.from_codes(codes, name="b")
    weight = default_mer_size((len(anc) + len(der)) // 2)
    seed = get_seed(weight, 0)
    binary = _build()
    with tempfile.TemporaryDirectory() as td:
        fa, fb, fo = (os.path.join(td, x) for x in ("a.raw", "b.raw", "lcb.tsv"))
        anc.codes.astype(np.uint8).tofile(fa)
        der.codes.astype(np.uint8).tofile(fb)
        out = subprocess.run(
            [binary, seed.pattern, fa, fb, "--emit-lcbs", fo],
            check=True,
            capture_output=True,
            text=True,
        )
        import json

        rec = json.loads(out.stdout)
        ref = _ref_map_lcbs(fo, len(anc))
    assert rec["n_lcbs"] >= 3, rec  # inversion must split the chain
    aligner = MauveAligner(
        AlignerOptions(
            seed_size=weight,
            recursive=False,
            lcb_extension=False,
            use_sml_cache=False,
        )
    )
    res = aligner.align([anc, der])
    assert len(res.lcbs) == rec["n_lcbs"], (len(res.lcbs), rec["n_lcbs"])
    ours = pair_position_maps(res.interval_list, [len(anc), len(der)])[(0, 1)]
    # rows are signed; compare over every A position (including unaligned)
    mism = np.nonzero(ref[1:] != ours[1:])[0]
    assert len(mism) == 0, (
        f"{len(mism)} of {size} positions differ from the C++ LCB oracle "
        f"(first at A-position {1 + mism[0]}: ref={ref[1 + mism[0]]} "
        f"ours={ours[1 + mism[0]]})"
    )
