"""BASELINE config 3 at REAL enterobacteria scale: 9 x ~4.6 Mbp genomes,
10-20% pairwise divergence with inversions, full progressiveMauve on the
default JAX device.  Emits one JSON line: warm wall-clock, per-phase split, and the
simulation-oracle accuracy of every ancestor-derived pairwise projection
(the truth survives the inversions via apply_inversion_with_truth).

Usage: python scripts/bench_enterobacteria.py [genome_size] [n_genomes] [repeats]
Defaults: 4_600_000 9 2 (the first run includes compilation).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def build_genomes(size: int, k: int, max_rate: float = 0.08):
    from mauvealigner_tpu.utils import simulate

    return simulate.enterobacteria_set(size, k, max_rate, seed=37)


def main(size: int, k: int, repeats: int, max_rate: float = 0.08):
    from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions
    from mauvealigner_tpu.utils import timing

    t0 = time.time()
    genomes, truths = build_genomes(size, k, max_rate)
    gen_s = time.time() - t0

    times = []
    res = None
    for r in range(repeats):
        timing.GLOBAL.reset()
        t0 = time.time()
        res = ProgressiveMauve(ProgressiveOptions(use_sml_cache=False)).align(genomes)
        times.append(time.time() - t0)
        print(json.dumps({"run": r, "wallclock_s": round(times[-1], 2)}),
              file=sys.stderr, flush=True)
        print(timing.GLOBAL.report(), file=sys.stderr, flush=True)

    t0 = time.time()
    from mauvealigner_tpu.analysis.score_alignment import score_against_truths

    scored = score_against_truths(
        res.interval_list, [len(g) for g in genomes], truths
    )
    acc = [
        {"pair": f"{i}-{j}", "sn": round(p.sensitivity, 4), "ppv": round(p.ppv, 4)}
        for (i, j), p in sorted(scored.pairs.items())
    ]
    score_s = time.time() - t0

    # measurement protocol (round-4 lesson: 36% same-session spread made
    # round-over-round deltas uninterpretable): the headline is the MEDIAN
    # of the in-process warm reps (run 0 is the cold rep), with the spread
    # recorded; claim deltas only beyond the spread.
    warm = sorted(times[1:]) if len(times) > 1 else times
    median = warm[len(warm) // 2] if len(warm) % 2 else (
        warm[len(warm) // 2 - 1] + warm[len(warm) // 2]
    ) / 2
    spread = (max(warm) - min(warm)) / median if median else 0.0
    # measured reference-class N-way denominator (task-4 round 5):
    # scripts/measure_baseline_nway.py writes it for the same generator
    vs_baseline = None
    bl_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..",
        "BASELINE_NWAY_MEASURED.json",
    )
    try:
        with open(bl_path) as fh:
            bl = json.load(fh)
        if bl.get("genome_size") == size and bl.get("n_genomes") == k:
            vs_baseline = {
                "baseline_architecture_s": bl["architecture_s"],
                "baseline_lower_bound_s": bl["lower_bound_s"],
                "vs_architecture": round(bl["architecture_s"] / median, 2),
                "vs_lower_bound": round(bl["lower_bound_s"] / median, 2),
            }
    except Exception:
        pass
    out = {
        "config": f"progressive_{k}way_{size//1000}kbp"
        + (f"_rate{max_rate}" if max_rate != 0.08 else ""),
        "wallclock_warm_s": round(median, 2),
        "warm_reps_s": [round(t, 2) for t in times[1:]],
        "warm_spread_frac": round(spread, 3),
        "wallclock_cold_s": round(times[0], 2),
        "phases": {p: round(t, 2) for p, t in timing.GLOBAL.phases.items()},
        "n_lcbs": len(res.lcbs),
        "n_anchors": len(res.mums),
        "n_backbone_rows": len(res.backbone_rows),
        "accuracy": acc,
        "mean_sn": round(float(np.mean([a["sn"] for a in acc])), 4),
        "mean_ppv": round(float(np.mean([a["ppv"] for a in acc])), 4),
        "vs_baseline": vs_baseline,
        "genome_gen_s": round(gen_s, 1),
        "scoring_s": round(score_s, 1),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 4_600_000
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 9
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    max_rate = float(sys.argv[4]) if len(sys.argv) > 4 else 0.08
    main(size, k, reps, max_rate)
