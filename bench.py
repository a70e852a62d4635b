"""Benchmark: end-to-end pairwise whole-genome alignment on device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Config 1 of BASELINE.md: pairwise alignment (MUM anchoring + LCBs + gapped
closure -> XMFA) of two ~1% divergent 1 Mbp genomes.

vs_baseline denominator: the reference binaries cannot be built (libMems is
absent from the snapshot), so the baseline is MEASURED on this host by
scripts/measure_baseline.py — a single-threaded C++ -O3 reference-class
pipeline (native/reference_pipeline.cpp) run on the identical genomes, in
the reference's actual closure architecture (one fork/exec'd DP child per
inter-anchor gap, the MuscleInterface subprocess structure).  The in-process
lower bound is also recorded; both appear in the detail block.  If
BASELINE_MEASURED.json is missing, the historical 45 s estimate is used and
flagged as such.
"""

import io
import json
import os
import sys
import time

import numpy as np

ESTIMATED_BASELINE_S = 45.0
GENOME_SIZE = 1_000_000


def _load_measured_baseline():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE_MEASURED.json")
    try:
        with open(path) as fh:
            rec = json.load(fh)
        import platform

        bl_host = rec.get("hostname")
        cur_host = platform.node()
        if bl_host and bl_host != cur_host:
            print(
                f"WARNING: BASELINE_MEASURED.json was measured on host "
                f"{bl_host!r} but this is {cur_host!r}; re-run "
                f"scripts/measure_baseline.py for a same-host baseline",
                file=sys.stderr,
            )
        return (
            float(rec["architecture_s"]),
            float(rec["lower_bound_s"]),
            bl_host,
        )
    except Exception:
        return None, None, None


def main():
    from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner
    from mauvealigner_tpu.utils import simulate, timing

    rng = np.random.default_rng(37)
    anc = simulate.random_genome(rng, GENOME_SIZE)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)

    opts = AlignerOptions(use_sml_cache=False)
    aligner = MauveAligner(opts)

    # run 1 (cold): includes any XLA compiles not already in the persistent
    # cache; the warm runs measure the production steady state, taken as the
    # best of three warm repeats.
    t0 = time.time()
    res = aligner.align([anc, der])
    cold = time.time() - t0

    warm_times = []
    for _ in range(3):
        t0 = time.time()
        res = aligner.align([anc, der])
        buf = io.StringIO()
        res.interval_list.write_xmfa(buf)
        warm_times.append(time.time() - t0)
    elapsed = min(warm_times)

    aligned_cols = sum(iv.n_cols for iv in res.interval_list.intervals)
    arch_s, lower_s, baseline_host = _load_measured_baseline()
    baseline_s = arch_s if arch_s is not None else ESTIMATED_BASELINE_S
    import jax

    dev = jax.devices()[0]
    result = {
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": timing.card_info(),
        },
        "metric": "pairwise_1mbp_wallclock",
        "value": round(elapsed, 3),
        "unit": "s",
        "vs_baseline": round(baseline_s / elapsed, 3),
        "detail": {
            "genome_size": GENOME_SIZE,
            "cold_wallclock_s": round(cold, 3),
            "warm_runs_s": [round(t, 3) for t in warm_times],
            "n_lcbs": len(res.lcbs),
            "n_anchors": len(res.mums),
            "aligned_columns": int(aligned_cols),
            "baseline_source": (
                "measured (BASELINE_MEASURED.json, reference closure "
                "architecture)" if arch_s is not None else "estimate"
            ),
            "baseline_s": round(baseline_s, 3),
            "baseline_host": baseline_host,
            "cpu_lower_bound_s": lower_s,
            "vs_cpu_lower_bound": (
                round(lower_s / elapsed, 3) if lower_s else None
            ),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py: no GPU found (jax.devices() = {jax.devices()})",
              file=sys.stderr)
        raise SystemExit(1)
    main()
