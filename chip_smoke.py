#!/usr/bin/env python3
"""End-to-end smoke test of the aligner on one NVIDIA GPU.

    python chip_smoke.py              # phases 1-5 on one card
    python chip_smoke.py --four-gpus  # phase 6 only: 4-card mesh vs 1 card

Phases (everything runs in this one process; no second process opens the
card):
  1. card and set-up: nvidia-smi name and power limit, JAX devices, the
     compile-cache directory, the JAX version;
  2. K3 (the Gotoh wavefront) as XLA compiles it for the GPU against the
     same code on the CPU, at every closure bucket and batch size, for code
     pairs, uint8 count profiles and normalized profiles: decision bytes,
     tracebacks and scores identical (normalized: scores within rtol 1e-5,
     see _score_matrix in ops/dp.py); prints each bucket's warm GPU time;
  3. progressiveMauve through the CLI on 4 simulated 4.6 Mbp genomes
     (utils/simulate.enterobacteria_set, seed 37), cold and warm, each pair
     scored against the simulation truth (sn and ppv >= 0.97);
  4. mauveAligner through the CLI on the first two of those genomes, with
     the same checks;
  5. progressiveMauve on 3 x 50 kbp, once on the GPU and once on the CPU:
     the two XMFA files must be byte-identical;
  6. (--four-gpus only) phase 3's input through progressiveMauve
     --mesh-devices=4 and on one card: byte-identical XMFA.

Exits nonzero, and prints no result line, without a GPU or when any phase
fails.  The last line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke")
OUT = os.path.join(ROOT, "chiprun_out")
MIN_ACCURACY = 0.97
N_GENOMES, GENOME_SIZE = 4, 4_600_000


def log(msg: str = "") -> None:
    print(msg, flush=True)


def peak_gb() -> float:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


def write_fastas(genomes, tag: str):
    from mauvealigner_tpu.genome.fasta import write_fasta

    paths = []
    for i, g in enumerate(genomes):
        p = os.path.join(WORK, f"{tag}_{i}.fasta")
        write_fasta(g, p)
        paths.append(p)
    return paths


# --------------------------------------------------------------- phase 1

def phase_setup(ctx) -> None:
    import jax

    from mauvealigner_tpu.utils.timing import card_info

    log(f"card: {card_info()}")
    devs = jax.devices()
    log(f"jax {jax.__version__}; devices: {devs}")
    log(f"device_kind: {devs[0].device_kind}; count: {len(devs)}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")


# --------------------------------------------------------------- phase 2

def _related(rng, n: int, rate: float = 0.1):
    import numpy as np

    a = rng.integers(0, 4, size=n).astype(np.uint8)
    b = a.copy()
    sub = rng.random(n) < rate
    b[sub] = (b[sub] + rng.integers(1, 4, size=int(sub.sum()))) % 4
    keep = rng.random(n) > rate / 3
    return a, b[keep]


def _k3_inputs(rng, side: int, B: int, kind: str):
    import numpy as np

    lo = side // 2 + 1
    la = rng.integers(lo, side + 1, size=B).astype(np.int32)
    lb = np.zeros(B, np.int32)
    if kind == "codes":
        A = np.full((B, side), 255, np.uint8)
        Bc = np.full((B, side), 255, np.uint8)
        for k in range(B):
            a, b = _related(rng, int(la[k]))
            b = b[:side]
            A[k, : len(a)] = a
            Bc[k, : len(b)] = b
            lb[k] = len(b)
        return A, Bc, la, lb
    # count profiles of 3-member groups (uint8, as the closure ships them)
    pa = np.zeros((B, side, 5), np.uint8)
    pb = np.zeros((B, side, 5), np.uint8)
    for k in range(B):
        for _ in range(3):
            a, b = _related(rng, int(la[k]), rate=0.15)
            b = b[:side]
            pa[k, np.arange(len(a)), a] += 1
            pb[k, np.arange(len(b)), b] += 1
            lb[k] = max(lb[k], len(b))
    return pa, pb, la, lb


def _timed(fn, reps: int = 3):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def phase_k3(ctx) -> None:
    """K3 as XLA compiles it for the GPU against the same code on the CPU,
    at every closure bucket and batch size."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mauvealigner_tpu.models.closure import PROFILE_BUCKETS, bucket_batch
    from mauvealigner_tpu.ops import dp

    rng = np.random.default_rng(37)
    rows, failures = [], []
    for side in PROFILE_BUCKETS:
        B = bucket_batch(side)
        for kind in ("codes", "counts", "normalized"):
            a, b, la, lb = _k3_inputs(rng, side, B, "codes" if kind == "codes" else "counts")

            def run(dev):
                with jax.default_device(dev):
                    subst = jnp.asarray(dp.HOXD70)
                    go = jnp.float32(dp.DEFAULT_GAP_OPEN)
                    ge = jnp.float32(dp.DEFAULT_GAP_EXTEND)
                    la_d, lb_d = jnp.asarray(la), jnp.asarray(lb)
                    if kind == "codes":
                        a_d, b_d = jnp.asarray(a), jnp.asarray(b)
                        fwd = lambda: dp._gotoh_codes(
                            a_d, b_d, la_d, lb_d, subst, go, ge, M=side, N=side)
                    else:
                        a_d = jnp.asarray(a).astype(jnp.float32)
                        b_d = jnp.asarray(b).astype(jnp.float32)
                        fwd = lambda: dp.gotoh_forward_scored(
                            a_d, b_d, la_d, lb_d, subst, go, ge, M=side, N=side,
                            normalize=kind == "normalized")
                    scores, dec = fwd()
                    tb = dp.gotoh_traceback_packed(dec, la_d, lb_d, scores, side, side)
                    out = (np.asarray(scores), np.asarray(dec), np.asarray(tb))
                    t = _timed(fwd) if dev == jax.devices()[0] else None
                return out, t

            (gs, gd, gt), t_gpu = run(jax.devices()[0])
            (cs, cd, ct), _ = run(jax.devices("cpu")[0])
            row = {
                "bucket": side, "batch": B, "input": kind,
                "gpu_forward_ms": t_gpu * 1e3,
                "gpu_gcups": float(B) * side * side / t_gpu / 1e9,
                "dec_identical": bool(np.array_equal(gd, cd)),
                "dec_bytes_differing": int(np.sum(gd != cd)),
                "traceback_identical": bool(np.array_equal(gt, ct)),
                "scores_equal": bool(np.array_equal(gs, cs)),
                "max_score_diff": float(np.max(np.abs(gs - cs))),
            }
            rows.append(row)
            log("  " + json.dumps(row))
            if kind == "normalized":
                # XLA compiles float32 division to div.full.f32 on NVIDIA
                # GPUs (within 2 ulp of the CPU's IEEE quotient): near-tied
                # paths may choose differently; scores stay within rtol 1e-5
                ok = np.allclose(gs, cs, rtol=1e-5, atol=1e-3)
            else:
                ok = row["dec_identical"] and row["traceback_identical"] and row["scores_equal"]
            if not ok:
                failures.append(f"{kind}@{side}")
            del gd, cd, gt, ct
    ctx["k3"] = rows
    if failures:
        raise AssertionError(f"GPU K3 differs from the CPU at {failures}")


# --------------------------------------------------------------- phase 3/4

def _genomes(ctx, size: int, k: int):
    from mauvealigner_tpu.utils import simulate

    key = (size, k)
    if key not in ctx.setdefault("genomes", {}):
        t0 = time.perf_counter()
        genomes, truths = simulate.enterobacteria_set(size, k, seed=37)
        paths = write_fastas(genomes, f"g{size}")
        ctx["genomes"][key] = (genomes, truths, paths)
        log(f"  generated {k} x {size} bp in {time.perf_counter() - t0:.1f} s")
    return ctx["genomes"][key]


def _run_cli(argv) -> float:
    from mauvealigner_tpu.tools.cli import main
    from mauvealigner_tpu.utils import timing

    timing.GLOBAL.reset()
    t0 = time.perf_counter()
    rc = main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    return wall


def _check_accuracy(xmfa: str, genomes, truths, label: str):
    from mauvealigner_tpu.analysis.score_alignment import score_against_truths
    from mauvealigner_tpu.core.interval import IntervalList

    ivl = IntervalList.read_xmfa(xmfa, genomes=list(genomes))
    n_lcbs = sum(1 for iv in ivl.intervals if iv.multiplicity() >= 2)
    scored = score_against_truths(ivl, [len(g) for g in genomes], truths)
    pairs = {f"{i}-{j}": (round(p.sensitivity, 5), round(p.ppv, 5))
             for (i, j), p in sorted(scored.pairs.items())}
    worst_sn = min(p.sensitivity for p in scored.pairs.values())
    worst_ppv = min(p.ppv for p in scored.pairs.values())
    log(f"  {label}: {n_lcbs} LCBs; per pair (sn, ppv): {pairs}; "
        f"worst sn {worst_sn:.5f} ppv {worst_ppv:.5f}")
    if worst_sn < MIN_ACCURACY or worst_ppv < MIN_ACCURACY:
        raise AssertionError(f"{label}: accuracy below {MIN_ACCURACY}")
    return n_lcbs, worst_sn, worst_ppv


def _timed_runs(argv, label: str, runs: int):
    from mauvealigner_tpu.utils import timing

    walls = []
    for r in range(runs):
        walls.append(_run_cli(argv))
        log(f"  {label} run {r} ({'cold' if r == 0 else 'warm'}): "
            f"{walls[-1]:.3f} s; peak device memory so far {peak_gb():.2f} GB")
    log("  phase split of the last run:")
    for line in timing.GLOBAL.report().splitlines():
        log("    " + line)
    return walls, dict(timing.GLOBAL.phases)


def phase_progressive(ctx, n_genomes: int, size: int) -> None:
    genomes, truths, paths = _genomes(ctx, size, n_genomes)
    out = os.path.join(WORK, "prog.xmfa")
    argv = ["progressiveMauve", f"--output={out}", "--disable-cache", *paths]
    walls, phases = _timed_runs(argv, "progressiveMauve", 2)
    for ext in ("", ".backbone", ".bbcols", ".guide_tree"):
        if not os.path.exists(out + ext) or os.path.getsize(out + ext) == 0:
            raise AssertionError(f"missing output {out + ext}")
    path = "ladder" if "tree_progressive" in phases else "extant"
    log(f"  path: {path}")
    n_lcbs, sn, ppv = _check_accuracy(out, genomes, truths, "progressiveMauve")
    ctx["progressive"] = {
        "genomes": n_genomes, "size": size, "path": path, "cold_s": walls[0],
        "warm_s": walls[1], "lcbs": n_lcbs, "worst_sn": sn, "worst_ppv": ppv,
        "phases": phases, "peak_gb": peak_gb(),
    }


def phase_pairwise(ctx, n_genomes: int, size: int) -> None:
    genomes, truths, paths = _genomes(ctx, size, n_genomes)
    genomes, truths, paths = genomes[:2], truths[:1], paths[:2]
    out = os.path.join(WORK, "pair.xmfa")
    argv = ["mauveAligner", f"--output={os.path.join(WORK, 'pair.mums')}",
            f"--output-alignment={out}", *paths]
    walls, phases = _timed_runs(argv, "mauveAligner", 2)
    n_lcbs, sn, ppv = _check_accuracy(out, genomes, truths, "mauveAligner")
    ctx["pairwise"] = {"cold_s": walls[0], "warm_s": walls[1], "lcbs": n_lcbs,
                       "worst_sn": sn, "worst_ppv": ppv, "phases": phases,
                       "peak_gb": peak_gb()}


# --------------------------------------------------------------- phase 5

def phase_gpu_vs_cpu(ctx) -> None:
    import jax

    from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions
    from mauvealigner_tpu.utils import simulate

    genomes, _ = simulate.enterobacteria_set(50_000, 3, seed=37)
    outs = {}
    for label, dev in (("gpu", jax.devices()[0]), ("cpu", jax.devices("cpu")[0])):
        t0 = time.perf_counter()
        with jax.default_device(dev):
            res = ProgressiveMauve(ProgressiveOptions(use_sml_cache=False)).align(genomes)
        path = os.path.join(WORK, f"small_{label}.xmfa")
        res.interval_list.write_xmfa(path)
        with open(path, "rb") as fh:
            outs[label] = fh.read()
        log(f"  {label}: {len(outs[label])} bytes in {time.perf_counter() - t0:.2f} s")
    if outs["gpu"] != outs["cpu"]:
        a, b = outs["gpu"].splitlines(), outs["cpu"].splitlines()
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        raise AssertionError(
            f"GPU and CPU XMFA differ from line {first} ({len(a)} vs {len(b)} lines)")
    log("  XMFA byte-identical")


# --------------------------------------------------------------- phase 6

def phase_four_gpus(ctx, size: int, n_genomes: int) -> None:
    import jax

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-gpus needs 4 GPUs, found {len(jax.devices())}")
    genomes, truths, paths = _genomes(ctx, size, n_genomes)
    outs = {}
    # one output path for both runs: the XMFA names its backbone file
    out = os.path.join(WORK, "prog_mesh.xmfa")
    for label, extra in (("one", []), ("mesh4", ["--mesh-devices=4"])):
        argv = ["progressiveMauve", f"--output={out}", "--disable-cache", *extra, *paths]
        wall = _run_cli(argv)
        with open(out, "rb") as fh:
            outs[label] = fh.read()
        log(f"  {label}: {wall:.3f} s, {len(outs[label])} bytes")
    _check_accuracy(out, genomes, truths, "mesh4")
    if outs["mesh4"] != outs["one"]:
        raise AssertionError("4-card mesh XMFA differs from the one-card XMFA")
    log("  XMFA byte-identical (4-card mesh vs one card)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only phase 6 (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (jax.devices() = {devs})", file=sys.stderr)
        return 2
    import mauvealigner_tpu  # noqa: F401  (x64 and the compile cache)

    os.makedirs(WORK, exist_ok=True)
    os.makedirs(OUT, exist_ok=True)
    ctx: dict = {}
    if args.four_gpus:
        phases = [("1 card and set-up", lambda: phase_setup(ctx)),
                  ("6 four-card mesh", lambda: phase_four_gpus(ctx, GENOME_SIZE, N_GENOMES))]
    else:
        phases = [
            ("1 card and set-up", lambda: phase_setup(ctx)),
            ("2 K3 on GPU vs CPU", lambda: phase_k3(ctx)),
            ("3 progressiveMauve", lambda: phase_progressive(ctx, N_GENOMES, GENOME_SIZE)),
            ("4 mauveAligner pairwise", lambda: phase_pairwise(ctx, N_GENOMES, GENOME_SIZE)),
            ("5 GPU vs CPU", lambda: phase_gpu_vs_cpu(ctx)),
        ]
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
            status = "passed"
        except Exception:
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(name)
            status = "FAILED"
        log(f"== phase {name}: {status} in {time.perf_counter() - t0:.1f} s")
    ctx.pop("genomes", None)
    ctx["failed"] = failed
    from mauvealigner_tpu.utils.timing import card_info

    ctx["card"] = card_info()
    ctx["total_s"] = time.perf_counter() - t_all
    with open(os.path.join(OUT, "chip_smoke_summary.json"), "w") as fh:
        json.dump(ctx, fh, indent=1, default=str)
    shutil.rmtree(WORK, ignore_errors=True)
    log(f"card (name, power limit): {ctx['card']}")
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
