"""Where the system runs: the compile cache, chip_smoke.py without a GPU,
and (marker `gpu`, on a card only) K3 and progressiveMauve on the GPU
against the CPU."""

import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mauvealigner_tpu.ops import dp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_of_child(env_update):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, mauvealigner_tpu; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    assert _cache_dir_of_child({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout():
    assert _cache_dir_of_child({}) == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """chip_smoke.py exits nonzero and prints no result line without a GPU,
    and in a directory holding nothing else of the repo."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if where == "alone":
        cwd = str(tmp_path)
        script = os.path.join(cwd, "chip_smoke.py")
        with open(os.path.join(REPO, "chip_smoke.py")) as src, open(script, "w") as dst:
            dst.write(src.read())
        env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


# ----------------------------------------------------------- GPU tests

def _k3(kind, side, rng, dev):
    from mauvealigner_tpu.models.closure import bucket_batch

    B = min(bucket_batch(side), 64)
    la = rng.integers(side // 2 + 1, side + 1, size=B).astype(np.int32)
    lb = rng.integers(side // 2 + 1, side + 1, size=B).astype(np.int32)
    if kind == "codes":
        a = np.where(np.arange(side) < la[:, None], rng.integers(0, 5, (B, side)), 255)
        b = np.where(np.arange(side) < lb[:, None], rng.integers(0, 5, (B, side)), 255)
        a, b = a.astype(np.uint8), b.astype(np.uint8)
    else:
        a = rng.integers(0, 4, (B, side, 5)).astype(np.float32)
        b = rng.integers(0, 4, (B, side, 5)).astype(np.float32)
        a[np.arange(side)[None, :] >= la[:, None]] = 0
        b[np.arange(side)[None, :] >= lb[:, None]] = 0
    with jax.default_device(dev):
        args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
                jnp.asarray(dp.HOXD70), jnp.float32(dp.DEFAULT_GAP_OPEN),
                jnp.float32(dp.DEFAULT_GAP_EXTEND))
        if kind == "codes":
            scores, dec = dp._gotoh_codes(*args, M=side, N=side)
        else:
            scores, dec = dp.gotoh_forward_scored(
                *args, M=side, N=side, normalize=kind == "normalized")
        tb = dp.gotoh_traceback_packed(dec, args[2], args[3], scores, side, side)
        return np.asarray(scores), np.asarray(dec), np.asarray(tb)


@pytest.mark.gpu
@pytest.mark.parametrize("side", [16, 64, 256, 1024, 4096])
@pytest.mark.parametrize("kind", ["codes", "counts"])
def test_k3_gpu_matches_cpu(gpu, side, kind):
    """K3 as XLA compiles it for the GPU: decision bytes, tracebacks and
    scores identical to the CPU's for code pairs and count profiles."""
    got = _k3(kind, side, np.random.default_rng(side), gpu)
    want = _k3(kind, side, np.random.default_rng(side), jax.devices("cpu")[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_progressive_gpu_matches_cpu(gpu):
    from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions
    from mauvealigner_tpu.utils import simulate

    genomes, _ = simulate.enterobacteria_set(20_000, 3, seed=37)
    texts = []
    for dev in (gpu, jax.devices("cpu")[0]):
        with jax.default_device(dev):
            res = ProgressiveMauve(ProgressiveOptions(use_sml_cache=False)).align(genomes)
        buf = io.StringIO()
        res.interval_list.write_xmfa(buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
