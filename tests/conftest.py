"""Test configuration: an 8-virtual-device CPU platform by default.

Sharding tests need a multi-device mesh without accelerator hardware.  A
JAX_PLATFORMS that is already set is honoured: the GPU tests (marker `gpu`)
run on a card with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
Must run before jax is imported anywhere.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest

if jax.devices()[0].platform == "cpu":
    assert jax.device_count() == 8, "tests expect an 8-virtual-device CPU platform"


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")
    return devs[0]


@pytest.fixture
def rng():
    return np.random.default_rng(37)


def random_dna(rng, n: int) -> str:
    return "".join(rng.choice(list("ACGT"), size=n))


@pytest.fixture
def make_dna(rng):
    def _make(n: int) -> str:
        return random_dna(rng, n)

    return _make
