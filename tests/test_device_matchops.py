"""Cross-validation: the device-resident K2 pipeline must reproduce the host
reference implementation exactly."""

import numpy as np
import pytest

from mauvealigner_tpu.core.sml import build_sml, build_sml_device
from mauvealigner_tpu.genome.sequence import Genome, revcomp_ascii
from mauvealigner_tpu.ops import matchops, merops
from mauvealigner_tpu.seeds import SOLID_SEED, get_seed
from mauvealigner_tpu.utils import simulate


def _canon(ml):
    rows = np.concatenate([ml.starts, ml.lengths[:, None]], axis=1)
    return set(map(tuple, rows.tolist()))


def _both_paths(genomes, seed, **kw):
    smls = [build_sml(g, seed) for g in genomes]
    host = matchops.find_multi_mums(genomes, smls, **kw)
    dev = matchops.find_multi_mums_device(
        genomes,
        [build_sml_device(g, seed) for g in genomes],
        seed_length=seed.length,
        **kw,
    )
    return host, dev


def test_upload_codes_roundtrip(make_dna):
    seq = make_dna(1000) + "N" * 7 + make_dna(50)
    g = Genome.from_string(seq)
    seed = get_seed(9, 0)
    dev = np.asarray(build_sml_device(g, seed)[0])
    ref = build_sml(g, seed)
    n_valid = int((dev != merops.INVALID_KEY).sum())
    assert n_valid == len(ref.keys)
    assert np.array_equal(dev[:n_valid], ref.keys)


@pytest.mark.parametrize("divergence", [0.0, 0.01, 0.05])
def test_device_matches_host_pairwise(rng, divergence):
    anc = simulate.random_genome(rng, 3000)
    der, _ = simulate.evolve(anc, rng, sub_rate=divergence, ins_rate=divergence / 5,
                             del_rate=divergence / 5)
    seed = get_seed(9, 0)
    host, dev = _both_paths([anc, der], seed)
    assert _canon(host) == _canon(dev)


def test_device_matches_host_with_inversion(rng):
    anc = simulate.random_genome(rng, 4000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01)
    der = simulate.apply_inversion(der, 1500, 2500)
    seed = get_seed(9, 0)
    host, dev = _both_paths([anc, der], seed)
    assert _canon(host) == _canon(dev)


def test_device_matches_host_three_way(rng):
    anc = simulate.random_genome(rng, 2000)
    d1, _ = simulate.evolve(anc, rng, sub_rate=0.02)
    d2, _ = simulate.evolve(anc, rng, sub_rate=0.02)
    seed = get_seed(9, SOLID_SEED)
    host, dev = _both_paths([anc, d1, d2], seed)
    assert _canon(host) == _canon(dev)


def test_device_seq_mask(rng):
    anc = simulate.random_genome(rng, 1500)
    d1, _ = simulate.evolve(anc, rng, sub_rate=0.01)
    d2, _ = simulate.evolve(anc, rng, sub_rate=0.01)
    seed = get_seed(9, 0)
    mask = np.array([1, 1, 0], np.int32)
    host, dev = _both_paths([anc, d1, d2], seed, seq_mask=mask)
    # masked-out genome never participates
    assert (dev.starts[:, 2] == 0).all()
    assert _canon(host) == _canon(dev)


def test_cap_overflow_auto_retry(rng, recwarn):
    """A capacity-busting input must auto-retry with a doubled cap and
    return the same matches as an ample-cap run, with no truncation
    warnings (repeat-dense genomes must not silently lose anchors)."""
    from mauvealigner_tpu.core.sml import build_sml_device

    anc = simulate.random_genome(rng, 6000)
    # scatter point substitutions so nearly every anchor run is short:
    # maximizes the run count relative to the entry count
    der, _ = simulate.evolve(anc, rng, sub_rate=0.05)
    seed = get_seed(9, 0)
    smls_dev = [build_sml_device(g, seed) for g in [anc, der]]
    big = matchops.find_multi_mums_device(
        [anc, der], smls_dev, seed_length=seed.length
    )
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any truncation warning -> failure
        small = matchops.find_multi_mums_device(
            [anc, der], smls_dev, seed_length=seed.length, initial_cap=16
        )
    assert len(big) > 16  # the tiny cap genuinely overflowed
    assert _canon(big) == _canon(small)


def test_sketch_preserves_coverage(rng):
    """A 1/8 mer sketch must preserve the COVERAGE signal the distance
    matrix and the tree-progressive gate consume: extension grows every
    sampled seed to its maximal extent, so covered positions survive even
    though WHICH overlapping inexact-match variants appear can differ
    (spaced-seed matches tolerate don't-care mismatches, and distinct
    window runs extend to overlapping variants on both paths)."""
    from mauvealigner_tpu.core.sml import build_mer_list_device

    anc = simulate.random_genome(rng, 20_000)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.005)
    seed = get_seed(11, 0)
    smls = [build_mer_list_device(g, seed) for g in [anc, der]]
    full = matchops.find_multi_mums_device([anc, der], smls, seed_length=seed.length)
    sk = matchops.find_multi_mums_device(
        [anc, der], smls, seed_length=seed.length, sketch_mod=8
    )

    def covered(ml, col, n):
        mask = np.zeros(n + 2, bool)
        for s, ln in zip(ml.starts[:, col], ml.lengths):
            if s == 0:
                continue
            l = abs(int(s))
            mask[l : l + int(ln)] = True
        return mask

    for col, g in ((0, anc), (1, der)):
        cf = covered(full, col, len(g))
        cs = covered(sk, col, len(g))
        assert cs.sum() >= 0.95 * cf.sum()
        # the sketch must not claim coverage the full search lacks
        assert (cs & ~cf).sum() <= 0.01 * max(cf.sum(), 1)
