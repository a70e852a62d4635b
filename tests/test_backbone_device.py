"""Device-resident backbone symbol path vs the host symbol path.

pairwise_homology_bits computes pair symbols, emission lookup, both-gap
inert handling, decode and thresholding on device from shared code-row
uploads; the host path (pairwise_homology_posteriors) stays as the
cross-validation reference.  Both must agree column-for-column
(ref detectAndApplyBackbone,
src/progressiveMauve.cpp:226-260).
"""

import numpy as np

from mauvealigner_tpu.analysis import backbone as bb
from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions
from mauvealigner_tpu.utils import simulate


def _alignment(rng, n=4, size=20_000):
    anc = simulate.random_genome(rng, size)
    genomes = []
    for i in range(n):
        g, _ = simulate.evolve(
            anc, rng, sub_rate=0.05, ins_rate=0.002, del_rate=0.002
        )
        if i % 2 == 1:
            g = simulate.apply_inversion(g, size // 4, size // 2)
        g.name = f"g{i}"
        genomes.append(g)
    res = ProgressiveMauve(ProgressiveOptions(skip_backbone=True)).align(genomes)
    ivl = res.interval_list
    ivl.add_unaligned_intervals()
    return genomes, ivl


def test_device_bits_match_host_posteriors(rng):
    genomes, ivl = _alignment(rng)
    params = bb.adapted_params(bb.compute_gc(genomes))
    old = bb.pairwise_homology_posteriors(ivl, params, threshold=0.5)
    new = bb.pairwise_homology_bits(ivl, params, threshold=0.5)
    assert old, "no pairs decoded"
    for k, o in old.items():
        n = new[k]
        assert len(o) == len(n)
        assert (o == n).all(), f"bits differ at {k}"
    # pairs absent from the host dict (zero live columns) must be all-False
    for k in set(new) - set(old):
        assert not new[k].any()


def test_device_bits_chunked_stitching(rng):
    """Forced chunking (small max_cols) must agree with the host path's
    compacted chunked decode."""
    genomes, ivl = _alignment(rng, n=3)
    params = bb.adapted_params(bb.compute_gc(genomes))
    old = bb.pairwise_homology_posteriors(ivl, params, max_cols=4096, threshold=0.5)
    new = bb.pairwise_homology_bits(ivl, params, max_cols=4096, overlap=1024)
    for k, o in old.items():
        assert (o == new[k]).all(), f"chunked bits differ at {k}"


def test_detect_backbone_device_equals_host(rng):
    genomes, ivl = _alignment(rng)
    params = bb.adapted_params(bb.compute_gc(genomes))
    s_host = bb.detect_backbone(ivl, params, device_symbols=False)
    s_dev = bb.detect_backbone(ivl, params, device_symbols=True)
    key = lambda s: (s.interval_index, s.col_start, s.col_end, tuple(s.seqs))
    assert [key(s) for s in s_host] == [key(s) for s in s_dev]
