"""Mesh-sharded ProgressiveMauve equivalence.

The flagship progressive pipeline under an 8-virtual-device CPU mesh must
produce byte-identical XMFA to the single-device run: the sharded N-way
anchor search is canonical-order equivalent, and every batched kernel
underneath (closure/refinement Gotoh, backbone HMM decode) is per-element
independent, so batch sharding is lossless.  Reference analog: the MPI
aligner stub + offset-partitioned match logs
(projects/mpiMauveAligner.vcproj, src/mauveAligner.cpp:533-589,723-744).
"""

import io
import os

import numpy as np
import pytest

from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions
from mauvealigner_tpu.parallel import make_mesh
from mauvealigner_tpu.utils import simulate


def _xmfa(res) -> str:
    buf = io.StringIO()
    res.interval_list.write_xmfa(buf)
    return buf.getvalue()


def _family(rng, n, size, sub_rate, invert_some=True):
    anc = simulate.random_genome(rng, size)
    genomes = []
    for i in range(n):
        g, _ = simulate.evolve(
            anc, rng, sub_rate=sub_rate, ins_rate=0.001, del_rate=0.001
        )
        if invert_some and i % 2 == 1:
            a = size // 4
            g = simulate.apply_inversion(g, a, a + size // 5)
        g.name = f"g{i}"
        genomes.append(g)
    return genomes


def _run(genomes, mesh, **opts):
    pm = ProgressiveMauve(ProgressiveOptions(mesh=mesh, **opts))
    return pm.align(genomes)


def test_mesh_progressive_extant_identical(rng):
    """Extant (full-multiplicity anchoring) path, 3-way with an inversion."""
    genomes = _family(rng, 3, 30_000, 0.03)
    x1 = _xmfa(_run(genomes, None, tree_progressive=False))
    x2 = _xmfa(_run(genomes, make_mesh(8), tree_progressive=False))
    assert x1 == x2
    assert x1.count(">") >= 3


def test_mesh_progressive_ladder_identical(rng):
    """Tree-progressive (consensus-ladder) path, 4-way with inversions —
    node-merge anchor searches, closure DP and the backbone decode all ride
    the mesh."""
    genomes = _family(rng, 4, 25_000, 0.06)
    x1 = _xmfa(_run(genomes, None, tree_progressive=True))
    x2 = _xmfa(_run(genomes, make_mesh(8), tree_progressive=True))
    assert x1 == x2


def test_mesh_progressive_threaded_ladder_identical(rng):
    """Concurrent node merges (thread pool) under the mesh still produce the
    serial post-order result: each merge is a pure function of its child
    profiles."""
    genomes = _family(rng, 5, 20_000, 0.06)
    try:
        os.environ["MAUVE_TP_WORKERS"] = "1"
        x1 = _xmfa(_run(genomes, None, tree_progressive=True))
        os.environ["MAUVE_TP_WORKERS"] = "4"
        x2 = _xmfa(_run(genomes, make_mesh(8), tree_progressive=True))
    finally:
        os.environ.pop("MAUVE_TP_WORKERS", None)
    assert x1 == x2


@pytest.mark.slow
def test_mesh_progressive_9way_halfmeg_identical(rng):
    """An 8-virtual-device CPU mesh produces
    byte-identical XMFA to single-device on a 9-way >= 500 kbp input with
    inversions."""
    genomes = _family(rng, 9, 500_000, 0.05)
    x1 = _xmfa(_run(genomes, None))
    x2 = _xmfa(_run(genomes, make_mesh(8)))
    assert x1 == x2
