"""apply_inversion_with_truth: the simulation oracle must survive
rearrangements (the truth alignment stays exact after inverting a derived
segment)."""

import numpy as np

from mauvealigner_tpu.analysis.score_alignment import score_alignment
from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu.utils import simulate


def test_truth_self_score_perfect_after_inversion(rng):
    anc = simulate.random_genome(rng, 3000)
    der, truth = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    der2, truth2 = simulate.apply_inversion_with_truth(der, truth, 1000, 2000)
    s = score_alignment(truth2, truth2, [len(anc), len(der2)])
    assert s.sensitivity == 1.0 and s.ppv == 1.0


def test_double_inversion_truth(rng):
    anc = simulate.random_genome(rng, 4000)
    der, truth = simulate.evolve(anc, rng, sub_rate=0.01)
    der, truth = simulate.apply_inversion_with_truth(der, truth, 500, 1200)
    der, truth = simulate.apply_inversion_with_truth(der, truth, 2500, 3300)
    s = score_alignment(truth, truth, [len(anc), len(der)])
    assert s.sensitivity == 1.0 and s.ppv == 1.0
    assert len(truth.intervals) == 5


def test_aligner_recovers_inversion_against_truth(rng):
    """End-to-end: aligned output scored against the rearranged truth."""
    anc = simulate.random_genome(rng, 12_000)
    der, truth = simulate.evolve(anc, rng, sub_rate=0.02, ins_rate=0.001, del_rate=0.001)
    der, truth = simulate.apply_inversion_with_truth(der, truth, 4000, 8000)
    res = MauveAligner(AlignerOptions(seed_size=11, use_sml_cache=False)).align([anc, der])
    s = score_alignment(truth, res.interval_list, [len(anc), len(der)])
    assert s.sensitivity > 0.9, s.summary()
    assert s.ppv > 0.9, s.summary()


def test_enterobacteria_set_truths_score_perfectly():
    """The simulated set's truth alignments, scored against themselves as
    one n-way list, give sn = ppv = 1 for every (0, i) pair."""
    from mauvealigner_tpu.analysis.score_alignment import score_against_truths
    from mauvealigner_tpu.core.interval import IntervalList
    from mauvealigner_tpu.utils import simulate

    genomes, truths = simulate.enterobacteria_set(30_000, 4, seed=37)
    assert len(genomes) == 4 and len(truths) == 3
    assert any(iv.starts[1] < 0 for iv in truths[1].intervals)  # an inversion
    for i, t in enumerate(truths, start=1):
        scored = score_against_truths(
            IntervalList(genomes=[genomes[0], genomes[i]], intervals=t.intervals),
            [len(genomes[0]), len(genomes[i])], [t],
        )
        p = scored.pairs[(0, 1)]
        assert p.sensitivity == 1.0 and p.ppv == 1.0 and p.tp > 0
