"""Sequence evolution simulator with known-truth alignments.

The reference validates aligners against simulated genomes with known
correct alignments (scoreAlignment's "correct alignment" input,
src/scoreAlignment.cpp:102-113).  This module provides that simulator:
it evolves an ancestor by substitutions/indels/inversions and emits the
true pairwise alignment as an IntervalList (one interval per collinear
segment, strand-aware).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mauvealigner_tpu.core.interval import Interval, IntervalList
from mauvealigner_tpu.genome.sequence import Genome, revcomp_ascii

_BASES = np.frombuffer(b"ACGT", np.uint8)


def random_genome(rng: np.random.Generator, n: int, name: str = "anc") -> Genome:
    return Genome(_BASES[rng.integers(0, 4, size=n)], name=name)


def evolve(
    ancestor: Genome,
    rng: np.random.Generator,
    sub_rate: float = 0.01,
    ins_rate: float = 0.002,
    del_rate: float = 0.002,
    mean_indel: float = 3.0,
    name: str = "der",
) -> Tuple[Genome, IntervalList]:
    """Evolve a collinear descendant; returns (derived, truth alignment).

    The truth IntervalList covers the two genomes [ancestor, derived] with a
    single collinear interval.
    """
    anc = ancestor.seq
    out: List[np.ndarray] = []
    row_a: List[np.ndarray] = []
    row_d: List[np.ndarray] = []
    i = 0
    n = len(anc)
    while i < n:
        r = rng.random()
        if r < del_rate:
            k = 1 + rng.poisson(mean_indel)
            k = min(k, n - i)
            row_a.append(np.ones(k, bool))
            row_d.append(np.zeros(k, bool))
            i += k
        elif r < del_rate + ins_rate:
            k = 1 + rng.poisson(mean_indel)
            ins = _BASES[rng.integers(0, 4, size=k)]
            out.append(ins)
            row_a.append(np.zeros(k, bool))
            row_d.append(np.ones(k, bool))
        else:
            base = anc[i]
            if rng.random() < sub_rate:
                base = _BASES[(np.searchsorted(_BASES, base) + rng.integers(1, 4)) % 4]
            out.append(np.array([base], np.uint8))
            row_a.append(np.ones(1, bool))
            row_d.append(np.ones(1, bool))
            i += 1
    derived = Genome(np.concatenate(out) if out else np.zeros(0, np.uint8), name=name)
    aln = np.stack([np.concatenate(row_a), np.concatenate(row_d)])
    iv = Interval(np.array([1, 1], np.int64), aln)
    truth = IntervalList(genomes=[ancestor, derived], intervals=[iv])
    return derived, truth


def apply_inversion(genome: Genome, left: int, right: int) -> Genome:
    """Return a copy with [left, right] (1-based inclusive) reverse-complemented."""
    seq = genome.seq.copy()
    seq[left - 1 : right] = revcomp_ascii(seq[left - 1 : right])
    return Genome(seq, name=genome.name + "_inv")


def apply_inversion_with_truth(
    derived: Genome, truth: IntervalList, left: int, right: int
) -> Tuple[Genome, IntervalList]:
    """Reverse-complement derived[left..right] (1-based inclusive) AND update
    the truth alignment, so the simulation oracle survives rearrangements.

    The collinear truth interval splits at the columns holding derived
    positions `left` and `right`; the middle block's derived row flips to
    the negative strand with start -left.  The boolean pattern is unchanged:
    a negative-strand row consumes positions right-to-left as columns
    advance, which is exactly the new homology map
    new_derived[(left+right)-d] = revcomp(old_derived[d]).

    `truth` must be a 2-genome collinear truth from evolve() whose interval
    may already contain earlier inversion splits; the inverted range must
    fall entirely inside one forward-strand piece.
    """
    g2 = apply_inversion(derived, left, right)
    new_intervals: List[Interval] = []
    handled = False
    for iv in truth.intervals:
        s = int(iv.starts[1])
        row = iv.aln[1]
        length = int(row.sum())
        if s <= 0 or not (s <= left and right <= s + length - 1):
            new_intervals.append(iv)
            continue
        assert not handled, "inversion range spans multiple truth pieces"
        handled = True
        cols_with = np.nonzero(row)[0]
        c0 = int(cols_with[left - s])
        c1 = int(cols_with[right - s])
        if c0 > 0:
            new_intervals.append(iv.column_slice(0, c0))
        mid = iv.column_slice(c0, c1 + 1)
        mid.starts[1] = -left
        new_intervals.append(mid)
        if c1 + 1 < iv.n_cols:
            new_intervals.append(iv.column_slice(c1 + 1, iv.n_cols))
    if not handled:
        raise ValueError("inversion range not covered by a forward truth piece")
    out = IntervalList(genomes=[truth.genomes[0], g2], intervals=new_intervals)
    return g2, out


def enterobacteria_set(
    size: int, k: int, max_rate: float = 0.08, seed: int = 37
) -> Tuple[List[Genome], List[IntervalList]]:
    """An ancestor and k-1 derived genomes at enterobacteria-like divergence
    (per-branch substitution rates 3%..max_rate, indels at a tenth of that);
    every second derived genome carries one or two large inversions.
    Returns (genomes, truths), truths[i] aligning genomes[0] with
    genomes[i + 1]."""
    rng = np.random.default_rng(seed)
    anc = random_genome(rng, size, name="anc")
    genomes, truths = [anc], []
    # pairwise divergence between two derived genomes ~ sum of branch rates
    rates = np.linspace(0.03, max_rate, k - 1)
    for i, s in enumerate(rates):
        d, t = evolve(
            anc, rng, sub_rate=float(s), ins_rate=float(s) / 10,
            del_rate=float(s) / 10, name=f"d{i}",
        )
        if i % 2 == 1:
            for _ in range(1 + (i % 3 == 1)):
                # redraw until the range sits inside one forward truth piece
                # (a second inversion must not overlap the first)
                for _attempt in range(20):
                    span = int(rng.integers(size // 80, size // 10))
                    lo = int(rng.integers(1000, len(d) - span - 1000))
                    try:
                        d, t = apply_inversion_with_truth(d, t, lo, lo + span)
                        break
                    except ValueError:
                        continue
        genomes.append(d)
        truths.append(t)
    return genomes, truths
