"""Alignment accuracy scoring against a known-correct alignment.

Reimplementation of the reference's scoreAlignment tool
(src/scoreAlignment.cpp:99-477), the dominant QA mechanism (SURVEY.md §4):
every aligned base pair of the correct alignment is classified TP/FN against
the calculated alignment, and every calculated pair not present in the
correct alignment is an FP; sensitivity = TP/(TP+FN), PPV = TP/(TP+FP).

Redesign: instead of the reference's per-column triple loop, each alignment
is converted into per-pair position maps (vectorized cumulative-sum ranks),
and classification is an elementwise comparison.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mauvealigner_tpu.core.interval import IntervalList


def _interval_positions(iv, seq: int) -> np.ndarray:
    """Signed 1-based genome position per alignment column (0 where gap)."""
    row = iv.aln[seq]
    s = int(iv.starts[seq])
    pos = np.zeros(iv.n_cols, np.int64)
    if s == 0 or not row.any():
        return pos
    rank = np.cumsum(row)
    length = int(rank[-1])
    left = abs(s)
    if s > 0:
        vals = left + rank - 1
    else:
        vals = -(left + length - rank)
    pos[row] = vals[row]
    return pos


def pair_position_maps(
    ivs: IntervalList,
    seq_lengths: Sequence[int],
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
) -> Dict[Tuple[int, int], np.ndarray]:
    """For each ordered pair (i<j): array of signed positions in j indexed by
    1-based position in i (0 = unaligned).  Sign encodes relative strand.

    `pairs` restricts the computation (and the column-position extraction)
    to the listed (i, j) pairs — scoring k derived genomes against one
    ancestor needs k maps, not all n*(n-1)/2."""
    n = ivs.n_seqs
    wanted = (
        {(i, j) for i in range(n) for j in range(i + 1, n)}
        if pairs is None
        else {(min(i, j), max(i, j)) for i, j in pairs}
    )
    need_seq = {s for p in wanted for s in p}
    maps = {
        (i, j): np.zeros(seq_lengths[i] + 1, np.int64) for (i, j) in wanted
    }
    for iv in ivs.intervals:
        pres = [iv.starts[s] != 0 for s in range(iv.n_seqs)]
        pos_cache = {}
        for i in range(iv.n_seqs):
            if pres[i] and i in need_seq:
                pos_cache[i] = _interval_positions(iv, i)
        for i in range(iv.n_seqs):
            if not pres[i]:
                continue
            for j in range(i + 1, iv.n_seqs):
                if (i, j) not in wanted or not pres[j]:
                    continue
                pi, pj = pos_cache[i], pos_cache[j]
                both = (pi != 0) & (pj != 0)
                keys = np.abs(pi[both])
                # signed value: positive when both on same strand
                vals = np.where(np.sign(pi[both]) == np.sign(pj[both]), 1, -1) * np.abs(
                    pj[both]
                )
                maps[(i, j)][keys] = vals
    return maps


@dataclasses.dataclass
class PairScore:
    tp: int
    fn: int
    fp: int

    @property
    def sensitivity(self) -> float:
        d = self.tp + self.fn
        return self.tp / d if d else 1.0

    @property
    def ppv(self) -> float:
        d = self.tp + self.fp
        return self.tp / d if d else 1.0


@dataclasses.dataclass
class AlignmentScore:
    pairs: Dict[Tuple[int, int], PairScore]

    @property
    def sensitivity(self) -> float:
        tp = sum(p.tp for p in self.pairs.values())
        fn = sum(p.fn for p in self.pairs.values())
        return tp / (tp + fn) if tp + fn else 1.0

    @property
    def ppv(self) -> float:
        tp = sum(p.tp for p in self.pairs.values())
        fp = sum(p.fp for p in self.pairs.values())
        return tp / (tp + fp) if tp + fp else 1.0

    def summary(self) -> str:
        return (
            f"Sensitivity: {self.sensitivity:.6f}\n"
            f"PPV: {self.ppv:.6f}\n"
            + "".join(
                f"pair {i},{j}: sn={p.sensitivity:.4f} ppv={p.ppv:.4f} "
                f"(tp={p.tp} fn={p.fn} fp={p.fp})\n"
                for (i, j), p in sorted(self.pairs.items())
            )
        )


def score_against_truths(
    ivs: IntervalList,
    seq_lengths: Sequence[int],
    truths: Sequence[IntervalList],
) -> AlignmentScore:
    """Score every (0, i) projection of `ivs` against truths[i - 1], the
    simulator's known alignment of genome 0 with genome i
    (utils/simulate.enterobacteria_set).  One pass over `ivs` extracts all
    (0, i) maps at once."""
    amaps = pair_position_maps(
        ivs, seq_lengths, pairs=[(0, i) for i in range(1, len(truths) + 1)]
    )
    pairs = {}
    for i, truth in enumerate(truths, start=1):
        cm = pair_position_maps(truth, [seq_lengths[0], seq_lengths[i]])[(0, 1)]
        a = amaps[(0, i)]
        tmask = cm != 0
        tp = int(np.sum(tmask & (a == cm)))
        fp = int(np.sum((a != 0) & (a != cm)))
        pairs[(0, i)] = PairScore(tp=tp, fn=int(tmask.sum()) - tp, fp=fp)
    return AlignmentScore(pairs)


def coverage_maps(
    ivs: IntervalList, seq_lengths: Sequence[int]
) -> Dict[int, np.ndarray]:
    """Per sequence: bool[len+1], True where the 1-based position appears in
    any interval (aligned to anything, including gaps)."""
    n = ivs.n_seqs
    cov = {s: np.zeros(seq_lengths[s] + 1, bool) for s in range(n)}
    for iv in ivs.intervals:
        for s in range(iv.n_seqs):
            if iv.starts[s] == 0:
                continue
            p = _interval_positions(iv, s)
            nz = np.abs(p[p != 0])
            cov[s][nz] = True
    return cov


@dataclasses.dataclass
class ReferenceCounters:
    """Counters with the reference binary's exact labeling quirks
    (src/scoreAlignment.cpp:172-182, 320-360, 424-441, 450-457):

    - TP: calculated pairs the same base (strand-consistently).
    - FN: calculated aligns the base where correct has a gap
      (over-alignment, :428-429), OR the base sits in no calculated
      interval while correct pairs it (unaligned_fn, :352-355).
    - FP: calculated pairs a different base (:430), or calculated aligns
      to a gap where correct pairs a base (:433-437).
    - TN: gap against gap (:435, :356-359).

    Counts are over ORDERED sequence pairs, as the reference's seqI/seqJ
    double loop tallies each unordered pair twice."""

    tp: int = 0
    tn: int = 0
    fp: int = 0
    fn: int = 0
    unaligned_fn: int = 0
    unaligned_tn: int = 0
    total: int = 0

    def summary(self) -> str:
        def r(a, b):
            return a / b if b else 0.0

        return (
            f"Sensitivity: TP / TP + FN = {r(self.tp, self.tp + self.fn):.6g}\n"
            f"Specificity: TN / TN + FP = {r(self.tn, self.tn + self.fp):.6g}\n"
            f"TP + TN / total = {r(self.tp + self.tn, self.total):.6g}\n"
            f"FP + FN / total = {r(self.fp + self.fn, self.total):.6g}\n"
            f"unaligned error = {r(self.unaligned_fn, self.total):.6g}\n"
        )


def reference_counters(
    correct: IntervalList, calculated: IntervalList, seq_lengths: Sequence[int]
) -> ReferenceCounters:
    """Classify every (ordered pair, base) event with the reference's
    conventions (see ReferenceCounters).  Equivalent to the reference's
    per-column triple loop, computed from position maps."""
    cmaps = pair_position_maps(correct, seq_lengths)
    amaps = pair_position_maps(calculated, seq_lengths)
    ccov = coverage_maps(correct, seq_lengths)
    acov = coverage_maps(calculated, seq_lengths)
    rc = ReferenceCounters()

    def tally(posmap_c, posmap_a, cov_cor_i, cov_cal_i):
        # walk base positions of seqI present in the correct alignment
        walk = cov_cor_i.copy()
        walk[0] = False
        c = posmap_c[walk]
        a = posmap_a[walk]
        covered = cov_cal_i[walk]
        tp = int(np.sum(covered & (a != 0) & (a == c)))
        fn_over = int(np.sum(covered & (a != 0) & (c == 0)))
        fp_mis = int(np.sum(covered & (a != 0) & (c != 0) & (a != c)))
        fp_gap = int(np.sum(covered & (a == 0) & (c != 0)))
        tn_gap = int(np.sum(covered & (a == 0) & (c == 0)))
        un_fn = int(np.sum(~covered & (c != 0)))
        un_tn = int(np.sum(~covered & (c == 0)))
        rc.tp += tp
        rc.fn += fn_over + un_fn
        rc.fp += fp_mis + fp_gap
        rc.tn += tn_gap + un_tn
        rc.unaligned_fn += un_fn
        rc.unaligned_tn += un_tn
        rc.total += int(walk.sum())

    for (i, j), c_ij in cmaps.items():
        a_ij = amaps.get((i, j), np.zeros_like(c_ij))
        # direction (i -> j)
        tally(c_ij, a_ij, ccov[i], acov[i])
        # direction (j -> i): invert the maps
        c_ji = _invert_map(c_ij, seq_lengths[j])
        a_ji = _invert_map(a_ij, seq_lengths[j])
        tally(c_ji, a_ji, ccov[j], acov[j])
    return rc


def _invert_map(m: np.ndarray, len_j: int) -> np.ndarray:
    """positions-in-j -> signed positions-in-i from an i -> j map."""
    out = np.zeros(len_j + 1, np.int64)
    idx = np.nonzero(m)[0]
    vals = m[idx]
    out[np.abs(vals)] = np.sign(vals) * idx
    return out


def score_alignment(
    correct: IntervalList, calculated: IntervalList, seq_lengths: Sequence[int]
) -> AlignmentScore:
    cmaps = pair_position_maps(correct, seq_lengths)
    amaps = pair_position_maps(calculated, seq_lengths)
    pairs = {}
    for key in cmaps:
        c = cmaps[key]
        a = amaps.get(key, np.zeros_like(c))
        truth = c != 0
        pred = a != 0
        tp = int(np.sum(truth & (a == c)))
        fn = int(np.sum(truth) - tp)
        fp = int(np.sum(pred & (a != c)))
        pairs[key] = PairScore(tp, fn, fp)
    return AlignmentScore(pairs)
