"""Property tests for the SURVEY §4 invariants: MUM maximality, unique-mode
uniqueness, HMM posterior normalization, LCB-weight monotonicity."""

import numpy as np
import pytest

from mauvealigner_tpu.core.match import NO_MATCH
from mauvealigner_tpu.core.sml import build_sml
from mauvealigner_tpu.genome.sequence import Genome
from mauvealigner_tpu.models.lcb import (
    compute_lcb_boundaries,
    greedy_breakpoint_elimination,
)
from mauvealigner_tpu.ops import matchops
from mauvealigner_tpu.seeds import get_seed
from mauvealigner_tpu.utils import simulate


def _evolved_genomes(rng, n=3, size=6000, sub=0.02):
    anc = simulate.random_genome(rng, size)
    out = []
    for i in range(n):
        der, _ = simulate.evolve(anc, rng, sub_rate=sub, ins_rate=0.001, del_rate=0.001)
        out.append(Genome(der.seq, name=f"g{i}"))
    return out


def test_mum_maximality(rng):
    """No reported multi-MUM can be extended by one base on either side with
    every present genome still agreeing (base-level maximality)."""
    genomes = _evolved_genomes(rng, n=3)
    seed = get_seed(11, 0)
    smls = [build_sml(g, seed) for g in genomes]
    ml = matchops.find_multi_mums(genomes, smls, min_multi=2)
    assert len(ml) > 0

    def col(g, start, length, offset):
        """Base at `offset` columns beyond the match in match space
        (offset < 0 = before column 0); 255 = out of bounds."""
        s = int(start)
        fwd = s > 0
        left0 = abs(s) - 1
        idx = left0 + offset if fwd else left0 + length - 1 - offset
        if idx < 0 or idx >= len(g):
            return 255
        v = int(g.codes[idx])
        if not fwd and v < 4:
            v = 3 - v
        return v

    for i in range(len(ml)):
        starts = ml.starts[i]
        length = int(ml.lengths[i])
        present = np.nonzero(starts != NO_MATCH)[0]
        for offset in (-1, length):
            vals = [
                col(genomes[j], starts[j], length, offset) for j in present
            ]
            # maximality: some genome out of bounds, ambiguous, or mismatch
            ok = all(v < 4 for v in vals) and len(set(vals)) == 1
            assert not ok, (i, offset, starts, length, vals)


def test_unique_mode_seeds_unique_per_genome(rng):
    """Every match reported by the unique finder anchors on a seed window
    whose masked mer occurs exactly once in each participating genome."""
    # plant an exact duplication inside genome 0: its seeds are non-unique
    anc = simulate.random_genome(rng, 4000)
    dup = np.concatenate([anc.seq, anc.seq[1000:1500], anc.seq[3500:]])
    g0 = Genome(dup, name="g0")
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0, del_rate=0.0)
    g1 = Genome(der.seq, name="g1")
    seed = get_seed(11, 0)
    smls = [build_sml(g, seed) for g in (g0, g1)]
    ml = matchops.find_multi_mums([g0, g1], smls, min_multi=2)
    assert len(ml) > 0
    # the duplicated block [1000,1500) of g0 must not anchor any match at
    # full length: its interior seeds occur twice in g0
    for i in range(len(ml)):
        s0 = int(ml.starts[i][0])
        if s0 == NO_MATCH:
            continue
        l, r = abs(s0), abs(s0) + int(ml.lengths[i]) - 1
        inner_l, inner_r = 1001 + seed.length, 1500 - seed.length
        assert not (l <= inner_l and r >= inner_r), (
            "match spans the duplicated block; its seeds are not unique",
            l, r, int(ml.lengths[i]),
        )


def test_hmm_posteriors_sum_to_one(rng):
    import jax.numpy as jnp

    from mauvealigner_tpu.ops import hmm

    B, T = 4, 37
    raw = rng.random((B, T, 2)) * 0.9 + 0.05
    log_emit = np.log(raw / raw.sum(axis=2, keepdims=True))
    log_trans = np.log(np.array([[0.99, 0.01], [0.02, 0.98]]))
    log_init = np.log(np.array([0.3, 0.7]))
    lengths = np.array([T, T - 5, 1, T - 1], np.int32)
    post = np.asarray(
        hmm.forward_backward(
            jnp.asarray(log_emit),
            jnp.asarray(log_trans),
            jnp.asarray(log_init),
            jnp.asarray(lengths),
        )
    )
    for b, L in enumerate(lengths):
        sums = post[b, :L].sum(axis=1)
        np.testing.assert_allclose(sums, 1.0, atol=1e-4)


def test_lcb_count_monotone_in_min_weight(rng):
    """Raising the minimum LCB weight never increases the number of
    surviving LCBs, and total surviving weight is non-increasing."""
    genomes = _evolved_genomes(rng, n=2, size=8000)
    # shuffle genome 1 into 4 rearranged segments (one inverted)
    c = genomes[1].codes.copy()
    seg = len(c) // 4
    parts = [c[2 * seg : 3 * seg], c[:seg], (3 - c[seg : 2 * seg])[::-1], c[3 * seg :]]
    genomes[1] = Genome.from_codes(np.concatenate(parts), name="g1r")
    seed = get_seed(11, 0)
    smls = [build_sml(g, seed) for g in genomes]
    ml = matchops.find_multi_mums(genomes, smls, min_multi=2)
    assert len(ml) >= 4
    prev_n = None
    prev_total = None
    for min_w in (0, 50, 200, 800, 3200):
        kept, lcbs = greedy_breakpoint_elimination(ml, float(min_w))
        n = len(lcbs)
        total = sum(l.weight for l in lcbs)
        if prev_n is not None:
            assert n <= prev_n, (min_w, n, prev_n)
            assert total <= prev_total + 1e-9, (min_w, total, prev_total)
        for l in lcbs:
            assert l.weight >= min_w or min_w == 0
        prev_n, prev_total = n, total


def _ref_merge_coordinate_rows(rows):
    """Brute-force reference of the pre-vectorization merge_coordinate_rows."""
    if not rows:
        return rows
    rows = sorted(
        rows,
        key=lambda r: (tuple(r[::2] == 0), abs(int(r[0])), abs(int(r[2] if len(r) > 2 else 0))),
    )
    out = [rows[0].copy()]
    for r in rows[1:]:
        prev = out[-1]
        members_prev = prev[::2] != 0
        members_r = r[::2] != 0
        if np.array_equal(members_prev, members_r) and all(
            abs(int(r[2 * s])) == abs(int(prev[2 * s + 1])) + 1
            and np.sign(r[2 * s]) == np.sign(prev[2 * s])
            for s in np.nonzero(members_r)[0]
        ):
            for s in np.nonzero(members_r)[0]:
                prev[2 * s + 1] = r[2 * s + 1]
        else:
            out.append(r.copy())
    return out


def test_merge_coordinate_rows_matches_reference(rng):
    """The vectorized pairwise-joinable merge must reproduce the sequential
    chain merge on random coordinate rows (including adjacency chains,
    strand flips, and membership changes)."""
    from mauvealigner_tpu.analysis.backbone import merge_coordinate_rows

    for trial in range(20):
        n = int(rng.integers(2, 5))
        rows = []
        cursors = rng.integers(1, 50, size=n)
        for _ in range(int(rng.integers(1, 40))):
            row = np.zeros(2 * n, np.int64)
            for s in range(n):
                if rng.random() < 0.3:
                    continue
                length = int(rng.integers(1, 20))
                left = int(cursors[s])
                sign = -1 if rng.random() < 0.3 else 1
                row[2 * s] = sign * left
                row[2 * s + 1] = sign * (left + length - 1)
                # half the time leave the cursor adjacent (mergeable), half
                # the time jump (not mergeable)
                cursors[s] = left + length + (0 if rng.random() < 0.5 else int(rng.integers(1, 10)))
            if (row[::2] != 0).any():
                rows.append(row)
        if not rows:
            continue
        got = merge_coordinate_rows([r.copy() for r in rows])
        want = _ref_merge_coordinate_rows([r.copy() for r in rows])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a, b), (a, b)


def test_backbone_seq_coordinates_matches_reference(rng):
    """The scan-based segment coordinate extraction must agree with the
    direct per-segment slice/min/max computation, including out-of-range
    column windows (python-slice clamping semantics)."""
    from mauvealigner_tpu.analysis.backbone import (
        BackboneColumnSegment,
        backbone_seq_coordinates,
    )
    from mauvealigner_tpu.analysis.score_alignment import _interval_positions
    from mauvealigner_tpu.core.interval import Interval, IntervalList

    genomes = _evolved_genomes(rng, n=4, size=2000)
    from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner

    res = MauveAligner(AlignerOptions(seed_size=9, use_sml_cache=False)).align(genomes)
    ivl = res.interval_list
    segs = []
    for k, iv in enumerate(ivl.intervals):
        for _ in range(6):
            a = int(rng.integers(0, max(iv.n_cols, 1)))
            b = int(rng.integers(a, iv.n_cols + 5))  # may exceed n_cols
            seqs = [s for s in range(iv.n_seqs) if rng.random() < 0.7]
            segs.append(BackboneColumnSegment(k, a, b, seqs))
    rows = backbone_seq_coordinates(ivl, segs)
    for seg, row in zip(segs, rows):
        iv = ivl.intervals[seg.interval_index]
        want = np.zeros(2 * ivl.n_seqs, np.int64)
        for s in seg.seqs:
            p = _interval_positions(iv, s)[seg.col_start : seg.col_end]
            p = p[p != 0]
            if len(p) == 0:
                continue
            sign = int(np.sign(p[0]))
            want[2 * s] = sign * int(np.abs(p).min())
            want[2 * s + 1] = sign * int(np.abs(p).max())
        assert np.array_equal(row, want), (seg, row, want)


def test_bucketed_decode_symbol_mode_matches_float_mode(rng):
    """The int8 symbol-stream interface (device emission lookup) must return
    exactly what the float32 emission-row interface returns, in every mode."""
    from mauvealigner_tpu.ops import hmm

    emit = np.log(np.array([[0.6, 0.2, 0.1, 0.1], [0.25, 0.25, 0.25, 0.25]]))
    log_trans = np.log(np.array([[0.99, 0.01], [0.02, 0.98]]))
    log_init = np.log(np.array([0.5, 0.5]))
    streams = [
        rng.integers(0, 4, size=int(rng.integers(1, 200))).astype(np.int8)
        for _ in range(23)
    ] + [np.zeros(0, np.int8)]
    float_rows = [emit[:, s].T.astype(np.float32) for s in streams]
    for mode in ("posterior0", "threshold0", "prefix0"):
        want = hmm.bucketed_decode(float_rows, log_trans, log_init, mode=mode, threshold=0.55)
        got = hmm.bucketed_decode(
            streams, log_trans, log_init, mode=mode, threshold=0.55, emit_table=emit
        )
        for w, g in zip(want, got):
            if mode == "prefix0":
                assert w == g
            elif mode == "threshold0":
                assert np.array_equal(w, g)
            else:
                np.testing.assert_allclose(w, g, rtol=1e-6, atol=1e-7)


def test_match_and_gap_scores_batch_matches_single(rng):
    """The grouped/padded batch SP scorer must equal per-matrix calls
    bit-for-bit (integer substitution scores keep every sum exact)."""
    from mauvealigner_tpu.analysis.sp import (
        match_and_gap_scores,
        match_and_gap_scores_batch,
    )

    mats = []
    for _ in range(40):
        k = int(rng.integers(1, 7))
        T = int(rng.integers(0, 90))
        X = rng.integers(0, 6, size=(k, T)).astype(np.int8)
        mats.append(X)
    mb, gb = match_and_gap_scores_batch(mats, gap_open=-100.0, gap_extend=-20.0)
    for X, m, g in zip(mats, mb, gb):
        m1, g1 = match_and_gap_scores(X, gap_open=-100.0, gap_extend=-20.0)
        assert m == m1, (X.shape, m, m1)
        assert g == g1, (X.shape, g, g1)


def test_forward_backward_matches_logspace_reference(rng):
    """The normalized probability-space scan must reproduce a straight
    log-space forward/backward to float accuracy (random chains, padding)."""
    import jax.numpy as jnp

    from mauvealigner_tpu.ops import hmm

    def ref_posteriors(log_emit, log_trans, log_init, L):
        from scipy.special import logsumexp

        T, S = log_emit.shape
        la = np.full((L, S), -np.inf)
        la[0] = log_init + log_emit[0]
        for t in range(1, L):
            la[t] = logsumexp(la[t - 1][:, None] + log_trans, axis=0) + log_emit[t]
        lb = np.zeros((L, S))
        for t in range(L - 2, -1, -1):
            lb[t] = logsumexp(log_trans + log_emit[t + 1] + lb[t + 1], axis=1)
        lp = la + lb
        lp -= logsumexp(lp, axis=1, keepdims=True)
        return np.exp(lp)

    B, T, S = 3, 29, 2
    raw = rng.random((B, T, S)) * 0.95 + 0.02
    log_emit = np.log(raw / raw.sum(axis=2, keepdims=True)).astype(np.float32)
    log_trans = np.log(np.array([[0.999, 0.001], [0.01, 0.99]])).astype(np.float32)
    log_init = np.log(np.array([0.6, 0.4])).astype(np.float32)
    lengths = np.array([T, T - 7, 2], np.int32)
    post = np.asarray(
        hmm.forward_backward(
            jnp.asarray(log_emit), jnp.asarray(log_trans),
            jnp.asarray(log_init), jnp.asarray(lengths),
        )
    )
    for b, L in enumerate(lengths):
        want = ref_posteriors(log_emit[b], log_trans, log_init, int(L))
        np.testing.assert_allclose(post[b, :L], want, atol=2e-4)


def test_forward_backward_2state_lane_kernel_matches_generic(rng):
    """The S=2 lane-decomposed kernel (four [B, T] lanes instead of
    scanning [B, T, 2, 2] tensors) must agree with the generic matrix
    formulation bit-for-float."""
    import jax.numpy as jnp

    from mauvealigner_tpu.ops import hmm

    B, T = 4, 517
    raw = rng.random((B, T, 2)) * 0.95 + 0.02
    log_emit = np.log(raw / raw.sum(axis=2, keepdims=True)).astype(np.float32)
    log_trans = np.log(np.array([[1 - 1e-9, 1e-9], [1e-5, 1 - 1e-5]])).astype(
        np.float32
    )
    log_init = np.log(np.array([0.5, 0.5])).astype(np.float32)
    lengths = np.array([T, T - 100, 16, 1], np.int32)
    args = (
        jnp.asarray(log_emit), jnp.asarray(log_trans),
        jnp.asarray(log_init), jnp.asarray(lengths),
    )
    lane = np.asarray(hmm._forward_backward_2state(*args))

    # generic matrix path, forced by bypassing the S==2 dispatch
    le = jnp.where(
        (jnp.arange(T)[None, :] < jnp.asarray(lengths)[:, None])[:, :, None],
        jnp.asarray(log_emit), 0.0,
    )
    emit = jnp.exp(le)
    A = jnp.exp(jnp.asarray(log_trans))[None, None] * emit[:, :, None, :]
    import jax

    prefix = jax.lax.associative_scan(hmm._norm_matmul, A[:, 1:], axis=1)
    alpha0_raw = jnp.exp(jnp.asarray(log_init)) * emit[:, 0]
    alpha0 = alpha0_raw / jnp.maximum(
        jnp.max(alpha0_raw, axis=-1, keepdims=True), jnp.float32(1e-30)
    )
    alphas = jnp.concatenate(
        [alpha0[:, None], jnp.einsum("bok,btkj->btj", alpha0[:, None], prefix)],
        axis=1,
    )
    suffix_T = jax.lax.associative_scan(
        hmm._norm_matmul, jnp.swapaxes(A[:, 1:], -1, -2), axis=1, reverse=True
    )
    betas = jnp.concatenate(
        [jnp.sum(suffix_T, axis=-2), jnp.ones((B, 1, 2))], axis=1
    )
    raw_p = alphas * betas
    want = np.asarray(raw_p / jnp.maximum(raw_p.sum(2, keepdims=True), 1e-30))
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(lane[b, :L], want[b, :L], atol=1e-5)
