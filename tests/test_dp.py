import numpy as np
import pytest

from mauvealigner_tpu.genome.sequence import encode_ascii
from mauvealigner_tpu.ops import dp


def ref_gotoh(a, b, subst, go, ge):
    """Reference numpy Gotoh (global, affine: gap of k costs go + k*ge)."""
    M, N = len(a), len(b)
    NEG = -1e9
    H = np.full((M + 1, N + 1), NEG)
    E = np.full((M + 1, N + 1), NEG)
    F = np.full((M + 1, N + 1), NEG)
    H[0, 0] = 0
    for j in range(1, N + 1):
        E[0, j] = max(H[0, j - 1] + go + ge, E[0, j - 1] + ge)
        H[0, j] = E[0, j]
    for i in range(1, M + 1):
        F[i, 0] = max(H[i - 1, 0] + go + ge, F[i - 1, 0] + ge)
        H[i, 0] = F[i, 0]
        for j in range(1, N + 1):
            E[i, j] = max(H[i, j - 1] + go + ge, E[i, j - 1] + ge)
            F[i, j] = max(H[i - 1, j] + go + ge, F[i - 1, j] + ge)
            H[i, j] = max(H[i - 1, j - 1] + subst[a[i - 1], b[j - 1]], E[i, j], F[i, j])
    return H[M, N]


def enc(s):
    return encode_ascii(np.frombuffer(s.encode(), np.uint8)).astype(np.int64)


def ops_valid(ops, la, lb):
    ca = np.sum((ops == dp.OP_DIAG) | (ops == dp.OP_UP))
    cb = np.sum((ops == dp.OP_DIAG) | (ops == dp.OP_LEFT))
    return ca == la and cb == lb


def score_of_ops(ops, a, b, subst, go, ge):
    """Score an op path (affine: each gap run costs go + len*ge)."""
    i = j = 0
    score = 0.0
    prev = None
    for op in ops:
        if op == dp.OP_DIAG:
            score += subst[a[i], b[j]]
            i += 1
            j += 1
        else:
            if op != prev:
                score += go
            score += ge
            if op == dp.OP_UP:
                i += 1
            else:
                j += 1
        prev = op if op != dp.OP_DIAG else None
    return score


CASES = [
    ("ACGTACGT", "ACGTACGT"),
    ("ACGTACGTAC", "ACGTCGTAC"),     # deletion
    ("AAAA", "TTTT"),                 # all mismatch
    ("ACGT", "ACGTAAAA"),             # long tail gap
    ("A", "T"),
    ("ACACACACAC", "GTGTGTGTGT"),
]


@pytest.mark.parametrize("sa,sb", CASES)
def test_gotoh_score_matches_reference(sa, sb):
    a, b = enc(sa), enc(sb)
    subst = dp.HOXD70
    go, ge = -400.0, -30.0
    pa = dp.one_hot_profile(a, 16)[None]
    pb = dp.one_hot_profile(b, 16)[None]
    ops_list, scores = dp.align_profiles_batch(
        pa, pb, np.array([len(a)]), np.array([len(b)]), subst, go, ge
    )
    expected = ref_gotoh(a, b, subst, go, ge)
    assert scores[0] == pytest.approx(expected, abs=1e-3)
    ops = ops_list[0]
    assert ops_valid(ops, len(a), len(b))
    # the traced path achieves the optimal score
    assert score_of_ops(ops, a, b, subst, go, ge) == pytest.approx(expected, abs=1e-3)


def test_random_pairs_match_reference(rng):
    subst = dp.HOXD70
    go, ge = -400.0, -30.0
    for _ in range(10):
        la, lb = rng.integers(1, 30, size=2)
        a = rng.integers(0, 4, size=la)
        b = rng.integers(0, 4, size=lb)
        pa = dp.one_hot_profile(a, 32)[None]
        pb = dp.one_hot_profile(b, 32)[None]
        ops_list, scores = dp.align_profiles_batch(
            pa, pb, np.array([la]), np.array([lb]), subst, go, ge
        )
        expected = ref_gotoh(a, b, subst, go, ge)
        assert scores[0] == pytest.approx(expected, abs=1e-2)
        assert ops_valid(ops_list[0], la, lb)
        assert score_of_ops(ops_list[0], a, b, subst, go, ge) == pytest.approx(
            expected, abs=1e-2
        )


def test_align_sequence_pairs_bucketing(rng):
    pairs = []
    for _ in range(7):
        la, lb = rng.integers(1, 100, size=2)
        pairs.append((rng.integers(0, 4, size=la), rng.integers(0, 4, size=lb)))
    pairs.append((np.zeros(0, np.int64), rng.integers(0, 4, size=5)))
    results = dp.align_sequence_pairs(pairs)
    for ops, (a, b) in zip(results, pairs):
        assert ops_valid(ops, len(a), len(b))


def test_identical_sequences_all_diag():
    a = enc("ACGTACGTACGTAAA")
    results = dp.align_sequence_pairs([(a, a)])
    assert (results[0] == dp.OP_DIAG).all()


def test_large_batch_traceback_validity(rng):
    """The scan-based traceback must emit exactly la+lb-consuming op
    strings for every lane at large batch sizes."""
    B, M = 1024, 16
    ca = np.full((B, M), 255, np.uint8)
    cb = np.full((B, M), 255, np.uint8)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for i in range(B):
        a = rng.integers(0, 4, size=rng.integers(1, M + 1))
        b = rng.integers(0, 4, size=rng.integers(1, M + 1))
        ca[i, : len(a)] = a
        cb[i, : len(b)] = b
        la[i], lb[i] = len(a), len(b)
    ops, _ = dp.align_code_pairs_batch(ca, cb, la, lb)
    for i in range(B):
        o = ops[i]
        assert int(((o == 1) | (o == 2)).sum()) == la[i]
        assert int(((o == 1) | (o == 3)).sum()) == lb[i]
        assert not (o == 0).any()


def test_ops_to_gap_rows():
    ops = np.array([dp.OP_DIAG, dp.OP_UP, dp.OP_LEFT, dp.OP_DIAG], np.uint8)
    ra, rb = dp.ops_to_gap_rows(ops)
    assert ra.tolist() == [True, True, False, True]
    assert rb.tolist() == [True, False, True, True]


def test_closure_bucket_above_table():
    """--max-gapped-aligner-length above the largest static bucket must keep
    working (powers of two past the table), not crash with a broadcast
    error downstream."""
    from mauvealigner_tpu.models.closure import PROFILE_BUCKETS, _bucket_of

    assert _bucket_of(4096) == 4096
    assert _bucket_of(5000) == 8192
    assert _bucket_of(9000) == 16384
    assert _bucket_of(3) == PROFILE_BUCKETS[0]


def test_normalized_scores_are_one_rounding():
    """normalize=True divides the exact integer count score once: on the
    CPU, S is the correctly rounded quotient."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    pa = rng.integers(0, 4, (2, 12, 5)).astype(np.float32)
    pb = rng.integers(0, 4, (2, 9, 5)).astype(np.float32)
    pa[0, 3] = 0  # an empty column divides by 1
    S = np.asarray(dp._score_matrix(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(dp.HOXD70), True))
    raw = np.einsum("bik,kl,bjl->bij", pa.astype(np.float64), dp.HOXD70, pb)
    den = np.maximum(pa.sum(-1), 1)[:, :, None] * np.maximum(pb.sum(-1), 1)[:, None, :]
    np.testing.assert_array_equal(S, raw.astype(np.float32) / den.astype(np.float32))


def test_count_scores_exact_at_largest_counts():
    """Full-precision einsum: uint8 count profiles at 255 per base score
    exactly (every product and partial sum is an integer below 2^24)."""
    import jax.numpy as jnp

    pa = np.full((1, 3, 5), 255, np.float32)
    pb = np.full((1, 2, 5), 255, np.float32)
    S = np.asarray(dp._score_matrix(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(dp.HOXD70)))
    assert (S == 255.0 * 255.0 * dp.HOXD70.sum()).all()


@pytest.mark.parametrize("side", [16, 256, 4096])
def test_closure_bucket_batch_fits_budget(side):
    from mauvealigner_tpu.models.closure import bucket_batch

    B = bucket_batch(side)
    assert 1 <= B <= 4096
    per_elt = (2 * side + 1) * (side + 1) + 12 * side * side
    assert B == 4096 or B * per_elt <= (3 << 29) < (B + 1) * per_elt
