"""K3: batched affine-gap DP (Gotoh) with device traceback.

Replaces the libMUSCLE subprocess the reference forks per inter-anchor
region (MuscleInterface::Align / CallMuscleFast, call sites
src/MatchRecord.h:311, src/repeatoire.cpp:1262, src/mauveAligner.cpp:82-83).
No subprocess: regions are bucketed by length, batched, and aligned on device.

Design notes:
  * Sequences enter as *profiles* (one-hot for plain sequences, column counts
    for profile-profile alignment in the progressive aligner), so the per-cell
    substitution score matrix S[b,i,j] = pA[b,i,:] @ SUBST @ pB[b,j,:]^T is a
    single batched einsum.
  * The Gotoh recurrence runs as a `lax.scan` over anti-diagonals with the
    whole diagonal as a vector (wavefront), storing 4 decision bits per
    cell.
  * Traceback is a fixed-trip `lax.scan` on device emitting an op string
    (1=diag, 2=up/consume-A, 3=left/consume-B).

Gap model: a gap of length k costs gap_open + k*gap_extend (both negative).
Tie-breaking is deterministic: diagonal > up > left; gap-open wins ties over
gap-extend.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.float32(-1e9)


OP_NONE, OP_DIAG, OP_UP, OP_LEFT = 0, 1, 2, 3

# HOXD70 substitution scores (Chiaromonte/Yap/Miller 2002), the matrix behind
# the reference's hoxd scoring scheme (PairwiseScoringScheme / hoxd_matrix,
# src/repeatoire.cpp:1994, src/evd.cpp:29-31).  Fifth row/col handles
# ambiguity codes (never a good match).
HOXD70 = np.array(
    [
        [91, -114, -31, -123, -44],
        [-114, 100, -125, -31, -44],
        [-31, -125, 100, -114, -44],
        [-123, -31, -114, 91, -44],
        [-44, -44, -44, -44, -44],
    ],
    dtype=np.float32,
)

DEFAULT_GAP_OPEN = -400.0
DEFAULT_GAP_EXTEND = -30.0


def read_substitution_matrix(path: str) -> np.ndarray:
    """NCBI-format substitution matrix file -> [5, 5] float32.

    Parity with readSubstitutionMatrix / --substitution-matrix
    (src/progressiveMauve.cpp:666-687): '#' comments, a header row of
    residue symbols, then one row per residue.  A/C/G/T columns map to codes
    0-3; every other symbol (N, ambiguity codes, '*') folds into the
    ambiguity row/column 4 as the minimum of the contributing scores.
    """
    order = {"A": 0, "C": 1, "G": 2, "T": 3}
    header: List[str] = []
    out = np.full((5, 5), np.nan, np.float32)
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split()
            if not header:
                header = [f.upper() for f in fields]
                continue
            sym = fields[0].upper()
            scores = [float(x) for x in fields[1 : len(header) + 1]]
            i = order.get(sym, 4)
            for col_sym, val in zip(header, scores):
                j = order.get(col_sym, 4)
                if np.isnan(out[i, j]) or val < out[i, j]:
                    out[i, j] = val
    if np.isnan(out[:4, :4]).any():
        raise ValueError(f"substitution matrix {path!r} is missing A/C/G/T entries")
    # missing ambiguity entries default to the worst ACGT mismatch
    fallback = out[:4, :4].min()
    out = np.where(np.isnan(out), fallback, out)
    return out.astype(np.float32)


def one_hot_profile(codes: np.ndarray, length: int) -> np.ndarray:
    """codes int array -> [length, 5] one-hot profile, zero-padded."""
    out = np.zeros((length, 5), dtype=np.float32)
    n = min(len(codes), length)
    if n:
        out[np.arange(n), np.minimum(codes[:n], 4)] = 1.0
    return out


@partial(jax.jit, static_argnames=("M", "N", "normalize"))
def gotoh_forward_scored(
    pA: jnp.ndarray,  # [B, M, 5] profiles (rows beyond mA are zero)
    pB: jnp.ndarray,  # [B, N, 5]
    lens_a: jnp.ndarray,  # [B] int32
    lens_b: jnp.ndarray,  # [B] int32
    subst: jnp.ndarray,  # [5, 5]
    gap_open: jnp.ndarray,  # scalar f32 (negative)
    gap_extend: jnp.ndarray,  # scalar f32 (negative)
    M: int,
    N: int,
    normalize: bool = False,
):
    """Like gotoh_forward but extracts each element's final score
    H[mA, mB] inside the scan instead of materializing every H row —
    halves device memory, doubling feasible batch sizes.

    normalize=True scores the MEAN pairwise substitution: each cell's
    count-profile score divided by the two columns' count totals
    (profile-aware alignment whose score scale matches code-vs-code, so the
    affine gap penalties keep their meaning).

    Returns (scores [B] f32, dec [B, n_diags, M+1] uint8).
    """
    return _gotoh_core(
        pA, pB, subst, gap_open, gap_extend, M, N, lens_a, lens_b,
        keep_H=False, normalize=normalize,
    )


@partial(jax.jit, static_argnames=("M", "N"))
def gotoh_forward(
    pA: jnp.ndarray,  # [B, M, 5] profiles (rows beyond mA are zero)
    pB: jnp.ndarray,  # [B, N, 5]
    subst: jnp.ndarray,  # [5, 5]
    gap_open: jnp.ndarray,  # scalar f32 (negative)
    gap_extend: jnp.ndarray,  # scalar f32 (negative)
    M: int,
    N: int,
):
    """Returns (H_all [B, n_diags, M+1] f32, dec [B, n_diags, M+1] uint8).

    dec bit layout: bits0-1 H source (0 diag, 1 up/F, 2 left/E),
    bit2 E opened from H, bit3 F opened from H.
    """
    B = pA.shape[0]
    zeros = jnp.zeros(B, jnp.int32)
    return _gotoh_core(
        pA, pB, subst, gap_open, gap_extend, M, N, zeros, zeros, keep_H=True
    )


def _score_matrix(pA, pB, subst, normalize: bool = False):
    """S[b, i, j] = pA[b, i] @ subst @ pB[b, j] in full float32, divided by
    both columns' count totals when normalize.  Dividing the count score
    once, instead of scoring normalized profiles, keeps every intermediate
    an exact integer for integer counts and matrices, so the only rounding
    is the division's (IEEE on the CPU; XLA compiles float32 division to
    div.full.f32, within 2 ulp, on NVIDIA GPUs)."""
    S = jnp.einsum(
        "bik,kl,bjl->bij", pA, subst, pB,
        precision=jax.lax.Precision.HIGHEST, preferred_element_type=jnp.float32,
    )
    if normalize:
        den_a = jnp.maximum(jnp.sum(pA, axis=-1), 1.0)
        den_b = jnp.maximum(jnp.sum(pB, axis=-1), 1.0)
        S = S / (den_a[:, :, None] * den_b[:, None, :])
    return S


@partial(jax.jit, static_argnames=("M", "N", "keep_H", "normalize"))
def _gotoh_core(
    pA: jnp.ndarray,
    pB: jnp.ndarray,
    subst: jnp.ndarray,
    gap_open: jnp.ndarray,
    gap_extend: jnp.ndarray,
    M: int,
    N: int,
    lens_a: jnp.ndarray,
    lens_b: jnp.ndarray,
    keep_H: bool,
    normalize: bool = False,
):
    B = pA.shape[0]
    n_diags = M + N + 1
    # full substitution score matrix, then SHEARED by pad+reshape so each
    # scan step reads its anti-diagonal with one dynamic_slice instead of a
    # gather: Q[b, i, c] = S[b, i, c - i], so anti-diagonal d is column d-2
    # of Q.  Shear wrap-around lands in the zero padding; those cells are
    # outside the reachable DP band.
    S = _score_matrix(pA, pB, subst, normalize)
    W = M + N
    Q = (
        jnp.pad(S, ((0, 0), (0, 0), (0, M)))
        .reshape(B, M * W)[:, : M * (W - 1)]
        .reshape(B, M, W - 1)
    )
    QT = jnp.transpose(Q, (0, 2, 1))  # [B, W-1, M]: row d-2 = diagonal d

    iota = jax.lax.broadcasted_iota(jnp.int32, (1, M + 1), 1)  # [1, M+1]
    go_ge = gap_open + gap_extend

    H0 = jnp.where(iota == 0, 0.0, NEG) * jnp.ones((B, 1), jnp.float32)
    d_final = lens_a + lens_b
    init = (
        H0,                                   # H_prev  (diag d-1)
        jnp.full((B, M + 1), NEG),            # H_prev2 (diag d-2)
        jnp.full((B, M + 1), NEG),            # E_prev
        jnp.full((B, M + 1), NEG),            # F_prev
        jnp.where(d_final == 0, 0.0, NEG).astype(jnp.float32),  # score so far
    )

    def shift_down(x):
        return jnp.concatenate([jnp.full((B, 1), NEG), x[:, :-1]], axis=1)

    def step(carry, d):
        H_prev, H_prev2, E_prev, F_prev, score = carry
        j = d - iota  # [1, M+1] column index per lane

        e_from_h = H_prev + go_ge
        e_from_e = E_prev + gap_extend
        e_open = e_from_h >= e_from_e
        E = jnp.where(j >= 1, jnp.maximum(e_from_h, e_from_e), NEG)

        Hp1 = shift_down(H_prev)
        Fp1 = shift_down(F_prev)
        f_from_h = Hp1 + go_ge
        f_from_f = Fp1 + gap_extend
        f_open = f_from_h >= f_from_f
        F = jnp.where(iota >= 1, jnp.maximum(f_from_h, f_from_f), NEG)

        # diagonal: S[i-1, d-i-1] = QT[d-2, i-1], one slice per step
        row = jax.lax.dynamic_slice_in_dim(
            QT, jnp.clip(d - 2, 0, W - 2), 1, axis=1
        )[:, 0, :]
        Sdiag = jnp.concatenate([jnp.full((B, 1), NEG), row], axis=1)
        # cells outside the valid band read sheared zero-padding instead of
        # NEG; they derive from NEG-initialized state and are unreachable
        # from any (mA, mB) traceback, so decisions at live cells match the
        # masked formulation exactly
        Hd = shift_down(H_prev2) + Sdiag

        stacked = jnp.stack([Hd, F, E], axis=0)          # priority order
        h_choice = jnp.argmax(stacked, axis=0).astype(jnp.uint8)
        H = jnp.max(stacked, axis=0)

        dec = (
            h_choice
            | (e_open.astype(jnp.uint8) << 2)
            | (f_open.astype(jnp.uint8) << 3)
        )
        # capture each element's final cell H[mA, mB] as its diagonal passes
        picked = jnp.take_along_axis(H, lens_a[:, None], axis=1)[:, 0]
        score = jnp.where(d == d_final, picked, score)
        ys = (H, dec) if keep_H else dec
        return (H, H_prev, E, F, score), ys

    ds = jnp.arange(1, n_diags, dtype=jnp.int32)
    carry, ys = jax.lax.scan(step, init, ds)
    dec0 = jnp.zeros((B, 1, M + 1), jnp.uint8)
    if keep_H:
        H_stack, dec_stack = ys
        H_all = jnp.concatenate([H0[:, None, :], jnp.moveaxis(H_stack, 0, 1)], axis=1)
        dec_all = jnp.concatenate([dec0, jnp.moveaxis(dec_stack, 0, 1)], axis=1)
        return H_all, dec_all
    dec_all = jnp.concatenate([dec0, jnp.moveaxis(ys, 0, 1)], axis=1)
    return carry[4], dec_all


@partial(jax.jit, static_argnames=("M", "N"))
def gotoh_traceback(dec: jnp.ndarray, mA: jnp.ndarray, mB: jnp.ndarray, M: int, N: int):
    """dec [B, n_diags, M+1]; mA/mB [B] actual lengths.

    Returns ops [B, M+N] uint8 emitted end-of-alignment-first (reverse on
    host), plus op counts [B].

    Implemented as a fixed-trip lax.scan with masked per-lane emission
    (OP_NONE after a lane finishes).
    """
    B = dec.shape[0]
    L = M + N
    dec_flat = dec.reshape(B, -1)

    def step(state, _):
        i, j, mode = state
        active = (i > 0) | (j > 0)
        idx = jnp.clip((i + j) * (M + 1) + i, 0, dec_flat.shape[1] - 1)
        byte = jnp.take_along_axis(dec_flat, idx[:, None], axis=1)[:, 0]
        h_choice = (byte & 3).astype(jnp.uint8)
        e_open = (byte >> 2) & 1
        f_open = (byte >> 3) & 1
        on_top = i == 0
        on_left = j == 0
        from_h = jnp.where(
            on_top, jnp.uint8(2), jnp.where(on_left, jnp.uint8(1), h_choice)
        )
        c = jnp.where(mode == 0, from_h, mode)
        op = jnp.where(c == 0, OP_DIAG, jnp.where(c == 1, OP_UP, OP_LEFT)).astype(
            jnp.uint8
        )
        op = jnp.where(active, op, jnp.uint8(OP_NONE))
        ni = jnp.where(active & (c != 2), i - 1, i)
        nj = jnp.where(active & (c != 1), j - 1, j)
        nmode = jnp.where(
            c == 0,
            jnp.uint8(0),
            jnp.where(
                c == 1,
                jnp.where(f_open == 1, jnp.uint8(0), jnp.uint8(1)),
                jnp.where(e_open == 1, jnp.uint8(0), jnp.uint8(2)),
            ),
        ).astype(jnp.uint8)
        nmode = jnp.where(active, nmode, mode)
        return (ni, nj, nmode), op

    init = (mA.astype(jnp.int32), mB.astype(jnp.int32), jnp.zeros(B, jnp.uint8))
    _, ops_steps = jax.lax.scan(step, init, None, length=L)
    ops = jnp.moveaxis(ops_steps, 0, 1)  # [B, L]
    counts = jnp.sum((ops != OP_NONE).astype(jnp.int32), axis=1)
    return ops, counts


@partial(jax.jit, static_argnames=("M", "N"))
def gotoh_traceback_packed(
    dec: jnp.ndarray,
    mA: jnp.ndarray,
    mB: jnp.ndarray,
    scores: jnp.ndarray,
    M: int,
    N: int,
):
    """gotoh_traceback with the op string PACKED 2 bits/op on device and
    scores/counts bitcast into the same byte matrix: ONE device->host
    transfer a quarter the op-matrix size returns everything (the ops
    download is the dominant transfer of every DP call)."""
    ops, counts = gotoh_traceback(dec, mA, mB, M, N)
    b = ops.shape[0]
    L = ops.shape[1]
    Lp = -(-L // 4) * 4
    if Lp != L:
        ops = jnp.concatenate(
            [ops, jnp.zeros((b, Lp - L), jnp.uint8)], axis=1
        )
    quads = ops.reshape(b, Lp // 4, 4).astype(jnp.uint8)
    w = (jnp.uint8(1) << (jnp.arange(4, dtype=jnp.uint8) * 2))[None, None, :]
    packed = jnp.sum(quads * w, axis=-1, dtype=jnp.uint8)
    sb = jax.lax.bitcast_convert_type(scores.astype(jnp.float32), jnp.uint8).reshape(b, 4)
    cb = jax.lax.bitcast_convert_type(counts.astype(jnp.int32), jnp.uint8).reshape(b, 4)
    return jnp.concatenate([packed, sb, cb], axis=1)


def _unpack_results(buf: np.ndarray, L: int):
    """Inverse of gotoh_traceback_packed's wire layout."""
    Lp4 = -(-L // 4)
    arr = buf[:, :Lp4]
    ops = np.empty((buf.shape[0], Lp4 * 4), np.uint8)
    for k in range(4):
        ops[:, k::4] = (arr >> (2 * k)) & 3
    ops = ops[:, :L]
    scores = buf[:, Lp4 : Lp4 + 4].copy().view(np.float32).reshape(-1)
    counts = buf[:, Lp4 + 4 : Lp4 + 8].copy().view(np.int32).reshape(-1)
    return scores, ops, counts


def align_profiles_batch_async(
    profiles_a: np.ndarray,
    profiles_b: np.ndarray,
    lens_a: np.ndarray,
    lens_b: np.ndarray,
    subst: np.ndarray = HOXD70,
    gap_open: float = DEFAULT_GAP_OPEN,
    gap_extend: float = DEFAULT_GAP_EXTEND,
    normalize: bool = False,
):
    """Dispatch a batched profile-pair alignment; returns a zero-arg
    `fetch()` -> (list of op arrays in start-to-end order, scores [B]).

    Dispatch is async, the download blocks — drivers with several bucket
    launches dispatch all of them before fetching any, so the device works
    through the launches while the host waits on the first.

    Integer-count profiles are shipped uint8 and widened on device.
    normalize=True scores MEAN pairwise substitution (device-side division
    by each column's count total) — the profile-aware mode whose score
    scale matches plain code alignment.
    """
    from mauvealigner_tpu.utils import timing

    B, M, _ = profiles_a.shape
    N = profiles_b.shape[1]
    timing.GLOBAL.add("dp_cells", float(B) * M * N)
    timing.GLOBAL.add("dp_calls", 1.0)
    mA = jnp.asarray(lens_a, dtype=jnp.int32)
    mB = jnp.asarray(lens_b, dtype=jnp.int32)

    def ship(p):
        if p.dtype == np.uint8:  # preferred wire format; widen on device
            return jnp.asarray(p).astype(jnp.float32)
        if p.dtype == np.float32 and p.max(initial=0.0) < 255 and np.allclose(p, np.round(p)):
            return jnp.asarray(p.astype(np.uint8)).astype(jnp.float32)
        return jnp.asarray(p)

    forward = partial(gotoh_forward_scored, M=M, N=N, normalize=normalize)

    def _packed(pa, pb, la, lb, sub):
        scores_dev, dec = forward(
            pa, pb, la, lb, sub, jnp.float32(gap_open), jnp.float32(gap_extend)
        )
        return gotoh_traceback_packed(dec, la, lb, scores_dev, M, N)

    from mauvealigner_tpu.parallel import context as par_ctx

    # batch-sharded under an ambient mesh (per-element kernel, bit-identical)
    fetch_buf = par_ctx.shard_batched_call_async(
        _packed,
        [ship(profiles_a), ship(profiles_b), mA, mB],
        replicated_args=(jnp.asarray(subst, dtype=jnp.float32),),
    )

    def fetch():
        scores, ops_rev, counts = _unpack_results(fetch_buf(), M + N)
        out = [ops_rev[b, : counts[b]][::-1].copy() for b in range(B)]
        return out, scores

    return fetch


def align_profiles_batch(
    profiles_a: np.ndarray,
    profiles_b: np.ndarray,
    lens_a: np.ndarray,
    lens_b: np.ndarray,
    subst: np.ndarray = HOXD70,
    gap_open: float = DEFAULT_GAP_OPEN,
    gap_extend: float = DEFAULT_GAP_EXTEND,
    normalize: bool = False,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Blocking align_profiles_batch_async."""
    return align_profiles_batch_async(
        profiles_a, profiles_b, lens_a, lens_b, subst, gap_open, gap_extend,
        normalize,
    )()


@partial(jax.jit, static_argnames=("M", "N"))
def _gotoh_codes(
    codes_a: jnp.ndarray,  # uint8 [B, M] (padding >= 5)
    codes_b: jnp.ndarray,  # uint8 [B, N]
    lens_a: jnp.ndarray,
    lens_b: jnp.ndarray,
    subst: jnp.ndarray,
    gap_open: jnp.ndarray,
    gap_extend: jnp.ndarray,
    M: int,
    N: int,
):
    """Sequence-pair Gotoh with on-device one-hot construction: the upload
    carries 1 byte/base instead of 20 (5 x f32)."""
    sym = jnp.arange(5, dtype=jnp.uint8)
    pa = (codes_a[:, :, None] == sym[None, None, :]).astype(jnp.float32)
    pb = (codes_b[:, :, None] == sym[None, None, :]).astype(jnp.float32)
    return _gotoh_core(
        pa, pb, subst, gap_open, gap_extend, M, N, lens_a, lens_b, keep_H=False
    )


def align_code_pairs_batch_async(
    codes_a: np.ndarray,  # uint8 [B, M], pad with 255
    codes_b: np.ndarray,
    lens_a: np.ndarray,
    lens_b: np.ndarray,
    subst: np.ndarray = HOXD70,
    gap_open: float = DEFAULT_GAP_OPEN,
    gap_extend: float = DEFAULT_GAP_EXTEND,
):
    """Sequence-pair variant of align_profiles_batch_async (uint8 codes
    upload); returns a zero-arg fetch() -> (ops list, scores)."""
    from mauvealigner_tpu.utils import timing

    B, M = codes_a.shape
    N = codes_b.shape[1]
    timing.GLOBAL.add("dp_cells", float(B) * M * N)
    timing.GLOBAL.add("dp_calls", 1.0)
    mA = jnp.asarray(lens_a, dtype=jnp.int32)
    mB = jnp.asarray(lens_b, dtype=jnp.int32)
    def _packed(ca, cb, la, lb, sub):
        scores_dev, dec = _gotoh_codes(
            ca, cb, la, lb, sub,
            jnp.float32(gap_open), jnp.float32(gap_extend), M, N,
        )
        return gotoh_traceback_packed(dec, la, lb, scores_dev, M, N)

    from mauvealigner_tpu.parallel import context as par_ctx

    # batch-sharded under an ambient mesh (per-element kernel, bit-identical)
    fetch_buf = par_ctx.shard_batched_call_async(
        _packed,
        [jnp.asarray(codes_a), jnp.asarray(codes_b), mA, mB],
        replicated_args=(jnp.asarray(subst, dtype=jnp.float32),),
    )

    def fetch():
        scores, ops_rev, counts = _unpack_results(fetch_buf(), M + N)
        out = [ops_rev[b, : counts[b]][::-1].copy() for b in range(B)]
        return out, scores

    return fetch


def align_code_pairs_batch(
    codes_a: np.ndarray,  # uint8 [B, M], pad with 255
    codes_b: np.ndarray,
    lens_a: np.ndarray,
    lens_b: np.ndarray,
    subst: np.ndarray = HOXD70,
    gap_open: float = DEFAULT_GAP_OPEN,
    gap_extend: float = DEFAULT_GAP_EXTEND,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Blocking align_code_pairs_batch_async."""
    return align_code_pairs_batch_async(
        codes_a, codes_b, lens_a, lens_b, subst, gap_open, gap_extend
    )()


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _batch_bucket(n: int) -> int:
    """Round a batch size up to a power of two (bounds compiled shapes)."""
    return 1 << max(0, (n - 1).bit_length())


DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def align_sequence_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    subst: np.ndarray = HOXD70,
    gap_open: float = DEFAULT_GAP_OPEN,
    gap_extend: float = DEFAULT_GAP_EXTEND,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    max_batch: int = 4096,
    memory_budget_bytes: int = 3 << 29,
) -> List[np.ndarray]:
    """Globally align many (codesA, codesB) pairs, bucketing by length.

    Returns per-pair op arrays.  Pairs longer than the largest bucket raise:
    callers cap region size (--max-gapped-aligner-length semantics,
    src/mauveAligner.cpp:675-676).

    memory_budget_bytes bounds the measured peak device memory per launch
    (default 1.5 GB, a small share of an H100's 80 GB; lower it on smaller
    devices).
    """
    results: List[np.ndarray] = [None] * len(pairs)  # type: ignore[list-item]
    groups: dict = {}
    for idx, (a, b) in enumerate(pairs):
        if len(a) == 0 or len(b) == 0:
            # degenerate: pure gap alignment
            ops = np.concatenate(
                [np.full(len(a), OP_UP, np.uint8), np.full(len(b), OP_LEFT, np.uint8)]
            )
            results[idx] = ops
            continue
        if len(a) > buckets[-1] or len(b) > buckets[-1]:
            raise ValueError(
                f"region {idx} ({len(a)}x{len(b)}) exceeds the largest DP bucket {buckets[-1]}"
            )
        # square buckets: one compiled shape per size class (fewer compiles;
        # the padded cells cost less than a compile per shape)
        side = _bucket(max(len(a), len(b)), buckets)
        groups.setdefault((side, side), []).append(idx)
    pending = []  # (chunk, fetch): dispatch every launch, then download
    for (M, N), idxs in groups.items():
        # per-element device PEAK footprint: dec u8 ((M+N+1)*(M+1)) plus the
        # score matrix S f32 (4*M*N) and its transient sheared copies
        # (Spad/QT, another ~2x S) — 12*M*N covers the measured ~3x S peak;
        # H rows are not materialized.
        per_elt = (M + N + 1) * (M + 1) + 12 * M * N
        bucket_batch = max(1, min(max_batch, memory_budget_bytes // per_elt))
        for off in range(0, len(idxs), bucket_batch):
            chunk = idxs[off : off + bucket_batch]
            # pad the batch to the full bucket size: one compiled shape per
            # bucket regardless of how many regions fall in it
            B = bucket_batch if len(idxs) > bucket_batch else _batch_bucket(len(chunk))
            ca = np.full((B, M), 255, np.uint8)
            cb = np.full((B, N), 255, np.uint8)
            la = np.zeros(B, np.int32)
            lb = np.zeros(B, np.int32)
            for k, idx in enumerate(chunk):
                a, b = pairs[idx]
                ca[k, : len(a)] = np.minimum(a, 4)
                cb[k, : len(b)] = np.minimum(b, 4)
                la[k], lb[k] = len(a), len(b)
            pending.append((chunk, align_code_pairs_batch_async(
                ca, cb, la, lb, subst, gap_open, gap_extend
            )))
    for chunk, fetch in pending:
        ops_list, _ = fetch()
        for k, idx in enumerate(chunk):
            results[idx] = ops_list[k]
    return results


def ops_to_gap_rows(ops: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Op string -> (rowA, rowB) boolean arrays (True = base, False = gap)."""
    row_a = (ops == OP_DIAG) | (ops == OP_UP)
    row_b = (ops == OP_DIAG) | (ops == OP_LEFT)
    return row_a, row_b
