"""K4: hidden-Markov-model scans (homology HMM forward/backward).

Replaces libMems' HomologyHMM (reference call sites
src/progressiveMauve.cpp:226-260, src/repeatoire.cpp:1324).  The pair-HMM
posterior decoding over alignment columns is expressed as log-space
forward/backward scans, batched over many pairwise projections at once.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG = -1e30


def _norm_matmul(A: jnp.ndarray, Bm: jnp.ndarray) -> jnp.ndarray:
    """(..., S, S) matrix product renormalized to max 1.

    Posterior decoding is scale-invariant, so the product chain can run in
    plain probability space as long as every combine rescales: entries stay
    in (0, 1] regardless of sequence length.  This keeps the associative
    scan free of transcendentals — the log-space formulation spent its
    device time in exp/log inside every logsumexp, ~10 of them per [2, 2]
    combine."""
    C = jnp.einsum("...ik,...kj->...ij", A, Bm, precision=jax.lax.Precision.HIGHEST)
    m = jnp.max(C, axis=(-2, -1), keepdims=True)
    return C / jnp.maximum(m, jnp.float32(1e-30))


def _combine2(x, y):
    """2-state chain combine: element-wise 2x2 matrix product L @ R over
    four [B, T] entry lanes, renormalized to max 1.  The lane layout keeps
    the long T axis minor instead of scanning [B, T, 2, 2] tensors whose
    tiny trailing (2, 2) matrices a tiled device layout pads."""
    xa, xb, xc, xd = x
    ya, yb, yc, yd = y
    ca = xa * ya + xb * yc
    cb = xa * yb + xb * yd
    cc = xc * ya + xd * yc
    cd = xc * yb + xd * yd
    m = jnp.maximum(
        jnp.maximum(jnp.maximum(ca, cb), jnp.maximum(cc, cd)), jnp.float32(1e-30)
    )
    return (ca / m, cb / m, cc / m, cd / m)


def _forward_backward_2state(
    log_emit: jnp.ndarray,   # [B, T, 2]
    log_trans: jnp.ndarray,  # [2, 2]
    log_init: jnp.ndarray,   # [2]
    lengths: jnp.ndarray,    # [B]
) -> jnp.ndarray:
    """S=2 specialization of forward_backward on four [B, T] entry lanes
    (see _combine2 for why not the matrix layout)."""
    B, T, _ = log_emit.shape
    step_ids = jnp.arange(T)
    pad_mask = step_ids[None, :] < lengths[:, None]  # [B, T]
    le = jnp.where(pad_mask[:, :, None], log_emit, 0.0)
    e0, e1 = jnp.exp(le[:, :, 0]), jnp.exp(le[:, :, 1])  # [B, T]
    trans = jnp.exp(log_trans)
    init = jnp.exp(log_init)

    # forward prefix over steps 1..T-1: A_t[i, j] = trans[i, j] * emit_t[j]
    a = trans[0, 0] * e0[:, 1:]
    b = trans[0, 1] * e1[:, 1:]
    c = trans[1, 0] * e0[:, 1:]
    d = trans[1, 1] * e1[:, 1:]
    pa, pb, pc, pd = jax.lax.associative_scan(_combine2, (a, b, c, d), axis=1)
    a00 = init[0] * e0[:, 0]
    a01 = init[1] * e1[:, 0]
    m0 = jnp.maximum(jnp.maximum(a00, a01), jnp.float32(1e-30))
    a00, a01 = a00 / m0, a01 / m0
    ar0 = a00[:, None] * pa + a01[:, None] * pc
    ar1 = a00[:, None] * pb + a01[:, None] * pd
    alphas0 = jnp.concatenate([a00[:, None], ar0], axis=1)  # [B, T]
    alphas1 = jnp.concatenate([a01[:, None], ar1], axis=1)

    # backward suffix: scan the TRANSPOSED factors (swap b/c lanes) in
    # reverse; beta_t = row sums of A_{t+1}..A_{T-1} = column sums of the
    # transposed product.
    sa, sb, sc, sd = jax.lax.associative_scan(
        _combine2, (a, c, b, d), axis=1, reverse=True
    )
    ones = jnp.ones((B, 1), log_emit.dtype)
    betas0 = jnp.concatenate([sa + sc, ones], axis=1)
    betas1 = jnp.concatenate([sb + sd, ones], axis=1)

    raw0 = alphas0 * betas0
    raw1 = alphas1 * betas1
    denom = jnp.maximum(raw0 + raw1, jnp.float32(1e-30))
    post = jnp.stack([raw0 / denom, raw1 / denom], axis=-1)
    return jnp.where(pad_mask[:, :, None], post, 0.0)


@partial(jax.jit, static_argnames=())
def forward_backward(
    log_emit: jnp.ndarray,   # [B, T, S] per-step emission log-probs
    log_trans: jnp.ndarray,  # [S, S] log transition matrix (row=from)
    log_init: jnp.ndarray,   # [S]
    lengths: jnp.ndarray,    # [B] actual sequence lengths (<= T)
) -> jnp.ndarray:
    """Returns posterior state probabilities [B, T, S].

    Log-depth associative scans over per-step transition matrices (instead
    of a T-step sequential scan: alignment columns run to hundreds of
    thousands, and a log-depth tree is both faster and cheaper to compile).
    The scan runs in probability space with per-combine renormalization
    (see _norm_matmul); posteriors are invariant to the rescaling.

    Steps beyond `lengths` are padding: they contribute emission
    probability one, so the row-stochastic transition factors leave the
    backward pass invariant (beta stays constant over padding).

    The production S=2 case routes to a lane-decomposed kernel: scanning
    [B, T, S, S] tensors puts the (S, S) matrix in the two minor (tiled)
    dimensions, which a tiled device layout pads.
    """
    B, T, S = log_emit.shape
    if S == 2:
        return _forward_backward_2state(log_emit, log_trans, log_init, lengths)
    step_ids = jnp.arange(T)
    pad_mask = step_ids[None, :] < lengths[:, None]  # [B, T]
    le = jnp.where(pad_mask[:, :, None], log_emit, 0.0)
    emit = jnp.exp(le)                                  # [B, T, S], <= 1

    # forward: alpha_t = alpha_0 (x) A_1 (x) ... (x) A_t with
    # A_t[i, j] = trans[i, j] * emit_t[j]
    A = jnp.exp(log_trans)[None, None] * emit[:, :, None, :]  # [B, T, S, S]
    A_fwd = A[:, 1:]                                    # steps 1..T-1
    prefix = jax.lax.associative_scan(_norm_matmul, A_fwd, axis=1)
    alpha0_raw = jnp.exp(log_init) * emit[:, 0]
    alpha0 = alpha0_raw / jnp.maximum(
        jnp.max(alpha0_raw, axis=-1, keepdims=True), jnp.float32(1e-30)
    )
    alpha0 = alpha0[:, None, :]                         # [B, 1, S]
    alphas_rest = jnp.einsum(
        "bok,btkj->btj", alpha0, prefix, precision=jax.lax.Precision.HIGHEST
    )  # [B, T-1, S]
    alphas = jnp.concatenate([alpha0, alphas_rest], axis=1)    # [B, T, S]

    # backward: beta_t = A_{t+1} (x) ... (x) A_{T-1} (x) ones.  A reverse
    # associative_scan composes right-to-left, so scan the TRANSPOSED
    # matrices: suffix_T[k] = (A_{k+1} ... A_{T-1})^T.
    suffix_T = jax.lax.associative_scan(
        _norm_matmul, jnp.swapaxes(A_fwd, -1, -2), axis=1, reverse=True
    )
    betas_rest = jnp.sum(suffix_T, axis=-2)             # [B, T-1, S] (beta_0..beta_{T-2})
    beta_T = jnp.ones((B, 1, S))
    betas = jnp.concatenate([betas_rest, beta_T], axis=1)

    post_raw = alphas * betas
    denom = jnp.sum(post_raw, axis=2, keepdims=True)
    post = post_raw / jnp.maximum(denom, jnp.float32(1e-30))
    return jnp.where(pad_mask[:, :, None], post, 0.0)


@jax.jit
def forward_backward_state0(
    log_emit: jnp.ndarray,   # [B, T, S]
    log_trans: jnp.ndarray,  # [S, S]
    log_init: jnp.ndarray,   # [S]
    lengths: jnp.ndarray,    # [B]
) -> jnp.ndarray:
    """Posterior of state 0 only, [B, T] — halves the device->host transfer
    for the (dominant) homology-backbone consumer, which reads only P(H)."""
    return forward_backward(log_emit, log_trans, log_init, lengths)[:, :, 0]


def _packbits(bits: jnp.ndarray) -> jnp.ndarray:
    """uint8 [B, T] of 0/1 -> uint8 [B, T//8] little-endian bit-packed: the
    thresholded posterior download is the dominant transfer of the backbone
    phase, and bits are an 8x smaller wire format (np.unpackbits restores)."""
    B, T = bits.shape
    w = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))[None, None, :]
    return jnp.sum(
        bits.reshape(B, T // 8, 8).astype(jnp.uint8) * w, axis=-1, dtype=jnp.uint8
    )


@jax.jit
def forward_backward_state0_gt(
    log_emit: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_init: jnp.ndarray,
    lengths: jnp.ndarray,
    threshold: jnp.ndarray,  # scalar
) -> jnp.ndarray:
    """Bit-packed uint8 [B, T//8]: bit t set where P(state 0) > threshold.
    The backbone detector consumes only the thresholded posterior, and
    packed bits are 1/32nd of the f32 transfer."""
    post0 = forward_backward(log_emit, log_trans, log_init, lengths)[:, :, 0]
    return _packbits((post0 > threshold).astype(jnp.uint8))


@jax.jit
def forward_backward_prefix(
    log_emit: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_init: jnp.ndarray,
    lengths: jnp.ndarray,
    threshold: jnp.ndarray,  # scalar
) -> jnp.ndarray:
    """int32 [B]: number of leading steps whose P(state 0) stays >= threshold
    (first crossing ends the prefix; padding never counts)."""
    post0 = forward_backward(log_emit, log_trans, log_init, lengths)[:, :, 0]
    T = post0.shape[1]
    iota = jnp.arange(T, dtype=jnp.int32)
    bad = (iota[None, :] < lengths[:, None]) & (post0 < threshold)
    first_bad = jnp.min(jnp.where(bad, iota[None, :], T), axis=1)
    return jnp.minimum(first_bad, lengths).astype(jnp.int32)


@jax.jit
def _fb_state0_sym(symbols, table_T, log_trans, log_init, lengths):
    """P(state 0) [B, T] from uint8 symbol streams; emissions looked up on
    device (the symbol upload is 1/8th of the float32 emission upload)."""
    le = table_T[symbols.astype(jnp.int32)]
    return forward_backward(le, log_trans, log_init, lengths)[:, :, 0]


@jax.jit
def _fb_state0_gt_sym(symbols, table_T, log_trans, log_init, lengths, threshold):
    le = table_T[symbols.astype(jnp.int32)]
    post0 = forward_backward(le, log_trans, log_init, lengths)[:, :, 0]
    return _packbits((post0 > threshold).astype(jnp.uint8))


@jax.jit
def _fb_prefix_sym(symbols, table_T, log_trans, log_init, lengths, threshold):
    le = table_T[symbols.astype(jnp.int32)]
    post0 = forward_backward(le, log_trans, log_init, lengths)[:, :, 0]
    T = post0.shape[1]
    iota = jnp.arange(T, dtype=jnp.int32)
    bad = (iota[None, :] < lengths[:, None]) & (post0 < threshold)
    first_bad = jnp.min(jnp.where(bad, iota[None, :], T), axis=1)
    return jnp.minimum(first_bad, lengths).astype(jnp.int32)


def bucketed_decode(
    log_emits,            # list of np.float32 [T_j, S] per-job emission rows,
                          # OR (with emit_table) np.int8/uint8 [T_j] symbols
    log_trans,            # [S, S] (np or jnp)
    log_init,             # [S]
    mode: str,            # "posterior0" | "threshold0" | "prefix0"
    threshold: float = 0.5,
    max_cols: int = 1 << 16,
    mem_budget: int = 1 << 27,
    emit_table=None,      # [S, n_symbols] log emission table; when given,
                          # log_emits holds SYMBOL streams and the emission
                          # lookup runs on device
):
    """Run many variable-length HMM decodes through the batched kernels.

    Every new shape costs a compile, so jobs bucket by power-of-two padded length (capped at `max_cols`; longer
    jobs must be pre-chunked by the caller) and power-of-two batch size,
    with a memory-based chunk cap (256 rows at the 65536-column maximum).
    Returns a list aligned with `log_emits`:
      posterior0 -> np.float32 [T_j] P(state 0);
      threshold0 -> np.bool_  [T_j] P(state 0) > threshold;
      prefix0    -> int, leading steps with P(state 0) >= threshold.
    """
    lt = jnp.asarray(log_trans)
    li = jnp.asarray(log_init)
    S = int(li.shape[0])
    tab = None if emit_table is None else jnp.asarray(
        np.asarray(emit_table, np.float32).T  # [n_symbols, S]
    )
    out: list = [None] * len(log_emits)
    buckets: dict = {}
    for idx, le_row in enumerate(log_emits):
        T = len(le_row)
        if T == 0:
            out[idx] = (
                0 if mode == "prefix0" else np.zeros(0, bool if mode == "threshold0" else np.float32)
            )
            continue
        if T > max_cols:
            raise ValueError(f"job length {T} exceeds max_cols {max_cols}")
        Tp = 1 << max(4, (T - 1).bit_length())
        buckets.setdefault(Tp, []).append(idx)
    for Tp, idxs in buckets.items():
        cap_rows = max(64, mem_budget // max(Tp * 4 * S, 1))
        for off in range(0, len(idxs), cap_rows):
            chunk = idxs[off : off + cap_rows]
            B = 1 << max(3, (len(chunk) - 1).bit_length())
            lengths = np.zeros(B, np.int64)
            if tab is None:
                le = np.zeros((B, Tp, S), np.float32)
                for bi, idx in enumerate(chunk):
                    row = log_emits[idx]
                    lengths[bi] = len(row)
                    le[bi, : len(row)] = row
            else:
                le = np.zeros((B, Tp), np.uint8)
                for bi, idx in enumerate(chunk):
                    row = log_emits[idx]
                    lengths[bi] = len(row)
                    le[bi, : len(row)] = row
                # the device gather clamps out-of-range indices silently;
                # fail loudly here like the host-side table indexing did
                if int(le.max(initial=0)) >= tab.shape[0]:
                    raise ValueError(
                        f"symbol {int(le.max())} out of range for emission "
                        f"table with {tab.shape[0]} symbols"
                    )
            from mauvealigner_tpu.parallel import context as par_ctx

            led, lend = jnp.asarray(le), jnp.asarray(lengths)
            thr = jnp.float32(threshold)
            # batch-sharded under an ambient mesh (per-element decode,
            # bit-identical to the direct call); kernel args are
            # (*batch, *replicated)
            if mode == "posterior0":
                if tab is None:
                    res = par_ctx.shard_batched_call(
                        lambda e, n, t, i: forward_backward_state0(e, t, i, n),
                        [led, lend], (lt, li),
                    )
                else:
                    res = par_ctx.shard_batched_call(
                        lambda e, n, tb, t, i: _fb_state0_sym(e, tb, t, i, n),
                        [led, lend], (tab, lt, li),
                    )
                for bi, idx in enumerate(chunk):
                    out[idx] = res[bi, : int(lengths[bi])]
            elif mode == "threshold0":
                if tab is None:
                    packed = par_ctx.shard_batched_call(
                        lambda e, n, t, i, th: forward_backward_state0_gt(
                            e, t, i, n, th
                        ),
                        [led, lend], (lt, li, thr),
                    )
                else:
                    packed = par_ctx.shard_batched_call(
                        lambda e, n, tb, t, i, th: _fb_state0_gt_sym(
                            e, tb, t, i, n, th
                        ),
                        [led, lend], (tab, lt, li, thr),
                    )
                res = np.unpackbits(packed, axis=1, bitorder="little").astype(bool)
                for bi, idx in enumerate(chunk):
                    out[idx] = res[bi, : int(lengths[bi])]
            elif mode == "prefix0":
                if tab is None:
                    res = par_ctx.shard_batched_call(
                        lambda e, n, t, i, th: forward_backward_prefix(
                            e, t, i, n, th
                        ),
                        [led, lend], (lt, li, thr),
                    )
                else:
                    res = par_ctx.shard_batched_call(
                        lambda e, n, tb, t, i, th: _fb_prefix_sym(
                            e, tb, t, i, n, th
                        ),
                        [led, lend], (tab, lt, li, thr),
                    )
                for bi, idx in enumerate(chunk):
                    out[idx] = int(res[bi])
            else:
                raise ValueError(f"unknown mode {mode!r}")
    return out


def _fb2_pair_rows_state0(ri, rj, table_T, log_trans, log_init, lengths):
    """P(state 0) [B, T] decoded directly from PAIR CODE ROWS on device.

    ri/rj: uint8 [B, T] per-column base codes (0-3 = A/C/G/T, 4 = N,
    5 = gap/absent) in match-space orientation.  The column symbol classes
    match analysis/backbone.SYMBOL_LUT (match / transition / transversion /
    gap), computed elementwise — no host symbol extraction, no LUT gather.

    Both-gap columns are INERT: their chain element is the identity matrix,
    so forward/backward state passes through untouched and the posterior
    there equals the nearest live column's — exactly the reference's
    projected-pair semantics (the projection does not contain those
    columns; the host path removes them and forward-fills,
    analysis/backbone.pairwise_homology_posteriors).  The first live
    column's element is diag(e) (no transition), matching the projected
    chain's start.
    """
    B, T = ri.shape
    iota = jnp.arange(T, dtype=jnp.int32)
    pad = iota[None, :] >= lengths[:, None]
    none = ((ri == 5) & (rj == 5)) | pad
    base = (ri < 4) & (rj < 4)
    match = base & (ri == rj)
    # transitions are A<->G (0^2) and C<->T (1^3): xor == 2
    tr_sym = base & ((ri ^ rj) == 2)
    et = jnp.exp(table_T)  # [4, 2] symbol -> per-state emission prob
    # 4-way select instead of a gather (tiny table, elementwise select wins)
    def emit(state):
        return jnp.where(
            match, et[0, state],
            jnp.where(tr_sym, et[1, state],
                      jnp.where(base, et[2, state], et[3, state])),
        )

    e0 = jnp.where(none, 1.0, emit(0))
    e1 = jnp.where(none, 1.0, emit(1))
    trans = jnp.exp(log_trans)
    init = jnp.exp(log_init)
    live = ~none
    first = live & (jnp.cumsum(live.astype(jnp.int32), axis=1) == 1)

    nz, f = none[:, 1:], first[:, 1:]
    E0, E1 = e0[:, 1:], e1[:, 1:]
    a = jnp.where(nz, 1.0, jnp.where(f, E0, trans[0, 0] * E0))
    b = jnp.where(nz | f, 0.0, trans[0, 1] * E1)
    c = jnp.where(nz | f, 0.0, trans[1, 0] * E0)
    d = jnp.where(nz, 1.0, jnp.where(f, E1, trans[1, 1] * E1))
    pa, pb, pc, pd = jax.lax.associative_scan(_combine2, (a, b, c, d), axis=1)
    a00 = init[0] * e0[:, 0]
    a01 = init[1] * e1[:, 0]
    m0 = jnp.maximum(jnp.maximum(a00, a01), jnp.float32(1e-30))
    a00, a01 = a00 / m0, a01 / m0
    alphas0 = jnp.concatenate(
        [a00[:, None], a00[:, None] * pa + a01[:, None] * pc], axis=1
    )
    alphas1 = jnp.concatenate(
        [a01[:, None], a00[:, None] * pb + a01[:, None] * pd], axis=1
    )
    sa, sb, sc, sd = jax.lax.associative_scan(
        _combine2, (a, c, b, d), axis=1, reverse=True
    )
    ones = jnp.ones((B, 1), jnp.float32)
    betas0 = jnp.concatenate([sa + sc, ones], axis=1)
    betas1 = jnp.concatenate([sb + sd, ones], axis=1)
    raw0 = alphas0 * betas0
    raw1 = alphas1 * betas1
    post0 = raw0 / jnp.maximum(raw0 + raw1, jnp.float32(1e-30))
    return jnp.where(pad, 0.0, post0)


@jax.jit
def pair_rows_state0_gt(
    rows: jnp.ndarray,      # uint8 [P, T] code rows (shared across pairs)
    ii: jnp.ndarray,        # int32 [B] row index of pair member i
    jj: jnp.ndarray,        # int32 [B] row index of pair member j
    table_T: jnp.ndarray,   # [4, 2] log emission table (symbol-major)
    log_trans: jnp.ndarray,
    log_init: jnp.ndarray,
    lengths: jnp.ndarray,   # [B]
    threshold: jnp.ndarray,
) -> jnp.ndarray:
    """Bit-packed P(Homologous) > threshold per column for many pairwise
    projections sharing a code-row table (the device-resident backbone
    symbol path): one row upload serves every pair containing it."""
    post0 = _fb2_pair_rows_state0(
        rows[ii], rows[jj], table_T, log_trans, log_init, lengths
    )
    return _packbits((post0 > threshold).astype(jnp.uint8))


@jax.jit
def viterbi(
    log_emit: jnp.ndarray,   # [B, T, S]
    log_trans: jnp.ndarray,  # [S, S]
    log_init: jnp.ndarray,   # [S]
    lengths: jnp.ndarray,    # [B]
) -> jnp.ndarray:
    """Most-likely state path [B, T] (int32; padding steps repeat last state)."""
    B, T, S = log_emit.shape
    step_ids = jnp.arange(T)
    pad_mask = step_ids[None, :] < lengths[:, None]
    le = jnp.where(pad_mask[:, :, None], log_emit, 0.0)

    def vit_step(delta, e_t):
        scores = delta[:, :, None] + log_trans[None]  # [B, S_from, S_to]
        best_from = jnp.argmax(scores, axis=1)
        d = jnp.max(scores, axis=1) + e_t
        return d, best_from

    delta0 = log_init[None] + le[:, 0]
    deltaT, backs = jax.lax.scan(vit_step, delta0, jnp.moveaxis(le[:, 1:], 1, 0))

    last = jnp.argmax(deltaT, axis=1)

    def bt_step(state, back_t):
        prev = jnp.take_along_axis(back_t, state[:, None], axis=1)[:, 0]
        return prev, prev

    _, path_rev = jax.lax.scan(bt_step, last, backs, reverse=True)
    path = jnp.concatenate([path_rev, last[None]], axis=0)  # [T, B]
    return jnp.moveaxis(path, 0, 1).astype(jnp.int32)
