"""K2: multi-way mer merge and multi-MUM enumeration.

Replaces the libMems MatchFinder/MemHash hierarchy
(MaskedMemHash at src/mauveAligner.cpp:523-530, PairwiseMatchFinder /
UniqueMatchFinder at src/progressiveMauve.cpp:489-502, RepeatHash at
src/mauveAligner.cpp:481-483, SeedMatchEnumerator at
src/SeedMatchEnumerator.h:59-141).

Redesign: instead of a streaming k-way merge with a hash table of match
extensions, everything is expressed as sorts + segmented scans:

  1. concatenate every genome's (canonical key, position) list, tagged with
     the genome id, and sort by (mer, genome, position) on device;
  2. group identical mers (a "seed group"); within a group classify each
     occurrence as genome-unique or repeated;
  3. build seed matches from groups (unique-MUM mode keeps only the
     genome-unique occurrences; repeat mode keeps all);
  4. merge *runs* of diagonal-consistent consecutive seed matches into one
     match (the seed windows inside a maximal match all hit the same group
     structure), then
  5. extend matches base-by-base to maximality and deduplicate.

Strand handling follows the reference parity rule
(SeedMatchEnumerator::SetDirection, src/SeedMatchEnumerator.h:127-141): the
first participating genome is the reference component (always forward); any
component whose canonical-strand bit differs from the reference's is
reverse, i.e. gets a negative start.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mauvealigner_tpu.core.match import NO_MATCH, MatchList
from mauvealigner_tpu.core.sml import SortedMerList
from mauvealigner_tpu.genome.sequence import Genome
from mauvealigner_tpu.ops import merops
from mauvealigner_tpu.ops.merops import INVALID_KEY

_INT64_MAX = np.iinfo(np.int64).max


@jax.jit
def _global_sort(keys: jnp.ndarray, seq_ids: jnp.ndarray, positions: jnp.ndarray):
    """Sort concatenated SML entries by (mer, genome, position) on device.

    keys carry the strand bit in the LSB; sorting by the strand-free mer
    requires dropping it, so the sort keys are (mer_hi, mer_lo, seq, pos).
    """
    mer = keys >> 1
    strand = (keys & 1).astype(jnp.int32)
    hi = (mer >> 31).astype(jnp.int32)          # mer <= 62 bits
    lo = (mer & jnp.int64(0x7FFFFFFF)).astype(jnp.int32)
    hi_s, lo_s, seq_s, pos_s, strand_s = jax.lax.sort(
        (hi, lo, seq_ids, positions, strand), num_keys=4
    )
    mer_s = (hi_s.astype(jnp.int64) << 31) | lo_s.astype(jnp.int64)
    return mer_s, seq_s, pos_s, strand_s


@jax.jit
def _global_sort_packed(keys: jnp.ndarray, seq_ids: jnp.ndarray, positions: jnp.ndarray):
    """_global_sort with (seq, pos, strand) packed into ONE int32 lane:
    3 operands / 3 keys instead of 5 operands / 4 keys (the sort's data
    movement is the K2 bottleneck at genome scale).

    Requires pos < 2^23 and seq < 2^7 (caller checks statically from the
    padded SML lengths).  Order is identical: (mer, seq, pos) — the strand
    bit rides in the LSB but two entries can never share (mer, seq, pos).
    """
    mer = keys >> 1
    strand = (keys & 1).astype(jnp.int32)
    hi = (mer >> 31).astype(jnp.int32)
    lo = (mer & jnp.int64(0x7FFFFFFF)).astype(jnp.int32)
    packed = (seq_ids << 24) | (positions << 1) | strand
    hi_s, lo_s, packed_s = jax.lax.sort((hi, lo, packed), num_keys=3)
    mer_s = (hi_s.astype(jnp.int64) << 31) | lo_s.astype(jnp.int64)
    seq_s = packed_s >> 24
    pos_s = (packed_s >> 1) & jnp.int32(0x7FFFFF)
    strand_s = packed_s & 1
    return mer_s, seq_s, pos_s, strand_s


def _device_sorted_entries(smls: Sequence[SortedMerList]):
    """Concatenate per-genome SMLs and sort globally on device."""
    keys = np.concatenate([s.keys for s in smls]) if smls else np.zeros(0, np.int64)
    seq_ids = np.concatenate(
        [np.full(len(s.keys), i, np.int32) for i, s in enumerate(smls)]
    ) if smls else np.zeros(0, np.int32)
    pos = np.concatenate([s.positions for s in smls]) if smls else np.zeros(0, np.int32)
    if len(keys) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32))
    # pad to a bucketed size to bound recompiles: coarse x4 buckets at small
    # sizes, the x1.5 ladder above 4M (an 18M-entry concat must pad to 24M,
    # not 67M — sort cost tracks the padded size)
    n = len(keys)
    bucket = 1 << 14
    while bucket < n and bucket < (1 << 22):
        bucket *= 4
    if bucket < n:
        bucket = merops.bucket_size(n, floor=bucket)
    pad = bucket - n
    # padding must sort after every real entry: INVALID_KEY's mer (2^61)
    # exceeds any valid mer (weight <= 30 -> < 2^60)
    keys_p = np.concatenate([keys, np.full(pad, INVALID_KEY, np.int64)])
    seq_p = np.concatenate([seq_ids, np.full(pad, 0, np.int32)])
    pos_p = np.concatenate([pos, np.full(pad, 0, np.int32)])
    mer_s, seq_s, pos_s, strand_s = _global_sort(
        jnp.asarray(keys_p), jnp.asarray(seq_p), jnp.asarray(pos_p)
    )
    # slice on DEVICE before download: padding sorts to the tail, and
    # np.asarray(x)[:n] would pull the whole bucket-padded arrays to the
    # host (up to 4x the real data)
    return (
        np.asarray(mer_s[:n]),
        np.asarray(seq_s[:n]),
        np.asarray(pos_s[:n]),
        np.asarray(strand_s[:n]),
    )


# ---------------------------------------------------------------------------
# Device-resident K2: host<->device bandwidth is far below device memory
# bandwidth, so the SML entry arrays never leave the device.  Seed-group construction, uniqueness filtering, group
# signature hashing, and diagonal-run merging all run in one jitted pipeline;
# only the merged match table (KBs) is transferred.
# ---------------------------------------------------------------------------

_MIX_C1 = np.int64(-7046029254386353131)  # 0x9E3779B97F4A7C15 as signed
_MIX_C2 = np.int64(-4417276706812531889)  # 0xC2B2AE3D27D4EB4F
_MIX_C3 = np.int64(-8796714831421723037)  # 0x85EBCA77C2B2AE63


def _mix64(x: jnp.ndarray, c: np.int64) -> jnp.ndarray:
    """SplitMix64-style finalizer (wrapping int64 arithmetic)."""
    x = x * c
    x = x ^ ((x >> 30) & jnp.int64(0x3FFFFFFFF))
    x = x * jnp.int64(-4658895280553007687)  # 0xBF58476D1CE4E5B9
    x = x ^ ((x >> 27) & jnp.int64(0x1FFFFFFFFF))
    return x


def _carry_last2(va, vb, flags, reverse=False):
    """Per-entry (va, vb) of the nearest flagged entry at/before each
    position (at/after with reverse=True); positions before any flag keep
    their own values.

    A native cummax/cummin over flagged indices (monotone by construction)
    finds each entry's source; two gathers with nondecreasing indices fetch
    the values.  (A tuple associative_scan expressed the same carry but
    lowered ~3x slower on the CPU test backend.)"""
    n = va.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    if reverse:
        idx = jax.lax.cummin(jnp.where(flags, iota, jnp.int32(n)), reverse=True)
        ok = idx < n
    else:
        idx = jax.lax.cummax(jnp.where(flags, iota, jnp.int32(-1)))
        ok = idx >= 0
    safe = jnp.clip(idx, 0, n - 1)
    out = tuple(
        jnp.where(ok, v[safe], v) for v in (va, vb) if v is not None
    )
    return out if vb is not None else out[0]


def _sig_phase(keys, seq_ids, positions, seq_mask, n_seqs, min_multi, pack_sort):
    """Grouping half of the candidate kernel: sort by (mer, genome, pos),
    detect seed groups, per-genome uniqueness, reference selection, and the
    order-independent 64-bit group signature.

    Returns per-entry arrays (sorted order): seg ids, kept mask, rep mask
    (the group's reference entry), group signature (incl. multiplicity),
    genome ids, window positions, signed 1-based positions.

    Segments are CONTIGUOUS in the sorted order, so every per-segment
    reduction/broadcast here is a cumsum plus monotone cummax/cummin fills
    (or a carry scan where values are not monotone) — the scatter-add /
    gather formulation cost ~10x the sort itself on this backend.

    The signature design: 64 bits keep the run-grouping sort at 4 keys
    instead of 6 (each extra key adds bitonic passes over the whole array);
    with ~2^21 groups the birthday collision odds are ~2^-23, and a
    collision only matters if the two groups are ALSO diagonal-adjacent,
    which the p0 continuity check makes astronomically unlikely.
    """
    N = keys.shape[0]
    sortfn = _global_sort_packed if pack_sort else _global_sort
    mer_s, seq_s, pos_s, strand_s = sortfn(keys, seq_ids, positions)
    valid = mer_s != (INVALID_KEY >> 1)

    prev_mer = jnp.concatenate([mer_s[:1] - 1, mer_s[:-1]])
    new_seg = mer_s != prev_mer
    is_end = jnp.concatenate([new_seg[1:], jnp.ones(1, bool)])
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    prev_seq = jnp.concatenate([seq_s[:1] - 1, seq_s[:-1]])
    same_ms = (~new_seg) & (seq_s == prev_seq)
    next_same = jnp.concatenate([same_ms[1:], jnp.zeros(1, bool)])
    occ_unique = valid & ~same_ms & ~next_same
    kept = occ_unique & (seq_mask[jnp.clip(seq_s, 0, n_seqs - 1)] > 0)

    # segment kept-count, broadcast per entry: cumsum + monotone boundary
    # fills (segment-start bases and segment-end totals are nondecreasing,
    # so forward cummax / reverse cummin pick each entry's own boundary)
    k32 = kept.astype(jnp.int32)
    cs = jnp.cumsum(k32)
    base = jax.lax.cummax(jnp.where(new_seg, cs - k32, jnp.int32(0)))
    end = jax.lax.cummin(
        jnp.where(is_end, cs, jnp.int32(np.iinfo(np.int32).max)), reverse=True
    )
    count_here = end - base
    kept = kept & (count_here >= min_multi)

    # reference = first kept entry of the segment (count re-masking drops
    # whole segments at once, so the first pre-mask kept entry survives
    # whenever its segment does); its (pos, strand) reach every kept entry
    # via a forward carry (all kept entries sit at/after their rep)
    is_rep = kept & (cs == base + 1)
    ref_pos, ref_strand = _carry_last2(pos_s, strand_s, is_rep)
    rel = strand_s ^ ref_strand
    inv = jnp.where(rel == 0, pos_s.astype(jnp.int64) - ref_pos, pos_s.astype(jnp.int64) + ref_pos)

    token = (seq_s.astype(jnp.int64) << 33) | (rel.astype(jnp.int64) << 32) | (
        inv & jnp.int64(0xFFFFFFFF)
    )
    m1 = _mix64(_mix64(token + 1, _MIX_C1) ^ _mix64(token + 7, _MIX_C2), _MIX_C3)

    # order-independent segment signature = segment sum of the member mixes
    # (wrapping int64): cumsum with carry-filled segment boundaries (the
    # hash sums are not monotone, so the fills are carry scans)
    contrib = jnp.where(kept, m1, jnp.int64(0))
    cs64 = jnp.cumsum(contrib)
    base64 = _carry_last2(cs64 - contrib, None, new_seg)
    end64 = _carry_last2(cs64, None, is_end, reverse=True)
    rep_sig1 = (end64 - base64) + count_here.astype(jnp.int64) * _MIX_C3
    signed_pos = jnp.where(rel == 0, pos_s + 1, -(pos_s + 1))
    return seg_id, kept, is_rep, rep_sig1, seq_s, pos_s, signed_pos, ref_pos


@partial(jax.jit, static_argnames=("n_seqs", "cap", "min_multi", "pack_sort"))
def device_mum_candidates(
    keys: jnp.ndarray,      # int64[N] canonical keys (strand LSB); INVALID padding
    seq_ids: jnp.ndarray,   # int32[N]
    positions: jnp.ndarray, # int32[N] 0-based window starts
    seq_mask: jnp.ndarray,  # int32[n_seqs] 1 = genome participates
    n_seqs: int,
    cap: int,
    min_multi: int = 2,
    pack_sort: bool = False,  # positions < 2^23 and n_seqs < 128 (caller-checked)
):
    """Unique multi-MUM candidate runs, fully on device.

    Returns (packed int32[cap, n_seqs + 2], n_runs int32): columns
    0..n_seqs-1 are signed 1-based window starts at the run's FIRST window
    (0 = absent), the last two columns are [p0_min, p0_max] reference
    window positions.
    """
    assert min_multi >= 2, "representative compaction requires min_multi >= 2"
    N = keys.shape[0]
    (seg_id, kept, is_rep, rep_sig1, seq_s, pos_s, signed_pos, _) = _sig_phase(
        keys, seq_ids, positions, seq_mask, n_seqs, min_multi, pack_sort
    )

    # group representatives by (signature, p0): sort the FULL entry array
    # with a reps-first leading key.  (A scatter-compaction into an N/2
    # buffer followed by a half-size sort costs far more than the extra
    # sort passes — scatters are ~10x a sort pass on this backend.)
    nv = (~is_rep).astype(jnp.int32)
    hb = jnp.where(is_rep, (rep_sig1 >> 32).astype(jnp.int32), 0)
    lb = jnp.where(is_rep, rep_sig1.astype(jnp.int32), 0)
    pb = jnp.where(is_rep, pos_s, 0)
    sb = jnp.where(is_rep, seg_id, 0)
    (nv_s, a_s, b_s, p0_s, segid_s) = jax.lax.sort(
        (nv, hb, lb, pb, sb), num_keys=4
    )
    rep_valid = nv_s == 0
    prev_same_sig = (
        (a_s == jnp.concatenate([a_s[:1], a_s[:-1]]))
        & (b_s == jnp.concatenate([b_s[:1], b_s[:-1]]))
    )
    prev_p0 = jnp.concatenate([p0_s[:1] - 2, p0_s[:-1]])
    cont = prev_same_sig & (p0_s == prev_p0 + 1)
    cont = cont.at[0].set(False)
    run_start = rep_valid & ~cont
    run_id = jnp.cumsum(run_start.astype(jnp.int32)) - 1
    n_runs = jnp.sum(run_start.astype(jnp.int32))

    run_end = rep_valid & jnp.concatenate([~cont[1:], jnp.ones(1, bool)])
    row = jnp.where(rep_valid & (run_id < cap), run_id, cap)
    span_tab = jnp.full((cap + 1, 2), -1, jnp.int32)
    span_tab = span_tab.at[jnp.where(run_start, row, cap), 0].set(p0_s, mode="drop")
    span_tab = span_tab.at[jnp.where(run_end, row, cap), 1].set(p0_s, mode="drop")

    # map run-first segments -> run row, then scatter their kept components
    seg_runfirst_row = jnp.full(N + 1, cap, jnp.int32)
    seg_runfirst_row = seg_runfirst_row.at[
        jnp.where(run_start, segid_s, N)
    ].set(jnp.where(run_start, row, cap), mode="drop")
    comp_row = seg_runfirst_row[jnp.clip(seg_id, 0, N - 1)]
    comp_row = jnp.where(kept, comp_row, cap)
    comp_tab = jnp.zeros((cap + 1, n_seqs), jnp.int32)
    comp_tab = comp_tab.at[comp_row, jnp.clip(seq_s, 0, n_seqs - 1)].set(
        signed_pos, mode="drop"
    )
    # pack comp and span side by side, with n_runs in an extra leading row:
    # the caller downloads ONE row-sliced buffer (each blocking transfer
    # is a device round trip, including the n_runs scalar sync)
    packed = jnp.concatenate([comp_tab[:cap], span_tab[:cap]], axis=1)
    head = jnp.zeros((1, n_seqs + 2), jnp.int32).at[0, 0].set(n_runs.astype(jnp.int32))
    return jnp.concatenate([head, packed], axis=0)


@partial(jax.jit, static_argnames=("n_seqs", "cap"))
def mum_runs_from_sig_entries(
    sig: jnp.ndarray,    # int64[N] group signature (incl. multiplicity)
    p0: jnp.ndarray,     # int32[N] group reference window position
    seq: jnp.ndarray,    # int32[N] (-1 = padding)
    spos: jnp.ndarray,   # int32[N] signed 1-based window position
    n_seqs: int,
    cap: int,
):
    """Run-merging half of the candidate kernel for entries in ARBITRARY
    order (the distributed path: entries arrive via an all-to-all keyed by
    hash(signature), so all windows of one diagonal run land on one device
    but interleaved).  Entries of one seed group share (sig, p0).  Returns
    the same packed [cap+1, n_seqs+2] table as device_mum_candidates.
    """
    N = sig.shape[0]
    valid = seq >= 0
    hi = (sig >> 32).astype(jnp.int32)
    lo = sig.astype(jnp.int32)  # bit pattern; equality-grouping only
    inv_key = (~valid).astype(jnp.int32)  # invalid entries sort to the tail
    (inv_s, hi_s, lo_s, p0_s, seq_s, spos_s) = jax.lax.sort(
        (inv_key, hi, lo, p0, seq, spos), num_keys=4
    )
    valid_s = inv_s == 0
    prev_same = (
        (hi_s == jnp.concatenate([hi_s[:1], hi_s[:-1]]))
        & (lo_s == jnp.concatenate([lo_s[:1], lo_s[:-1]]))
        & (p0_s == jnp.concatenate([p0_s[:1], p0_s[:-1]]))
    )
    new_seg = valid_s & (~prev_same | (jnp.arange(N, dtype=jnp.int32) == 0))
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1

    # per-seg signature/p0 via the segment's first entry
    seg_first = jnp.full(N, N - 1, jnp.int32).at[seg_id].min(
        jnp.where(valid_s, jnp.arange(N, dtype=jnp.int32), N - 1)
    )
    n_segs = jnp.sum(new_seg.astype(jnp.int32))
    seg_iota = jnp.arange(N, dtype=jnp.int32)
    seg_valid = seg_iota < n_segs
    sf = jnp.clip(seg_first, 0, N - 1)
    s_hi, s_lo, s_p0 = hi_s[sf], lo_s[sf], p0_s[sf]
    prev_seg_same_sig = (
        (s_hi == jnp.concatenate([s_hi[:1], s_hi[:-1]]))
        & (s_lo == jnp.concatenate([s_lo[:1], s_lo[:-1]]))
    )
    prev_seg_p0 = jnp.concatenate([s_p0[:1] - 2, s_p0[:-1]])
    cont = seg_valid & prev_seg_same_sig & (s_p0 == prev_seg_p0 + 1)
    cont = cont.at[0].set(False)
    run_start = seg_valid & ~cont
    run_id = jnp.cumsum(run_start.astype(jnp.int32)) - 1
    n_runs = jnp.sum(run_start.astype(jnp.int32))
    run_end = seg_valid & jnp.concatenate([~cont[1:], jnp.ones(1, bool)])
    row_of_seg = jnp.where(seg_valid & (run_id < cap), run_id, cap)
    span_tab = jnp.full((cap + 1, 2), -1, jnp.int32)
    span_tab = span_tab.at[jnp.where(run_start, row_of_seg, cap), 0].set(
        s_p0, mode="drop"
    )
    span_tab = span_tab.at[jnp.where(run_end, row_of_seg, cap), 1].set(
        s_p0, mode="drop"
    )
    # components of run-FIRST segments scatter into the comp table
    comp_row_of_seg = jnp.where(run_start, row_of_seg, cap)
    comp_row = comp_row_of_seg[jnp.clip(seg_id, 0, N - 1)]
    comp_row = jnp.where(valid_s, comp_row, cap)
    comp_tab = jnp.zeros((cap + 1, n_seqs), jnp.int32)
    comp_tab = comp_tab.at[comp_row, jnp.clip(seq_s, 0, n_seqs - 1)].set(
        spos_s, mode="drop"
    )
    packed = jnp.concatenate([comp_tab[:cap], span_tab[:cap]], axis=1)
    head = jnp.zeros((1, n_seqs + 2), jnp.int32).at[0, 0].set(n_runs.astype(jnp.int32))
    return jnp.concatenate([head, packed], axis=0)


@partial(jax.jit, static_argnames=("bucket",))
def _concat_pad_smls_jit(keys_list, pos_list, bucket):
    """One fused device program for the concat+pad instead of ~10 eager
    dispatches per call."""
    keys = jnp.concatenate(list(keys_list))
    pos = jnp.concatenate(list(pos_list))
    seq_ids = jnp.concatenate(
        [jnp.full(k.shape[0], i, jnp.int32) for i, k in enumerate(keys_list)]
    )
    pad = bucket - keys.shape[0]
    if pad:
        keys = jnp.concatenate([keys, jnp.full(pad, INVALID_KEY, jnp.int64)])
        pos = jnp.concatenate([pos, jnp.zeros(pad, jnp.int32)])
        seq_ids = jnp.concatenate([seq_ids, jnp.zeros(pad, jnp.int32)])
    return keys, seq_ids, pos


def _concat_device_smls(smls_dev):
    """Concatenate per-genome device SML arrays with padding to a bucket.

    Coarse buckets at small sizes (every distinct shape costs a compile)
    tightening to x1.5 steps at genome scale where sort cost tracks the
    PADDED size — see merops.bucket_size."""
    n = sum(int(k.shape[0]) for k, _ in smls_dev)
    bucket = merops.bucket_size(n)
    return _concat_pad_smls_jit(
        tuple(k for k, _ in smls_dev), tuple(p for _, p in smls_dev), bucket
    )


@partial(jax.jit, static_argnames=("out_n", "mod"))
def _sketch_compact(keys, seq_ids, positions, out_n, mod):
    """Keep entries whose strand-free mer hashes to 0 mod `mod` and compact
    them into a buffer of static size out_n (overflow drops, caller sizes
    generously).  One elementwise pass + prefix sum — no sort — so a
    sketched search pays ~1/mod of the full sort cost."""
    mer = keys >> 1
    h = _mix64(mer + 11, _MIX_C2)
    keep = (keys != INVALID_KEY) & (h % jnp.int64(mod) == 0)
    rank = jnp.cumsum(keep.astype(jnp.int32)) - 1
    addr = jnp.where(keep & (rank < out_n), rank, out_n)
    k2 = jnp.full(out_n, INVALID_KEY, jnp.int64).at[addr].set(keys, mode="drop")
    s2 = jnp.zeros(out_n, jnp.int32).at[addr].set(seq_ids, mode="drop")
    p2 = jnp.zeros(out_n, jnp.int32).at[addr].set(positions, mode="drop")
    return k2, s2, p2


def find_multi_mums_device(
    genomes: Sequence[Genome],
    smls_dev,
    min_multi: int = 2,
    nway: bool = False,
    seq_mask: Optional[np.ndarray] = None,
    extend: bool = True,
    seed_length: int = 0,
    initial_cap: Optional[int] = None,
    sketch_mod: int = 1,
) -> MatchList:
    """Device-resident unique multi-MUM search.

    smls_dev: list of (keys int64 device array, positions int32 device array)
    per genome; order does NOT matter (the kernel globally sorts), so the
    sort-free core.sml.build_mer_list_device is the cheapest producer.

    On repeat-dense input the run count can exceed the capacity heuristic;
    the search then auto-retries with the cap raised to the next power of
    two covering the actual count (never truncates).  initial_cap overrides
    the heuristic (tests exercise the retry with a tiny cap).

    sketch_mod > 1 subsamples the mer space by hash (1/mod of the windows
    enter the sort) — a MinHash-style sketch for distance estimation and
    coverage gating.  Base-level extension still grows each sampled seed to
    its full maximal match, so long matches keep their true lengths; only
    matches spanning fewer than ~mod seed windows can be missed entirely.
    """
    from mauvealigner_tpu.utils import timing

    n_seqs = len(genomes)
    mask = np.ones(n_seqs, np.int32) if seq_mask is None else np.asarray(seq_mask, np.int32)
    keys, seq_ids, pos = _concat_device_smls(smls_dev)
    if sketch_mod > 1:
        out_n = merops.bucket_size(
            max(int(keys.shape[0]) // sketch_mod * 5 // 4, 1 << 12)
        )
        keys, seq_ids, pos = _sketch_compact(keys, seq_ids, pos, out_n, sketch_mod)
    N = keys.shape[0]
    timing.GLOBAL.add("k2_sort_entries", float(N))
    cap = initial_cap if initial_cap is not None else max(1 << 14, N >> 3)
    # positions are iotas over each genome's padded window count, so the
    # packed one-lane (seq, pos, strand) sort is safe whenever every
    # per-genome SML fits 23 position bits (static: shapes only)
    pack_ok = n_seqs < 128 and all(
        int(k.shape[0]) <= (1 << 23) for k, _ in smls_dev
    )
    ml = _candidates_with_retry(
        keys, seq_ids, pos, mask, n_seqs, cap, min_multi, pack_ok, seed_length
    )
    if extend and len(ml):
        import time as _time

        from mauvealigner_tpu.utils import timing as _timing

        _t0 = _time.perf_counter()
        ml = extend_matches_maximal(ml, [g.codes for g in genomes])
        _timing.GLOBAL.add("k2_extend_s", _time.perf_counter() - _t0)
    if nway:
        ml = ml.multiplicity_filter(n_seqs)
    return ml


def _head_rows(N: int, cap: int, n_seqs: int) -> int:
    """Initial download size for a candidate table: genome-scale inputs
    produce run counts ~N/27 (measured 77k runs at N=2M pairwise), so a
    head sized at N>>4 rows (capped at ~2 MB of wire) usually covers the
    whole result in ONE transfer — the old fixed 4k-row head paid a second
    fetch + round trip on every real-scale search."""
    target = max(1 + (1 << 12), (N >> 4) + 1)
    by_bytes = (2 << 20) // (4 * (n_seqs + 2)) + 1
    return min(cap + 1, target, by_bytes)


def _candidates_with_retry(
    keys, seq_ids, pos, mask, n_seqs, cap, min_multi, pack_ok, seed_length
) -> MatchList:
    """Run device_mum_candidates, auto-doubling cap on overflow, and decode."""
    import time as _time

    from mauvealigner_tpu.utils import timing as _timing

    N = int(keys.shape[0])
    while True:
        _t0 = _time.perf_counter()
        packed_tab = device_mum_candidates(
            keys, seq_ids, pos, jnp.asarray(mask), n_seqs, cap, min_multi,
            pack_sort=pack_ok,
        )
        _timing.GLOBAL.add("k2_dispatch_s", _time.perf_counter() - _t0)
        # sized so the common case needs no second fetch (row 0 holds n_runs)
        first = _head_rows(N, cap, n_seqs)
        _t0 = _time.perf_counter()
        if first * 4 * (n_seqs + 2) > (1 << 20):
            # genome-scale search: the speculative head would both overshoot
            # AND still need a second fetch when n_runs exceeds it (at
            # 4.6 Mbp: a 2 MB head + 5.5 MB refetch per node merge).  Fetch
            # the exact count first (one round trip), then exactly n_runs
            # rows once.
            n_runs = int(np.asarray(packed_tab[:1])[0, 0])
            first = min(cap + 1, n_runs + 1)
            head = np.asarray(packed_tab[:first])
        else:
            head = np.asarray(packed_tab[:first])
            n_runs = int(head[0, 0])
        _timing.GLOBAL.add("k2_fetch_s", _time.perf_counter() - _t0)
        if n_runs <= cap:
            break
        # capacity overflow (repeat-dense input): double to the covering
        # power of two and re-run — a warn-and-truncate here would silently
        # drop anchors on IS-element-dense genomes
        cap = 1 << int(n_runs - 1).bit_length()
    return decode_mum_table(
        head,
        n_seqs,
        cap,
        seed_length,
        fetch=lambda rb: np.asarray(packed_tab[:rb]),
    )


def decode_mum_table(
    head: np.ndarray,
    n_seqs: int,
    cap: int,
    seed_length: int,
    fetch=None,
) -> MatchList:
    """Decode a device_mum_candidates packed table (host side).

    `head` holds at least the leading rows ([n_runs row] + runs); when the
    run count exceeds the rows on hand, `fetch(n_rows)` downloads a taller
    slice (None = `head` is the full table)."""
    r = int(head[0, 0])
    if r == 0:
        return MatchList.empty(n_seqs)
    if r > cap:
        import warnings

        warnings.warn(
            f"multi-MUM run capacity overflow: {r} runs > cap {cap}; "
            "result truncated (raise cap for highly repetitive inputs)"
        )
        r = cap
    if r <= head.shape[0] - 1:
        packed = head[1 : r + 1]
    elif fetch is None:
        import warnings

        warnings.warn(
            f"decode_mum_table: {r} runs but only {head.shape[0] - 1} rows "
            "on hand and no fetch callback; result truncated"
        )
        packed = head[1:]
    else:
        rb = min((1 << max(4, (r - 1).bit_length())) + 1, cap + 1)
        packed = fetch(rb)[1 : r + 1]
    comp, span = packed[:, :n_seqs], packed[:, n_seqs:]
    ok = (span[:, 0] >= 0) & (span[:, 1] >= span[:, 0])
    comp, span = comp[ok], span[ok]
    run_len = span[:, 1] - span[:, 0]
    lengths = run_len + seed_length
    # rev comps stored at the run-first window slide left by run_len
    starts = comp.astype(np.int64)
    rev = starts < 0
    starts[rev] = starts[rev] + run_len[np.nonzero(rev)[0]]
    return MatchList(starts, lengths.astype(np.int64))


@dataclasses.dataclass
class SeedGroups:
    """Sorted seed-group representation (ragged, host side)."""

    mer: np.ndarray       # int64 [N] sorted strand-free mers
    seq: np.ndarray       # int32 [N]
    pos: np.ndarray       # int32 [N] 0-based window starts
    strand: np.ndarray    # int32 [N] canonical-strand bit per window
    seg_id: np.ndarray    # int64 [N] group index
    occ_unique: np.ndarray  # bool [N] occurrence is unique within its genome
    n_segs: int


def build_seed_groups(smls: Sequence[SortedMerList]) -> SeedGroups:
    mer, seq, pos, strand = _device_sorted_entries(smls)
    n = len(mer)
    if n == 0:
        return SeedGroups(mer, seq, pos, strand, np.zeros(0, np.int64), np.zeros(0, bool), 0)
    new_seg = np.empty(n, dtype=bool)
    new_seg[0] = True
    np.not_equal(mer[1:], mer[:-1], out=new_seg[1:])
    seg_id = np.cumsum(new_seg) - 1
    same_ms = np.zeros(n, dtype=bool)
    same_ms[1:] = (~new_seg[1:]) & (seq[1:] == seq[:-1])
    occ_unique = ~same_ms
    occ_unique[:-1] &= ~same_ms[1:]
    return SeedGroups(mer, seq, pos, strand, seg_id, occ_unique, int(seg_id[-1]) + 1)


def seed_matches_from_groups(
    groups: SeedGroups,
    n_seqs: int,
    seed_length: int,
    unique: bool = True,
    min_multi: int = 2,
    max_multi: Optional[int] = None,
    seq_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build dense seed-match rows from seed groups.

    unique=True reproduces unique-MUM semantics: a genome participates in a
    group's match only if its occurrence count in the group is exactly one
    (UniqueMatchFinder, src/UniqueMatchFinder.cpp:36-60).  Groups with fewer
    than min_multi participating genomes are dropped; max_multi bounds
    repeat-mode multiplicity (rmin/rmax of SeedMatchEnumerator::FindMatches,
    src/SeedMatchEnumerator.h:19-23).

    Returns (pos0 int64 [m, n_seqs] 0-based leftmost window starts with -1
    for absent, rel_strand int8 [m, n_seqs], ref_seq int32 [m]) for
    unique mode.  Repeat mode is handled by repeat_matches_from_groups.
    """
    if not unique:
        raise ValueError("use repeat_matches_from_groups for repeat mode")
    g = groups
    comp = g.occ_unique.copy()
    if seq_mask is not None:
        comp &= np.asarray(seq_mask, dtype=bool)[g.seq]
    counts = np.bincount(g.seg_id[comp], minlength=g.n_segs)
    ok_seg = counts >= min_multi
    if max_multi is not None:
        ok_seg &= counts <= max_multi
    keep = comp & ok_seg[g.seg_id]
    if not keep.any():
        return (
            np.full((0, n_seqs), -1, np.int64),
            np.zeros((0, n_seqs), np.int8),
            np.zeros(0, np.int32),
        )
    seg_sel = np.unique(g.seg_id[keep])
    remap = np.full(g.n_segs, -1, np.int64)
    remap[seg_sel] = np.arange(len(seg_sel))
    rows = remap[g.seg_id[keep]]
    cols = g.seq[keep]
    m = len(seg_sel)
    pos0 = np.full((m, n_seqs), -1, np.int64)
    strand = np.zeros((m, n_seqs), np.int8)
    pos0[rows, cols] = g.pos[keep]
    strand[rows, cols] = g.strand[keep]
    # reference component: first participating genome; rel strand via parity
    present = pos0 >= 0
    ref_seq = np.argmax(present, axis=1).astype(np.int32)
    ref_strand = strand[np.arange(m), ref_seq]
    rel_strand = np.where(present, strand ^ ref_strand[:, None], 0).astype(np.int8)
    return pos0, rel_strand, ref_seq


def merge_collinear_runs(
    pos0: np.ndarray, rel_strand: np.ndarray, ref_seq: np.ndarray, seed_length: int
) -> MatchList:
    """Merge diagonal-consistent consecutive seed windows into single matches.

    Every window fully inside a maximal match produces its own seed group;
    consecutive reference positions with identical component structure
    (same genomes, same relative strands, same diagonal invariants) belong
    to the same match.  The diagonal invariant of component j at reference
    window position p0 is pos_j - p0 for relatively-forward components and
    pos_j + p0 for relatively-reverse ones (whose window slides left as the
    reference window slides right).
    """
    m, n_seqs = pos0.shape
    if m == 0:
        return MatchList.empty(n_seqs)
    present = pos0 >= 0
    p0 = pos0[np.arange(m), ref_seq].astype(np.int64)
    inv = np.where(
        present,
        np.where(rel_strand == 0, pos0 - p0[:, None], pos0 + p0[:, None]),
        _INT64_MAX,
    )
    sig_strand = np.where(present, rel_strand, -1)
    # lexsort: LAST key is primary — p0 goes first (least significant) so
    # rows order by the signature columns, then p0 within a signature.
    # (Reversing this list makes p0 primary and splits any two runs whose
    # reference windows interleave into per-window fragments.)
    sort_keys = [p0]
    for j in range(n_seqs - 1, -1, -1):
        sort_keys.append(sig_strand[:, j])
        sort_keys.append(inv[:, j])
    order = np.lexsort(sort_keys)
    inv_s, strand_s, p0_s = inv[order], sig_strand[order], p0[order]
    same_sig = np.all(inv_s[1:] == inv_s[:-1], axis=1) & np.all(
        strand_s[1:] == strand_s[:-1], axis=1
    )
    run_continue = same_sig & (p0_s[1:] == p0_s[:-1] + 1)
    run_start = np.concatenate([[True], ~run_continue])
    first_idx = np.nonzero(run_start)[0]
    run_len = np.diff(np.concatenate([first_idx, [m]]))
    p0_min = p0_s[first_idx]
    p0_max = p0_min + run_len - 1
    inv_r = inv_s[first_idx]
    strand_r = strand_s[first_idx]
    lengths = (p0_max - p0_min) + seed_length
    present_r = strand_r >= 0
    left0 = np.where(
        strand_r == 0,
        inv_r + p0_min[:, None],
        inv_r - p0_max[:, None],
    )
    starts = np.where(
        present_r,
        np.where(strand_r == 0, left0 + 1, -(left0 + 1)),
        NO_MATCH,
    )
    return MatchList(starts, lengths)


def extend_matches_maximal(
    match_list: MatchList, genome_codes: Sequence[np.ndarray], chunk: int = 64,
    dedup: bool = True,
) -> MatchList:
    """Extend every match to base-level maximality and deduplicate.

    Mirrors MemHash's seed extension: grow left/right in match space while
    every participating genome agrees on the next column's base (ambiguity
    codes never match).  Vectorized host pass over all matches at once,
    `chunk` columns per iteration.  With ``dedup=False`` the output keeps a
    1:1 row correspondence with the input (callers that carry per-match
    metadata deduplicate themselves).
    """
    if len(match_list) == 0:
        return match_list
    starts = match_list.starts.copy()
    lengths = match_list.lengths.copy()
    n, n_seqs = starts.shape
    # native host runtime fast path (C++; see native/mauve_native.cpp)
    from mauvealigner_tpu import native

    mod = native.get()
    if mod is not None:
        codes_bytes = [np.ascontiguousarray(c, dtype=np.uint8).tobytes() for c in genome_codes]
        s_out, l_out = mod.extend_matches(
            codes_bytes,
            np.ascontiguousarray(starts, dtype=np.int64).tobytes(),
            np.ascontiguousarray(lengths, dtype=np.int64).tobytes(),
            n,
            n_seqs,
        )
        starts = np.frombuffer(s_out, np.int64).reshape(n, n_seqs).copy()
        lengths = np.frombuffer(l_out, np.int64).copy()
        out = MatchList(starts, lengths)
        return out.dedup() if dedup else out
    seq_lens = np.array([len(c) for c in genome_codes], dtype=np.int64)

    def gather_col(offsets_from_end: np.ndarray, side: str) -> np.ndarray:
        """Base value per (match, seq) at `offsets_from_end` columns beyond
        the current match boundary; 255 = out of bounds / absent."""
        vals = np.full((n, n_seqs), 255, np.uint8)
        for j in range(n_seqs):
            s = starts[:, j]
            pres = s != NO_MATCH
            fwd = s > 0
            left0 = np.abs(s) - 1
            if side == "right":
                # match-space right: fwd reads left0+len-1+d; rev reads left0-d
                idx = np.where(fwd, left0 + lengths - 1 + offsets_from_end, left0 - offsets_from_end)
            else:
                # match-space left: fwd reads left0-d; rev reads left0+len-1+d
                idx = np.where(fwd, left0 - offsets_from_end, left0 + lengths - 1 + offsets_from_end)
            ok = pres & (idx >= 0) & (idx < seq_lens[j])
            v = np.full(n, 255, np.uint8)
            codes_j = genome_codes[j]
            v[ok] = codes_j[idx[ok]]
            flip = ok & ~fwd
            v[flip & (v < 4)] = 3 - v[flip & (v < 4)]
            vals[:, j] = v
        return vals

    for side in ("right", "left"):
        active = np.ones(n, dtype=bool)
        guard = 0
        while active.any() and guard < 10**6:
            guard += 1
            ext = np.zeros(n, dtype=np.int64)
            full = np.zeros(n, dtype=bool)
            # agreement run length within the next `chunk` columns
            agree_so_far = active.copy()
            for d in range(1, chunk + 1):
                col = gather_col(np.full(n, d, np.int64), side)
                pres = starts != NO_MATCH
                ref = col[np.arange(n), np.argmax(pres, axis=1)]
                match_col = (
                    (ref < 4)
                    & np.all((col == ref[:, None]) | ~pres, axis=1)
                )
                agree_so_far &= match_col
                ext = np.where(agree_so_far, d, ext)
                full = agree_so_far & (d == chunk)
                if not agree_so_far.any():
                    break
            grow = ext > 0
            if grow.any():
                fwd = starts > 0
                rev = starts < 0
                ext_b = np.broadcast_to(ext[:, None], starts.shape)
                if side == "right":
                    # reverse comps grow leftward in genome coords: |start|
                    # decreases, i.e. the negative start moves toward zero
                    sel = rev & grow[:, None]
                    starts[sel] += ext_b[sel]
                else:
                    sel = fwd & grow[:, None]
                    starts[sel] -= ext_b[sel]
                lengths += ext
            active = full
    out = MatchList(starts, lengths)
    return out.dedup() if dedup else out


def find_multi_mums(
    genomes: Sequence[Genome],
    smls: Sequence[SortedMerList],
    min_multi: int = 2,
    max_multi: Optional[int] = None,
    nway: bool = False,
    seq_mask: Optional[np.ndarray] = None,
    extend: bool = True,
) -> MatchList:
    """End-to-end unique multi-MUM search (the MaskedMemHash /
    UniqueMatchFinder pipeline, src/mauveAligner.cpp:523-590)."""
    seed_length = smls[0].seed_length if smls else 0
    groups = build_seed_groups(smls)
    pos0, rel_strand, ref_seq = seed_matches_from_groups(
        groups,
        n_seqs=len(genomes),
        seed_length=seed_length,
        unique=True,
        min_multi=min_multi,
        max_multi=max_multi,
        seq_mask=seq_mask,
    )
    ml = merge_collinear_runs(pos0, rel_strand, ref_seq, seed_length)
    if extend and len(ml):
        ml = extend_matches_maximal(ml, [g.codes for g in genomes])
    if nway:
        ml = ml.multiplicity_filter(len(genomes))
    return ml


def repeat_matches_from_groups(
    groups: SeedGroups,
    seed_length: int,
    min_multi: int = 2,
    max_multi: int = 1000,
    only_direct: bool = False,
) -> MatchList:
    """Seed matches for repeat finding: every occurrence participates
    (RepeatHash / SeedMatchEnumerator semantics, src/SeedMatchEnumerator.h:59-141,
    incl. the only_direct projection to forward-strand components).

    Single-genome oriented but supports multi-genome input; components are
    laid out in a dense [m, max_multi] table per match (the repeat data model
    keeps components of one match in one genome).
    """
    g = groups
    if len(g.mer) == 0:
        return MatchList.empty(1)
    counts = np.bincount(g.seg_id, minlength=g.n_segs)
    ok = (counts >= min_multi) & (counts <= max_multi)
    keep = ok[g.seg_id]
    if not keep.any():
        return MatchList.empty(int(counts.max(initial=1)))
    seg = g.seg_id[keep]
    pos = g.pos[keep].astype(np.int64)
    strand = g.strand[keep]
    seg_sel, seg_start = np.unique(seg, return_index=True)
    m = len(seg_sel)
    remap = np.full(g.n_segs, -1, np.int64)
    remap[seg_sel] = np.arange(m)
    rows = remap[seg]
    ref_strand = strand[seg_start[rows]]
    rel = strand ^ ref_strand
    signed = np.where(rel == 0, pos + 1, -(pos + 1))
    if only_direct:
        # project to forward-strand components only (only_direct semantics,
        # src/SeedMatchEnumerator.h:88-117)
        keep_comp = rel == 0
        rows, signed = rows[keep_comp], signed[keep_comp]
    # left-compact components into dense columns per row
    if len(rows):
        order = np.argsort(rows, kind="stable")
        rows, signed = rows[order], signed[order]
        row_first = np.zeros(len(rows), np.int64)
        is_first = np.concatenate([[True], rows[1:] != rows[:-1]])
        idx_first = np.nonzero(is_first)[0]
        row_first[idx_first] = idx_first
        np.maximum.accumulate(row_first, out=row_first)
        cols = np.arange(len(rows)) - row_first
        width = int(cols.max()) + 1
    else:
        cols = rows
        width = 1
    starts = np.zeros((m, max(width, 1)), np.int64)
    starts[rows, cols] = signed
    lengths = np.full(m, seed_length, np.int64)
    ml = MatchList(starts, lengths)
    return ml.select(ml.multiplicity() >= min_multi)


# ---------------------------------------------------------------------------
# Batched multi-gap recursion search.  The reference re-runs its match finder
# once per inter-anchor gap (Aligner recursion, SetMinRecursionGapLength,
# src/mauveAligner.cpp:670-672,899); a per-gap device call serializes
# hundreds of launches and transfers.  Instead, ALL gaps
# of a recursion round are searched in ONE device program:
#
#   * every gap's per-genome regions are extracted ON DEVICE from the
#     resident full-genome code arrays (no region uploads), laid out
#     back-to-back in a flat coordinate space with one CODE_N separator
#     after each region — separators make boundary-crossing seed windows
#     invalid AND stop base-level extension at region edges;
#   * each window's canonical mer key is tagged with its gap id ABOVE the
#     mer bits, so the global sort groups (gap, mer) — per-gap uniqueness
#     and grouping semantics fall out of one sort over all gaps;
#   * the standard candidate kernel runs unchanged on the tagged entries;
#     runs can never span gaps (the tag differs), and decoded flat
#     coordinates map back to (gap, genome, strand, position) on host.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("offsets", "pattern_len", "tag_shift", "F", "n_seqs"))
def _gap_flat_mer_entries(
    codes_flat: jnp.ndarray,  # int32 [n_seqs * cpad] resident genome codes
    specs: jnp.ndarray,       # int32 [R, 5] (left0, len, strand, seq, gap)
    offsets: Tuple[int, ...],
    pattern_len: int,
    tag_shift: int,
    F: int,
    n_seqs: int,
):
    """Flat multi-gap window extraction + mer packing + gap tagging.

    Region r occupies flat slots [fs[r], fs[r] + len_r) followed by one
    CODE_N separator slot; reverse-strand regions are extracted
    reverse-complemented so every flat region reads relatively forward.
    Returns (tagged keys int64[F - L + 1], seq_ids int32, flat positions
    int32) ready for device_mum_candidates.
    """
    from mauvealigner_tpu.genome.sequence import CODE_N

    cpad = codes_flat.shape[0] // n_seqs
    R = specs.shape[0]
    left0, ln, strand, seq, gap = (specs[:, c] for c in range(5))
    fs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(ln + 1, dtype=jnp.int32)]
    )
    T = fs[R]
    f = jax.lax.broadcasted_iota(jnp.int32, (F, 1), 0).reshape(F)
    row = jnp.clip(
        jnp.searchsorted(fs, f, side="right").astype(jnp.int32) - 1, 0, R - 1
    )
    within = f - fs[row]
    pad_cell = (within >= ln[row]) | (f >= T)
    idx = left0[row] + jnp.where(strand[row] > 0, within, ln[row] - 1 - within)
    idx = jnp.clip(idx, 0, cpad - 1)
    base = codes_flat[seq[row] * cpad + idx]
    base = jnp.where(
        strand[row] > 0, base, jnp.where(base < CODE_N, 3 - base, base)
    )
    base = jnp.where(pad_cell, CODE_N, base).astype(jnp.int32)
    keys = merops.pack_canonical_mers(base, offsets, pattern_len)
    npos = keys.shape[0]
    # spaced seeds have don't-care slots: a window can straddle the CODE_N
    # separator without reading it, mixing content from two regions.  Any
    # window whose first and last cells fall in different rows is invalid.
    end_row = row[jnp.arange(npos, dtype=jnp.int32) + jnp.int32(pattern_len - 1)]
    keys = jnp.where(end_row != row[:npos], INVALID_KEY, keys)
    gid = gap[row[:npos]].astype(jnp.int64)
    keys = jnp.where(
        keys == INVALID_KEY, INVALID_KEY, keys | (gid << tag_shift)
    )
    return keys, seq[row[:npos]].astype(jnp.int32), f[:npos]


def _gap_spec_rows(gap_specs: np.ndarray, n_seqs: int) -> Tuple[np.ndarray, np.ndarray]:
    """[G, n, 3] (left, right, strand) 1-based inclusive -> flat spec rows
    [R, 5] int32 (left0, len, strand, seq, gap) and the host fs offsets."""
    G = gap_specs.shape[0]
    left = gap_specs[:, :, 0]
    right = gap_specs[:, :, 1]
    strand = gap_specs[:, :, 2]
    ln = np.maximum(0, right - left + 1)
    R = G * n_seqs
    rows = np.zeros((R, 5), np.int32)
    rows[:, 0] = np.maximum(0, left - 1).reshape(-1)
    rows[:, 1] = ln.reshape(-1)
    rows[:, 2] = np.where(strand.reshape(-1) == 0, 1, strand.reshape(-1))
    rows[:, 3] = np.tile(np.arange(n_seqs, dtype=np.int32), G)
    rows[:, 4] = np.repeat(np.arange(G, dtype=np.int32), n_seqs)
    fs = np.concatenate([[0], np.cumsum(rows[:, 1].astype(np.int64) + 1)])
    return rows, fs


def _stacked_codes_device(genomes: Sequence[Genome], pattern_len: int):
    """Per-genome resident code arrays stacked into one flat device array
    [n * cpad] (cached on the first genome for reuse across rounds)."""
    arrs = [merops.upload_codes_cached(g, pattern_len) for g in genomes]
    cpad = max(a.shape[0] for a in arrs)
    key = (tuple(id(g) for g in genomes), cpad)
    holder = genomes[0]
    cached = getattr(holder, "_flat_stack_cache", None)
    # the cache value holds strong references to the genomes so an id() in
    # the key can never belong to a freed-and-reallocated object
    if cached is not None and cached[0] == key:
        return cached[1], cpad
    from mauvealigner_tpu.genome.sequence import CODE_N

    parts = [
        a
        if a.shape[0] == cpad
        else jnp.concatenate([a, jnp.full(cpad - a.shape[0], CODE_N, a.dtype)])
        for a in arrs
    ]
    flat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    holder._flat_stack_cache = (key, flat, tuple(genomes))
    return flat, cpad


def _flat_codes_host(
    genomes: Sequence[Genome], rows: np.ndarray, fs: np.ndarray
) -> np.ndarray:
    """Host mirror of the flat region layout (for base-level extension)."""
    from mauvealigner_tpu.genome.sequence import CODE_N

    total = int(fs[-1])
    flat = np.full(total, CODE_N, np.uint8)
    for r in range(rows.shape[0]):
        l0, lnr, st, s, _ = (int(v) for v in rows[r])
        if lnr <= 0:
            continue
        seg = genomes[s].codes[l0 : l0 + lnr]
        if st < 0:
            seg = seg[::-1]
            seg = np.where(seg < CODE_N, 3 - seg, seg).astype(np.uint8)
        flat[fs[r] : fs[r] + lnr] = seg
    return flat


def find_gap_mums_batched(
    genomes: Sequence[Genome],
    gap_specs: np.ndarray,  # int64 [G, n, 3] (left, right, strand) 1-based
    seed,
    extend: bool = True,
) -> Tuple[np.ndarray, MatchList]:
    """Unique multi-MUM search over MANY inter-anchor gaps in one device
    program.  Returns (gap_ids int64[m], MatchList in GENOME coordinates);
    rows keep >= 2 components (callers apply their multiplicity policy).
    """
    from mauvealigner_tpu.utils import timing

    n = len(genomes)
    G = gap_specs.shape[0]
    if G == 0:
        return np.zeros(0, np.int64), MatchList.empty(n)
    w = seed.weight
    tag_shift = 2 * w + 1
    assert (G << tag_shift) < (1 << 62), "gap tag would overflow the key space"
    rows, fs = _gap_spec_rows(np.asarray(gap_specs, np.int64), n)
    # pad spec rows to a bucket (every distinct R is a compile)
    R = rows.shape[0]
    Rpad = 1 << max(8, (R - 1).bit_length())
    if Rpad != R:
        pad = np.zeros((Rpad - R, 5), np.int32)
        pad[:, 2] = 1
        pad[:, 4] = G  # tag padding rows past every real gap
        rows_dev = np.concatenate([rows, pad])
    else:
        rows_dev = rows
    total = int(fs[-1]) + (Rpad - R) + seed.length  # pad rows add 1 slot each
    F = merops.bucket_size(total)
    codes_flat, _ = _stacked_codes_device(genomes, seed.length)
    offsets = tuple(int(o) for o in seed.offsets)
    keys, seq_ids, pos = _gap_flat_mer_entries(
        codes_flat, jnp.asarray(rows_dev), offsets, seed.length, tag_shift, F, n
    )
    N = int(keys.shape[0])
    timing.GLOBAL.add("k2_sort_entries", float(N))
    mask = np.ones(n, np.int32)
    cap = max(1 << 14, N >> 3)
    pack_ok = n < 128 and F <= (1 << 23)
    import time as _time

    _t0 = _time.perf_counter()
    ml = _candidates_with_retry(
        keys, seq_ids, pos, mask, n, cap, 2, pack_ok, seed.length
    )
    timing.GLOBAL.add("recursion_kernel_s", _time.perf_counter() - _t0)
    if len(ml) == 0:
        return np.zeros(0, np.int64), MatchList.empty(n)
    if extend:
        _t0 = _time.perf_counter()
        flat_host = _flat_codes_host(genomes, rows, fs)
        ml = extend_matches_maximal(ml, [flat_host] * n)
        timing.GLOBAL.add("recursion_extend_s", _time.perf_counter() - _t0)
    # map flat coordinates back to (gap, genome coordinates)
    starts = ml.starts
    lengths = ml.lengths
    pres = starts != NO_MATCH
    flatpos = np.where(pres, np.abs(starts) - 1, 0)
    rowr = (
        np.searchsorted(fs, flatpos.reshape(-1), side="right") - 1
    ).reshape(starts.shape)
    specsm = rows[np.clip(rowr, 0, R - 1)]  # [m, n, 5]
    gapm = specsm[:, :, 4].astype(np.int64)
    seqm = specsm[:, :, 3]
    cols = np.broadcast_to(np.arange(n, dtype=np.int32), starts.shape)
    gap_ref = gapm[np.arange(len(ml)), np.argmax(pres, axis=1)]
    consistent = np.all(
        (~pres) | ((seqm == cols) & (gapm == gap_ref[:, None])), axis=1
    )
    l0 = specsm[:, :, 0].astype(np.int64)
    lnr = specsm[:, :, 1].astype(np.int64)
    st = specsm[:, :, 2].astype(np.int64)
    within = flatpos - fs[np.clip(rowr, 0, R - 1)]
    Lm = lengths[:, None]
    g_left0 = np.where(st > 0, l0 + within, l0 + lnr - within - Lm)
    g_fwd = np.where(st > 0, starts > 0, starts < 0)
    new_starts = np.where(g_fwd, g_left0 + 1, -(g_left0 + 1))
    new_starts[~pres] = NO_MATCH
    out = MatchList(new_starts[consistent], lengths[consistent])
    return gap_ref[consistent], out
