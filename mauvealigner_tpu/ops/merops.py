"""K1: spaced-mer packing, strand canonicalization, and device sort.

Replaces libMems SortedMerList/DNAFileSML construction
(reference call sites src/mauveAligner.cpp:365, src/progressiveMauve.cpp:447,
src/uniqueMerCount.cpp:30-39).

Semantics reproduced:
  * a mer is the concatenation of the 2-bit codes at the seed's care
    positions within an L-wide window;
  * each window is strand-canonicalized: the lexicographically smaller of
    (forward mer, reverse-complement mer) is stored, shifted left one bit,
    with the LSB set iff the reverse-complement orientation won — the
    ``GetMer(pos) & 0x1`` strand-bit contract of the reference
    (src/SeedMatchEnumerator.h:133).  This requires palindromic seed
    patterns (see seeds.py).
  * windows containing ambiguity codes at care positions are invalid and
    sorted to the tail (FileSML skips ambiguous mers).

For a palindromic pattern with care offsets o_0<...<o_{w-1} (length L,
o_{w-1-j} == L-1-o_j):
  fwd(i) = sum_j code[i+o_j] << 2(w-1-j)
  rc(i)  = sum_j (3 - code[i+o_j]) << 2j
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mauvealigner_tpu.genome.sequence import CODE_N

INVALID_KEY = np.int64(2**62)  # sorts after every valid key: valid keys use
# 2w+1 <= 61 bits (MAX_SEED_WEIGHT 30, seeds.py) — also the bound that keeps
# _global_sort's 31-bit hi/lo split in int32


def bucket_size(n: int, floor: int = 1 << 12) -> int:
    """Static-shape bucket for n elements: x4 steps up to 1M (compiles are
    expensive, waste is cheap at small sizes), x2 up to 4M, then x1.5 steps
    (4M, 6M, 8M, 12M, 16M, 24M, ...) — at enterobacteria scale the sort cost
    tracks the PADDED size, and a 4.6M-entry genome must not pad to 8M nor a
    9-genome concat of 42M entries to 128M."""
    b = floor
    while b < n:
        if b < (1 << 20):
            b *= 4
        elif b < (1 << 22):
            b *= 2
        elif b & (b - 1) == 0:  # power of two -> x1.5
            b = b * 3 // 2
        else:  # 3*2^k -> x4/3 back to a power of two
            b = b * 4 // 3
    return b


def pad_codes(codes: np.ndarray, pattern_len: int, pad_to_multiple: int = 1 << 16) -> np.ndarray:
    """Pad a host code array with CODE_N to a bucketed static length.

    Bucketing by powers of two of `pad_to_multiple` keeps XLA recompiles
    bounded while supporting arbitrary genome sizes.
    """
    n = len(codes) + pattern_len  # ensure full final windows are representable
    # x2 steps up to 4M (stable small-size shape family), then the x1.5
    # bucket ladder: sort cost tracks the PADDED size at genome scale, and a
    # 4.6 Mbp genome must pad to 6.3M entries, not 8.4M
    padded = pad_to_multiple
    while padded < n and padded < (1 << 22):
        padded *= 2
    if padded < n:
        padded = bucket_size(n, floor=padded)
    out = np.full(padded, CODE_N, dtype=np.int32)
    out[: len(codes)] = codes
    return out


@partial(jax.jit, static_argnames=("offsets", "pattern_len"))
def pack_canonical_mers(codes: jnp.ndarray, offsets: Tuple[int, ...], pattern_len: int) -> jnp.ndarray:
    """codes: int32[P] (2-bit codes, CODE_N padded) -> canonical keys int64[P-L+1].

    Key layout: (min(fwd, rc) << 1) | (1 if rc < fwd else 0); invalid windows
    get INVALID_KEY.
    """
    n_pos = codes.shape[0] - pattern_len + 1
    w = len(offsets)
    fwd = jnp.zeros(n_pos, dtype=jnp.int64)
    rc = jnp.zeros(n_pos, dtype=jnp.int64)
    invalid = jnp.zeros(n_pos, dtype=bool)
    for j, off in enumerate(offsets):
        c = codes[off : off + n_pos]
        invalid = invalid | (c >= CODE_N)
        c64 = c.astype(jnp.int64)
        fwd = fwd + (c64 << (2 * (w - 1 - j)))
        rc = rc + ((3 - c64) << (2 * j))
    use_rc = rc < fwd
    canonical = jnp.where(use_rc, rc, fwd)
    key = (canonical << 1) | use_rc.astype(jnp.int64)
    return jnp.where(invalid, INVALID_KEY, key)


@jax.jit
def sort_key_pos(keys: jnp.ndarray, positions: jnp.ndarray):
    """Sort (key, position) pairs by key then position.

    int64 keys are split into 32-bit halves and sorted as a 3-key
    lexicographic sort on 32-bit operands.
    """
    hi = (keys >> 32).astype(jnp.int32)
    lo = keys.astype(jnp.uint32)  # wraps mod 2^32: fine as a secondary key
    hi_s, lo_s, pos_s = jax.lax.sort((hi, lo, positions), num_keys=3)
    keys_s = (hi_s.astype(jnp.int64) << 32) | lo_s.astype(jnp.int64)
    return keys_s, pos_s


@partial(jax.jit, static_argnames=("offsets", "pattern_len"))
def build_mer_list(codes: jnp.ndarray, offsets: Tuple[int, ...], pattern_len: int):
    """K1 pack WITHOUT the sort: (keys int64[n_pos], positions int32[n_pos]),
    unsorted, INVALID entries interspersed.  The multi-MUM search globally
    re-sorts the concatenated per-genome lists anyway, so pre-sorting each
    genome is pure waste on that path (it was ~the whole K1 cost at genome
    scale)."""
    keys = pack_canonical_mers(codes, offsets, pattern_len)
    n_pos = keys.shape[0]
    positions = jax.lax.broadcasted_iota(jnp.int32, (n_pos, 1), 0).reshape(n_pos)
    return keys, positions


@partial(jax.jit, static_argnames=("offsets", "pattern_len"))
def build_sorted_mer_list(codes: jnp.ndarray, offsets: Tuple[int, ...], pattern_len: int):
    """Full K1 pipeline: pack + canonicalize + sort.

    Returns (sorted_keys int64[n_pos], sorted_positions int32[n_pos],
    n_valid int32) — positions are 0-based window starts; entries with
    INVALID_KEY are sorted to the tail and counted out by n_valid.
    """
    keys = pack_canonical_mers(codes, offsets, pattern_len)
    n_pos = keys.shape[0]
    positions = jax.lax.broadcasted_iota(jnp.int32, (n_pos, 1), 0).reshape(n_pos)
    w = len(offsets)
    if 2 * w + 1 <= 31:
        # small-seed fast path: the whole key fits one int32 lane (a valid
        # key is never all-ones: canonical = min(fwd, rc) and the rc of an
        # all-T mer is all-A, so the int32-max sentinel is collision-free)
        sent = jnp.int32(0x7FFFFFFF)
        k32 = jnp.where(keys == INVALID_KEY, sent, keys.astype(jnp.int32))
        k32_s, pos_s = jax.lax.sort((k32, positions), num_keys=2)
        keys_s = jnp.where(k32_s == sent, INVALID_KEY, k32_s.astype(jnp.int64))
        n_valid = jnp.sum((k32_s != sent).astype(jnp.int32))
        return keys_s, pos_s, n_valid
    keys_s, pos_s = sort_key_pos(keys, positions)
    n_valid = jnp.sum((keys_s != INVALID_KEY).astype(jnp.int32))
    return keys_s, pos_s, n_valid


def pack_2bit_host(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pack host codes (0..4) into 2 bits/base for cheap upload.

    Sequences ship packed (4 bases/byte) plus a sparse exception list of ambiguity
    positions.  Returns (packed uint8[ceil(L/4)], n_positions int32[K]).
    """
    codes = np.asarray(codes)
    L = len(codes)
    exc = np.nonzero(codes >= CODE_N)[0].astype(np.int32)
    two_bit = np.where(codes >= CODE_N, 0, codes).astype(np.uint8)
    pad = (-L) % 4
    if pad:
        two_bit = np.concatenate([two_bit, np.zeros(pad, np.uint8)])
    quads = two_bit.reshape(-1, 4)
    packed = quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
    return packed, exc


@partial(jax.jit, static_argnames=("n_out",))
def unpack_2bit(
    packed: jnp.ndarray,      # uint8[P] (P*4 >= length)
    exceptions: jnp.ndarray,  # int32[K] positions of ambiguity codes (pad: -1)
    length: jnp.ndarray,      # int32 scalar: true sequence length
    n_out: int,               # static padded output length (>= length)
) -> jnp.ndarray:
    """Packed bases -> int32 codes [n_out], CODE_N past `length` and at
    exception positions."""
    p = packed.astype(jnp.int32)
    quads = jnp.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3], axis=1)
    flat = quads.reshape(-1)
    if flat.shape[0] < n_out:
        flat = jnp.concatenate([flat, jnp.zeros(n_out - flat.shape[0], jnp.int32)])
    codes = flat[:n_out]
    iota = jax.lax.broadcasted_iota(jnp.int32, (n_out, 1), 0).reshape(n_out)
    codes = jnp.where(iota < length, codes, CODE_N)
    exc = jnp.where(exceptions >= 0, exceptions, n_out)
    codes = codes.at[exc].set(CODE_N, mode="drop")
    return codes


def upload_codes(codes: np.ndarray, pattern_len: int, pad_to_multiple: int = 1 << 12) -> jnp.ndarray:
    """Host codes -> device int32 code array, padded to a bucketed length,
    shipped 2-bit packed."""
    L = len(codes)
    n = L + pattern_len
    padded = bucket_size(n, pad_to_multiple)
    packed, exc = pack_2bit_host(codes)
    pb = padded // 4  # tied to `padded`: no extra shape dimension
    packed_padded = np.zeros(pb, np.uint8)
    packed_padded[: len(packed)] = packed
    eb = 1 << 10
    while eb < len(exc):
        eb *= 4
    exc_padded = np.full(eb, -1, np.int32)
    exc_padded[: len(exc)] = exc
    return unpack_2bit(
        jnp.asarray(packed_padded), jnp.asarray(exc_padded), jnp.int32(L), padded
    )


def upload_codes_cached(genome, pattern_len: int) -> jnp.ndarray:
    """upload_codes memoized on the Genome instance: repeated searches
    (recursion rounds, extension passes) reuse the device-resident code
    array instead of re-uploading megabytes.  A cached array
    padded at least as long as required is reused (the extra tail is CODE_N,
    which only adds invalid windows)."""
    need = len(genome.codes) + pattern_len
    cached = getattr(genome, "_dev_codes", None)
    if cached is not None and cached.shape[0] >= need:
        return cached
    arr = upload_codes(genome.codes, pattern_len)
    genome._dev_codes = arr
    return arr


def unique_mer_count(sorted_keys: np.ndarray, n_valid: int) -> int:
    """Number of distinct strand-free mers that occur exactly once
    (UniqueMerCount; reference tool src/uniqueMerCount.cpp:30-39)."""
    mers = np.asarray(sorted_keys[:n_valid]) >> 1
    if len(mers) == 0:
        return 0
    # keys ascending => mers (key >> 1) ascending: the strand LSB cannot
    # reorder distinct mers, so no re-sort is needed
    new_run = np.concatenate([[True], mers[1:] != mers[:-1]])
    run_ids = np.cumsum(new_run) - 1
    counts = np.bincount(run_ids)
    return int(np.sum(counts == 1))
