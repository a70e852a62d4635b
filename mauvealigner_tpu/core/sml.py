"""Sorted Mer List: host container + disk cache around the K1 device kernel.

Equivalent of libMems DNAFileSML/FileSML (reference src/mauveAligner.cpp:365,
src/progressiveMauve.cpp:215-224).  Cache files are named
``<seqfile>.<pattern>.sslist.npz`` mirroring the reference's
``seq.<pattern>.sslist`` convention (getDefaultSmlFileNames,
src/progressiveMauve.cpp:215-224).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax.numpy as jnp
import numpy as np

from mauvealigner_tpu.genome.sequence import Genome
from mauvealigner_tpu.ops import merops
from mauvealigner_tpu.seeds import Seed

_SML_FORMAT_VERSION = 1

# scratch-path registry (FileSML::registerTempPath equivalent,
# src/mauveAligner.cpp:364-366); used when the sequence directory is
# read-only.
_temp_paths: list[str] = []


def register_temp_path(path: str) -> None:
    _temp_paths.append(path)


@dataclasses.dataclass
class SortedMerList:
    """Sorted canonical spaced-mer list for one genome."""

    keys: np.ndarray        # int64[n_valid], sorted canonical keys (strand in LSB)
    positions: np.ndarray   # int32[n_valid], 0-based window starts
    seed: Seed
    seq_length: int

    @property
    def seed_length(self) -> int:
        return self.seed.length

    @property
    def seed_weight(self) -> int:
        return self.seed.weight

    def unique_mer_count(self) -> int:
        return merops.unique_mer_count(self.keys, len(self.keys))

    def get_mer_at_sorted_index(self, i: int) -> int:
        return int(self.keys[i])


def build_sml_device(genome: Genome, seed: Seed):
    """K1 pipeline keeping the result ON DEVICE (no host transfer).

    Returns (keys int64 device array, positions int32 device array), sorted,
    with INVALID_KEY entries at the tail.  This is the production path; the
    host SortedMerList is for disk caching, tools and cross-validation.
    """
    from mauvealigner_tpu.utils import timing

    timing.GLOBAL.add("k1_bases", float(len(genome)))
    codes_dev = merops.upload_codes(genome.codes, seed.length)
    keys, pos, _ = merops.build_sorted_mer_list(
        codes_dev, tuple(int(o) for o in seed.offsets), seed.length
    )
    return keys, pos


def build_mer_list_device(genome: Genome, seed: Seed):
    """build_sml_device WITHOUT the per-genome sort, for consumers that
    globally re-sort anyway (find_multi_mums_device).  Returns (keys int64,
    positions int32) device arrays, unsorted, INVALID interspersed."""
    from mauvealigner_tpu.utils import timing

    timing.GLOBAL.add("k1_bases", float(len(genome)))
    codes_dev = merops.upload_codes(genome.codes, seed.length)
    return merops.build_mer_list(
        codes_dev, tuple(int(o) for o in seed.offsets), seed.length
    )


def build_sml(genome: Genome, seed: Seed) -> SortedMerList:
    """Run the K1 device pipeline for one genome."""
    if len(genome) < seed.length:
        return SortedMerList(
            np.zeros(0, np.int64), np.zeros(0, np.int32), seed, len(genome)
        )
    codes = merops.pad_codes(genome.codes.astype(np.int32), seed.length)
    keys, pos, n_valid = merops.build_sorted_mer_list(
        jnp.asarray(codes), tuple(int(o) for o in seed.offsets), seed.length
    )
    n = int(n_valid)
    keys_np = np.asarray(keys[:n])
    pos_np = np.asarray(pos[:n])
    # positions past the real sequence end are CODE_N-padded hence invalid
    assert len(keys_np) == 0 or pos_np.max() <= len(genome) - seed.length
    return SortedMerList(keys_np, pos_np, seed, len(genome))


def _cache_path(seq_filename: str, seed: Seed) -> str:
    base = f"{seq_filename}.{seed.pattern}.sslist.npz"
    return base


def load_sml(genome: Genome, seed: Seed, cache: bool = True, cache_path: Optional[str] = None) -> SortedMerList:
    """Load an SML from the disk cache, building (and caching) on miss —
    MatchList::LoadSMLs semantics (src/progressiveMauve.cpp:447-451)."""
    path = cache_path or (_cache_path(genome.filename, seed) if genome.filename else None)
    if cache and path:
        # the save fallback may have written to a registered scratch path
        # (read-only sequence directory) — check those on load too
        candidates = [path] + [
            os.path.join(tp, os.path.basename(path)) for tp in _temp_paths
        ]
        for cand in candidates:
            if not os.path.exists(cand):
                continue
            try:
                with np.load(cand) as z:
                    if (
                        int(z["version"]) == _SML_FORMAT_VERSION
                        and str(z["pattern"]) == seed.pattern
                        and int(z["seq_length"]) == len(genome)
                    ):
                        return SortedMerList(z["keys"], z["positions"], seed, len(genome))
            except Exception:
                pass  # unreadable/stale cache: rebuild
    sml = build_sml(genome, seed)
    if cache and path:
        target = path
        for candidate_dir in [os.path.dirname(path) or "."] + _temp_paths:
            try:
                target = os.path.join(candidate_dir, os.path.basename(path))
                np.savez(
                    target,
                    version=_SML_FORMAT_VERSION,
                    pattern=seed.pattern,
                    seq_length=len(genome),
                    keys=sml.keys,
                    positions=sml.positions,
                )
                break
            except OSError:
                continue
    return sml
