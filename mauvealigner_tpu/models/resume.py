"""Checkpoint / resume for the match-search phase.

Reference mechanisms reproduced (SURVEY.md §5.4; src/mauveAligner.cpp:533-589):

  * --match-log:  matches found so far are journaled after every completed
    seed-space partition;
  * --offset-log: records which partitions completed, so a restarted search
    continues from the first incomplete partition;
  * --merge-match-log: folds a journal produced elsewhere into the result
    (map-reduce over seed space by offset).

Redesign: the reference journals byte offsets into its k-way
merge; here the seed space is partitioned by canonical-mer range — the same
partitioning used to shard match search across chips (parallel/sharded.py) —
and each partition is one device call.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from mauvealigner_tpu.core import mln
from mauvealigner_tpu.core.match import MatchList
from mauvealigner_tpu.genome.sequence import Genome
from mauvealigner_tpu.ops import matchops, merops
from mauvealigner_tpu.seeds import Seed


def mer_partition_bounds(seed: Seed, n_partitions: int) -> List[Tuple[int, int]]:
    """Split the canonical-mer key space into contiguous ranges."""
    top = 1 << (2 * seed.weight + 1)  # keys carry the strand bit
    step = -(-top // n_partitions)
    return [(i * step, min((i + 1) * step, top)) for i in range(n_partitions)]


def read_offset_log(path: str) -> List[int]:
    if not path or not os.path.exists(path):
        return []
    done = []
    for line in open(path):
        line = line.strip()
        if line.isdigit():
            done.append(int(line))
    return done


def resumable_find_mums(
    genomes: Sequence[Genome],
    seed: Seed,
    n_partitions: int = 4,
    match_log: str = "",
    offset_log: str = "",
    min_multi: int = 2,
) -> MatchList:
    """Partitioned multi-MUM search with journaling.

    Matches whose seed groups fall in completed partitions are read back from
    the match log on restart; only incomplete partitions are searched.
    """
    from mauvealigner_tpu.core.sml import build_mer_list_device

    done = set(read_offset_log(offset_log))
    ml = MatchList.empty(len(genomes))
    if match_log and os.path.exists(match_log) and done:
        ml, _, _ = mln.read_match_list(match_log)
    smls_dev = [build_mer_list_device(g, seed) for g in genomes]
    bounds = mer_partition_bounds(seed, n_partitions)
    names = [g.filename or g.name for g in genomes]
    lens = [len(g) for g in genomes]
    for pi, (lo, hi) in enumerate(bounds):
        if pi in done:
            continue
        part = [
            _mask_key_range(keys, pos, lo, hi) for keys, pos in smls_dev
        ]
        part_ml = matchops.find_multi_mums_device(
            genomes, part, min_multi=min_multi, seed_length=seed.length
        )
        ml = ml.concat(part_ml).dedup()
        if match_log:
            mln.write_match_list(ml, match_log, names, lens)
        if offset_log:
            with open(offset_log, "a") as fh:
                fh.write(f"{pi}\n")
    # boundary effect: a maximal run whose windows straddle a partition edge
    # appears once per partition after extension; dedup handles exact copies
    return ml.dedup()


def _mask_key_range(keys, pos, lo: int, hi: int):
    """Keep only entries whose canonical key falls in [lo, hi)."""
    keep = (keys >= lo) & (keys < hi) & (keys != merops.INVALID_KEY)
    masked = jnp.where(keep, keys, merops.INVALID_KEY)
    # re-sort so INVALID entries move to the tail (cheap: already sorted by
    # key, so masked arrays remain sorted except masked-out ranges; a full
    # sort keeps the invariant simple)
    return merops.sort_key_pos(masked, pos)


def merge_match_logs(base: MatchList, log_paths: Sequence[str]) -> MatchList:
    """--merge-match-log: fold external journals into the match list."""
    ml = base
    for path in log_paths:
        other, _, _ = mln.read_match_list(path)
        if other.n_seqs == ml.n_seqs:
            ml = ml.concat(other)
    return ml.dedup()


def realign_lcbs(
    aligner,
    genomes: Sequence[Genome],
    ml: MatchList,
    lcbs,
    lcb_ids: Sequence[int],
):
    """--realign-lcb=<n>: gapped-align only the selected LCBs
    (src/mauveAligner.cpp:723-744, 'for parallelization of LCB alignment').

    Returns an IntervalList containing intervals for just those LCBs.
    """
    selected = [lcbs[i] for i in lcb_ids if 0 <= i < len(lcbs)]
    return aligner.build_intervals(genomes, ml, selected)
