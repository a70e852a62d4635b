"""Profile the backbone HOST passes (bb_rows + bb_apply) at headline-like
scale without any device work.

Synthesizes an IntervalList + BackboneColumnSegment workload shaped like the
9 x 4.6 Mbp configuration (~830k backbone rows) and times backbone_seq_coordinates / merge_coordinate_rows /
add_unique_segments / apply_backbone / write_backbone_seq_file.

Usage: python scripts/profile_backbone_host.py [n_cols_per_iv] [n_ivs]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from mauvealigner_tpu.analysis import backbone as bb
from mauvealigner_tpu.core.interval import Interval, IntervalList
from mauvealigner_tpu.genome.sequence import Genome


def synth(n_cols=2_000_000, n_ivs=4, n_seqs=9, seed=37):
    """Intervals with run-structured aln rows + segments tiling columns."""
    rng = np.random.default_rng(seed)
    intervals = []
    segments = []
    next_left = np.ones(n_seqs, np.int64)
    for k in range(n_ivs):
        aln = np.ones((n_seqs, n_cols), bool)
        # sprinkle gap runs (geometric lengths) on each row, ~10% gaps
        for s in range(n_seqs):
            n_gaps = n_cols // 200
            gs = rng.integers(0, n_cols - 64, n_gaps)
            gl = rng.geometric(0.05, n_gaps).clip(1, 60)
            d = np.zeros(n_cols + 1, np.int32)
            np.add.at(d, gs, 1)
            np.add.at(d, np.minimum(gs + gl, n_cols), -1)
            aln[s, np.cumsum(d[:-1]) > 0] = False
        starts = next_left.copy()
        # half the rows reverse strand in odd intervals
        if k % 2:
            starts[::2] *= -1
        next_left += aln.sum(axis=1)
        intervals.append(Interval(starts, aln))
        # segments: tile columns with lengths ~ geometric mean ~200
        c = 0
        while c < n_cols:
            w = int(rng.geometric(1 / float(os.environ.get("SEG_MEAN", "200")))) + 8
            b = min(c + w, n_cols)
            m = rng.random(n_seqs) < 0.8
            if m.sum() >= 2:
                segments.append(
                    bb.BackboneColumnSegment(k, c, b, list(np.nonzero(m)[0]))
                )
            c = b
    genomes = [
        Genome.from_codes(
            rng.integers(0, 4, int(next_left[s]) + 10).astype(np.int64),
            name=f"g{s}",
        )
        for s in range(n_seqs)
    ]
    return IntervalList(genomes=genomes, intervals=intervals), segments


def main():
    n_cols = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    n_ivs = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    ivs, segments = synth(n_cols, n_ivs)
    print(f"{len(ivs.intervals)} intervals x {n_cols} cols, "
          f"{len(segments)} segments")

    t0 = time.perf_counter()
    rows = bb.backbone_seq_coordinates(ivs, segments, as_matrix=True)
    t1 = time.perf_counter()
    print(f"backbone_seq_coordinates: {t1 - t0:.2f}s ({len(rows)} rows)")
    rows2 = bb.merge_coordinate_rows(rows)
    t2 = time.perf_counter()
    print(f"merge_coordinate_rows:    {t2 - t1:.2f}s ({len(rows2)} rows)")
    rows3 = bb.add_unique_segments(rows2, ivs, [len(g) for g in ivs.genomes])
    t3 = time.perf_counter()
    print(f"add_unique_segments:      {t3 - t2:.2f}s ({len(rows3)} rows)")
    import io

    buf = io.StringIO()
    bb.write_backbone_seq_file(rows3, buf, ivs.n_seqs)
    t4 = time.perf_counter()
    print(f"write_backbone_seq_file:  {t4 - t3:.2f}s")

    t4 = time.perf_counter()
    out = bb.apply_backbone(ivs, segments)
    t5 = time.perf_counter()
    print(f"apply_backbone:           {t5 - t4:.2f}s ({len(out.intervals)} intervals)")
    t5 = time.perf_counter()
    out2 = bb.apply_backbone(ivs, segments, raw_coords=np.asarray(rows))
    t6 = time.perf_counter()
    print(f"apply_backbone(raw):      {t6 - t5:.2f}s ({len(out2.intervals)} intervals)")
    assert len(out.intervals) == len(out2.intervals)
    for x, y in zip(out.intervals, out2.intervals):
        assert np.array_equal(x.starts, y.starts) and np.array_equal(x.aln, y.aln)
    print("raw_coords path identical")


if __name__ == "__main__":
    main()
