"""Driver contract for bench.py: one JSON line with the agreed schema.

`python bench.py` prints a single JSON line; this pins its schema
(metric/value/unit/vs_baseline plus the detail block) at a CPU-friendly
genome size so schema drift is caught before a run on the GPU."""

import io
import json
import pathlib
from contextlib import redirect_stdout

import pytest


@pytest.mark.slow
def test_bench_emits_one_json_line(monkeypatch):
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).parents[1]))
    import bench

    monkeypatch.setattr(bench, "GENOME_SIZE", 20_000)
    buf = io.StringIO()
    with redirect_stdout(buf):
        bench.main()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "pairwise_1mbp_wallclock"
    assert isinstance(rec["value"], float) and rec["value"] > 0
    assert rec["unit"] == "s"
    assert rec["vs_baseline"] > 0
    d = rec["detail"]
    assert d["genome_size"] == 20_000
    assert len(d["warm_runs_s"]) == 3
    assert rec["value"] == min(d["warm_runs_s"])
    assert d["cold_wallclock_s"] > 0  # schema presence (cold-vs-warm ratio flakes)
    assert d["n_lcbs"] >= 1 and d["n_anchors"] > 0 and d["aligned_columns"] > 0
