"""Per-phase wall-clock and throughput counters.

The reference's observability is a progress ticker (LogProgress,
src/mauveAligner.cpp:482,532); here profiling is first-class: every pipeline
phase records wall-clock and work counters, and DP phases report GCUPS
(giga cell updates per second).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional


class PhaseTimer:
    def __init__(self) -> None:
        self.phases: "OrderedDict[str, float]" = OrderedDict()
        self.counters: Dict[str, float] = {}
        self._suspended = 0
        # counters accumulate from concurrent node-merge threads
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        if self._suspended:  # nested pipeline (e.g. per-node merges): the
            yield            # enclosing phase already owns this wall-clock
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def suspend(self):
        """Stop recording phases (counters still accumulate) — used by
        composite phases whose inner pipelines would double-count."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    def add(self, counter: str, value: float) -> None:
        with self._lock:
            self.counters[counter] = self.counters.get(counter, 0.0) + value

    def reset(self) -> None:
        self.phases.clear()
        self.counters.clear()

    def gcups(self, phase: str, cells_counter: str) -> Optional[float]:
        t = self.phases.get(phase)
        c = self.counters.get(cells_counter)
        if not t or c is None:
            return None
        return c / t / 1e9

    def throughput(self, phase: str, counter: str) -> Optional[float]:
        """counter units per second of `phase` wall-clock (None if missing)."""
        t = self.phases.get(phase)
        c = self.counters.get(counter)
        if not t or c is None:
            return None
        return c / t

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{'phase':<24}{'seconds':>10}{'share':>8}"]
        for name, t in self.phases.items():
            lines.append(f"{name:<24}{t:>10.3f}{t / total if total else 0:>8.1%}")
        lines.append(f"{'total':<24}{total:>10.3f}")
        for c, v in sorted(self.counters.items()):
            # sub-second timing counters need the decimals (an 8-merge
            # ladder's per-phase splits truncated to 0s were unreadable)
            if c.endswith("_s") and v < 100:
                lines.append(f"{c}: {v:,.2f}")
            else:
                lines.append(f"{c}: {v:,.0f}")
        # K1/K2 throughputs: the counters accumulate from EVERY phase that
        # builds mer lists or runs the candidate kernel (initial anchoring,
        # recursion, LCB extension, subset recovery, tree-progressive node
        # merges), so divide by the sum of those phases' wall-clock
        anchor_time = sum(
            self.phases.get(p, 0.0)
            for p in ("anchoring", "recursive_anchoring", "lcb_extension",
                      "subset_lcbs", "tree_progressive")
        )
        bases = self.counters.get("k1_bases")
        if anchor_time and bases:
            lines.append(
                f"anchor-phase bases processed: {bases/anchor_time/1e6:.1f} Mbases/s"
            )
        entries = self.counters.get("k2_sort_entries")
        if anchor_time and entries:
            lines.append(
                f"anchor-phase sort entries: {entries/anchor_time/1e6:.1f} M/s"
            )
        # gapped DP throughput across all DP-driving phases
        dp_time = sum(
            self.phases.get(p, 0.0)
            for p in ("gapped_closure", "boundary_extension", "refinement",
                      "subset_lcbs", "extension")
        )
        c = self.counters.get("dp_cells")
        if dp_time and c:
            lines.append(f"gapped DP throughput: {c / dp_time / 1e9:.3f} GCUPS")
        return "\n".join(lines) + "\n"


def card_info():
    """Name and power limit of each NVIDIA card, as nvidia-smi reports them
    (None without nvidia-smi).  A card set below its maximum power runs
    slower under load, so every device measurement carries this line."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


# process-global default timer (cheap; aligners use it when none is given)
GLOBAL = PhaseTimer()
