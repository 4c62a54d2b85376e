"""What the host did during a window: the process's CPU seconds, the share of
the machine's CPU time that its hypervisor took (steal, from /proc/stat),
Python's garbage collections and their seconds, and the window's pages a
second in each fifth of it. A run prints them on an earlier line, so that
a slow run shows whether the host ran slower under the same work."""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List, Optional


def _cpu_ticks() -> Optional[List[int]]:
    """The machine's CPU time by kind (/proc/stat's "cpu" line), or None."""
    try:
        with open("/proc/stat") as f:
            return [int(v) for v in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None


class HostWatch:
    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, 0.0

    def _on_gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def start(self) -> None:
        self.gc_s, self.gc_n = 0.0, 0
        self.ticks0, self.cpu0, self.wall0 = _cpu_ticks(), time.process_time(), time.time()
        gc.callbacks.append(self._on_gc)

    def stop(self, done_at: List[float]) -> Dict:
        """-> the readings; `done_at`: each page's completion time, in
        seconds from the window's start."""
        gc.callbacks.remove(self._on_gc)
        wall = time.time() - self.wall0
        out = {"wall_s": wall, "process_cpu_s": time.process_time() - self.cpu0,
               "cores": len(os.sched_getaffinity(0)), "gc_collections": self.gc_n,
               "gc_s": self.gc_s}
        ticks = _cpu_ticks()
        if ticks and self.ticks0:
            d = [b - a for a, b in zip(self.ticks0, ticks)]
            total = sum(d[:8])
            out["steal_share"] = d[7] / total if total and len(d) > 7 else None
            out["idle_share"] = (d[3] + d[4]) / total if total else None
        if done_at:
            end = max(done_at)
            counts = [0] * 5
            for t in done_at:
                counts[min(int(5 * t / end), 4) if end > 0 else 0] += 1
            out["pages_per_s_by_fifth"] = [n / (end / 5) for n in counts] if end > 0 else None
        return out
