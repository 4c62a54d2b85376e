"""Reduce a `torch.profiler` trace, kept in memory, to what the per-layer
metrics read.

The arithmetic is a frozen copy of `scripts/profile_torch_port.py` at
commit d849d6a: the device is busy on the union of its kernel, memcpy and
memset intervals (`busy_us`), and the kernels of a host range are those
whose launching runtime call (cudaLaunchKernel and the like) starts inside
a CPU range of that name, matched to the kernel by correlation id
(`range_kernels`). Here the runtime call must also be on the range's
thread, so an upload from another thread is not counted in it. The events
are read from the profiler's in-memory results; no trace file is written.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Tuple

import torch


class Trace:
    """The events of one traced slice, in nanoseconds."""

    def __init__(self, prof: "torch.profiler.profile", wall_s: float):
        self.wall_s = wall_s
        self.kernels: List[Tuple[str, int, int, int]] = []   # name, start, dur, corr
        self.copies: List[Tuple[str, int, int]] = []
        self.runtime: List[Tuple[int, int, int]] = []        # start, corr, thread
        self.ranges: Dict[str, List[Tuple[int, int, int]]] = {}  # name -> start, end, thread
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.profiler.kineto_results.events()
        # A host range shows on the device's timeline too, under its own
        # name: that span is no device operation.
        marks = {e.name() for e in events if e.is_user_annotation()}
        for e in events:
            name, start, dur = e.name(), e.start_ns(), e.duration_ns()
            if e.device_type() == cuda:
                if e.is_user_annotation() or name in marks:
                    continue
                if name.startswith(("Memcpy", "Memset")):
                    self.copies.append((name, start, dur))
                else:
                    self.kernels.append((name, start, dur, e.correlation_id()))
            elif name in marks:
                self.ranges.setdefault(name, []).append((start, start + dur,
                                                         e.start_thread_id()))
            elif name.startswith("cu"):
                self.runtime.append((start, e.correlation_id(), e.start_thread_id()))
        self.kernels.sort(key=lambda k: k[1])

    # ---- the device ----

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of kernel, memcpy and memset intervals, merged, sorted."""
        spans = sorted([(k[1], k[1] + k[2]) for k in self.kernels]
                       + [(c[1], c[1] + c[2]) for c in self.copies])
        out: List[List[int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(k[2] for k in self.kernels if rx.search(k[0])) / 1e9

    def range_kernels(self, name: str) -> List[Tuple[str, int, int, int]]:
        """The kernels launched inside the host ranges called `name`."""
        ranges = sorted(self.ranges.get(name, []))
        if not ranges:
            return []
        starts = [r[0] for r in ranges]
        corr = set()
        for t, c, thread in self.runtime:
            i = bisect.bisect_right(starts, t) - 1
            # Ranges of one name do not nest, so the last one that starts
            # before t is the only one that can hold it.
            if i >= 0 and t <= ranges[i][1] and ranges[i][2] == thread:
                corr.add(c)
        return [k for k in self.kernels if k[3] in corr]

    def range_kernel_s(self, name: str) -> float:
        return sum(k[2] for k in self.range_kernels(name)) / 1e9

    # ---- the breakdown ----

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took the most time: [name, seconds]."""
        by: Dict[str, int] = {}
        for name, _, dur, _ in self.kernels:
            by[name] = by.get(name, 0) + dur
        for name, _, dur in self.copies:
            by[name] = by.get(name, 0) + dur
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[short(k), v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time between busy intervals, summed by the innermost
        host range open at each gap's middle ("no range" outside all of
        them): [range, seconds], the largest first."""
        busy = self.busy_intervals()
        spans = sorted((s, e, name) for name, rs in self.ranges.items() for s, e, _ in rs)
        starts = [s[0] for s in spans]
        by: Dict[str, int] = {}
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) // 2
            key = "no range"
            # Ranges nest: the innermost open one is the latest to start
            # of those that have not ended; it lies a few ranges back.
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 64, -1), -1):
                if spans[j][1] >= mid:
                    key = spans[j][2]
                    break
            by[key] = by.get(key, 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


def short(name: str, limit: int = 160) -> str:
    """A kernel's name without its parameter list, at most `limit` chars."""
    name = name.replace("(anonymous namespace)", "anon")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:limit]
