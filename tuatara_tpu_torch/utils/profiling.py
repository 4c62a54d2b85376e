"""Tracing and timing (port of `tuatara_tpu/utils/profiling.py`).

`OcrEngine` marks its stages with `torch.profiler.record_function` under
the JAX package's names (`tuatara_detect`, `tuatara_recognize`,
`tuatara_fetch`, `tuatara_decode`), so a trace attributes host spans and
the kernels launched inside them to a stage. This module adds the trace
capture and timers fenced on the device:

    with profiling.trace("build/trace"):
        engine.run_pages(pages)        # build/trace/trace.json: Perfetto,
                                       # chrome://tracing, TensorBoard

A timer stops its clock only after the device has finished the work:
`torch.cuda.synchronize` of the tensors' device (JAX reads one element back
to the host for the same end).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, List

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record host and device activity of the enclosed code with
    `torch.profiler` and write it as a Chrome trace, `log_dir/trace.json`.
    The CUDA activity is recorded whenever a card is present."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str) -> torch.profiler.record_function:
    """A named region of the trace (a context manager)."""
    return torch.profiler.record_function(name)


def fence(result=None) -> None:
    """Wait for the device work behind `result` (any nesting of tensors in
    dicts, lists and tuples) to finish: a synchronize of each card its
    tensors lie on, or of the current card when it holds none on a card
    (a host result, or None). A no-op without a card in use: CPU ops
    return finished."""
    cards = {t.device for t in _tensors(result) if t.is_cuda}
    if not cards and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for d in cards:
        torch.cuda.synchronize(d)


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    return []


class StageTimer:
    """Accumulating wall-clock stage timer, fenced on the device: a stage's
    clock stops after the device work launched in it has finished."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            fence()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": v, "count": self.counts[k], "mean_s": v / self.counts[k]}
                for k, v in self.totals.items()}


def timeit(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> Dict[str, float]:
    """Mean wall time of `fn(*args)`, each call fenced on the device work
    its result depends on (or on the current card when it returns no
    tensor)."""
    for _ in range(warmup):
        fence(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        fence(fn(*args))
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "iters": iters}
