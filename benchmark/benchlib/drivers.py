"""The two ways a window drives the program, both closed loops.

`StreamDriver`: an offline job. `OcrEngine.run_stream` takes batches from
a generator that cycles through the pool until the window's time is up;
the batches already handed over are finished, and the window ends when
`run_stream` returns. `PageDriver`: one caller that waits for each page,
`tuatara_tpu_torch.image_to_data` a page at a time until the time is up,
each call timed on the host clock.

Each returns what the window did: the pages completed, its seconds, the
latencies (page cells), the engine's counters over the window, every
result keyed by its pool page and, for each page, the seconds from the
window's start at which it completed (page cells) or its batch was handed
to `run_stream` (stream cells).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class StreamDriver:
    def __init__(self, engine, pool: List[np.ndarray], mix: Dict):
        self.engine = engine
        self.per_batch = mix["pages_per_batch"]
        self.prefetch, self.depth = mix["prefetch"], mix["depth"]
        self.set_pool(pool)

    def set_pool(self, pool: List[np.ndarray]) -> None:
        self.batches = pool_batches(pool, self.per_batch)

    def warm(self) -> None:
        """Every batch of the pool once: every slab size the window meets."""
        self.engine.run_stream(self.batches, prefetch=self.prefetch, depth=self.depth)
        sync(self.engine.device)

    def run(self, seconds: float = math.inf, batches: int = -1) -> Dict:
        """Batches for `seconds` of wall time, or exactly `batches` of them."""
        order: List[int] = []
        fed: List[float] = []
        n = len(self.batches)
        deadline = [math.inf]

        def feed():
            i = 0
            while (i < batches) if batches >= 0 else (i == 0 or time.perf_counter() < deadline[0]):
                order.append(i % n)
                fed.append(time.perf_counter() - t0)
                yield self.batches[i % n]
                i += 1

        self.engine.reset_stats()
        t0 = time.perf_counter()
        deadline[0] = t0 + seconds
        out = self.engine.run_stream(feed(), prefetch=self.prefetch, depth=self.depth)
        sync(self.engine.device)
        elapsed = time.perf_counter() - t0
        results = []
        for b, res in zip(order, out):
            for j, page in enumerate(res):
                results.append((b * self.per_batch + j, page))
        shapes = [self.batches[b].shape[1:3] for b in order for _ in range(self.per_batch)]
        return {"pages": len(results), "seconds": elapsed, "latencies_s": [], "failed": 0,
                "results": results, "stats": dict(self.engine.stats), "shapes": shapes,
                "times_s": [t for t in fed for _ in range(self.per_batch)]}


class PageDriver:
    def __init__(self, call, engine, pool: List[np.ndarray]):
        """`call(page)` is the public entry; `engine` the one it serves from
        (for its counters)."""
        self.call, self.engine, self.pool = call, engine, pool

    def set_pool(self, pool: List[np.ndarray]) -> None:
        self.pool = pool

    def warm(self) -> None:
        """Every page of the pool once: its four shapes and its box counts."""
        for page in self.pool:
            self.call(page)
        sync(self.engine.device)

    def run(self, seconds: float = math.inf, pages: int = -1) -> Dict:
        lat: List[float] = []
        done: List[float] = []
        results = []
        shapes = []
        failed = 0
        n = len(self.pool)
        self.engine.reset_stats()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while (i < pages) if pages >= 0 else (i == 0 or time.perf_counter() < deadline):
            page = self.pool[i % n]
            s = time.perf_counter()
            try:
                res = self.call(page)
            except Exception as e:  # a failed page counts, the window goes on
                print(f"page {i % n} failed: {e!r}", flush=True)
                res = None
                failed += 1
            e = time.perf_counter()
            lat.append(e - s if res is not None else math.inf)
            done.append(e - t0)
            results.append((i % n, res))
            shapes.append(page.shape[:2])
            i += 1
        elapsed = time.perf_counter() - t0
        return {"pages": i, "seconds": elapsed, "latencies_s": lat, "failed": failed,
                "results": results, "stats": dict(self.engine.stats), "shapes": shapes,
                "times_s": done}


def pool_batches(pool: List[np.ndarray], per_batch: int) -> List[np.ndarray]:
    if len(pool) % per_batch:
        raise ValueError("pool_pages must be a multiple of pages_per_batch")
    return [np.stack(pool[i:i + per_batch]) for i in range(0, len(pool), per_batch)]
