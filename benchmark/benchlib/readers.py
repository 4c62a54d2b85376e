"""What the per-metric readers under `benchmark/metrics/` share.

`ctx` is the run's record (`run.py`): `window` (the untimed-by-profiler
window: pages, seconds, latencies, results, counters, page shapes),
`traced` (the traced slice, the same keys, or None), `trace` (its
`trace.Trace`, or None), `setup_s`, `cfg` (the configuration file) and
`bench` (flops' view of it). A reader returns None when it finds nothing
to read; the run then leaves the metric out.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

from benchlib import flops
from reference.boxes import canvas_geometry

# K6's kernels (`tuatara_tpu_torch/csrc/vit.cu`): the blocks' GEMMs and
# their attention.
K6_KERNELS = r"anonymous namespace\)::(gemm_kernel|attention)<"


def craft_least_s(cfg: Dict, shapes: Iterable) -> float:
    """CRAFT's least time at peak over pages of these [h, w] shapes."""
    cache: Dict[tuple, float] = {}
    total = 0.0
    for h, w in shapes:
        key = (int(h), int(w))
        if key not in cache:
            ch, cw = canvas_geometry(key[0], key[1], cfg["ocr"])["canvas"]
            cache[key] = flops.craft_least_s(ch, cw, cfg["craft"], cfg["precision"])
        total += cache[key]
    return total


def words(run: Dict):
    """Every served word of a run's pages."""
    for _, res in run["results"]:
        for r in res or ():
            yield r


def parseq_least_s(cfg: Dict, run: Dict) -> float:
    """The live crops' PARSeq operations at the bf16 peak."""
    ops = sum(flops.crop_ops(cfg["parseq"], len(r["text"])) for r in words(run))
    return ops / flops.PEAK_OPS["bf16"]


def mfu(ctx) -> Optional[float]:
    """% of the peak: CRAFT's and the live crops' least time over the
    window's wall."""
    w = ctx.window
    if not w["pages"]:
        return None
    least = craft_least_s(ctx.cfg, w["shapes"]) + parseq_least_s(ctx.cfg, w)
    return 100.0 * least / w["seconds"]


def craft_roofline(ctx) -> Optional[float]:
    """% : CRAFT's least time over the device time of the kernels launched
    inside the benchmark's span around its forward."""
    if ctx.trace is None:
        return None
    dev = ctx.trace.range_kernel_s("bench_craft")
    if dev <= 0:
        return None
    return 100.0 * craft_least_s(ctx.cfg, ctx.traced["shapes"]) / dev


def k6_roofline(ctx) -> Optional[float]:
    """% : the live crops' encoder-block operations at the bf16 peak over
    K6's device time."""
    if ctx.trace is None:
        return None
    dev = ctx.trace.kernel_s(K6_KERNELS)
    n = sum(1 for _ in words(ctx.traced))
    if dev <= 0 or n == 0:
        return None
    return 100.0 * n * flops.k6_ops(ctx.cfg["parseq"]) / flops.PEAK_OPS["bf16"] / dev


def recognize_ms(ctx) -> Optional[float]:
    """Device ms a page of the kernels launched inside `tuatara_recognize`."""
    if ctx.trace is None or not ctx.traced["pages"]:
        return None
    return 1e3 * ctx.trace.range_kernel_s("tuatara_recognize") / ctx.traced["pages"]


def idle_share(ctx) -> Optional[float]:
    if ctx.trace is None or ctx.trace.wall_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s() / ctx.trace.wall_s


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (a failed page is +inf)."""
    v = sorted(values)
    return v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)]
