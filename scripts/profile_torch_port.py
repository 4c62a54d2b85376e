#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one CUDA card.

Runs `OcrEngine.run` (what `image_to_data` calls) at the default
`OcrConfig()` (bf16), with `--config latency` at `OcrConfig.latency()`
(fused recognizer kernels K6, K7), with `--config production` at
`OcrConfig.production()` (int8 CRAFT in front of K6, K7; `--calibrate`
first freezes static activation scales from the first two pages), or with
`--config lowthresh` at
`OcrConfig(text_threshold=0.3)` (detection kernels K4, K5), with
`--config rotated` / `rotated_pca` at `OcrConfig(box_mode="rotated")`
(exact fit with the hull kernel H1, or the PCA fit), with `--config
tiled` / `tiled512` at `OcrConfig(tiled_detection=True)` at canvas 1024
(only table_english tiles) or 512 (all four pages tile), and with
`--fused-stage1` with CRAFT's stage 1 through K8; on
`evals/production_weights` and the four main-path pages, it warms up, then
traces `--reps` passes with `torch.profiler` (CPU + CUDA activity). Prints:

* the card (nvidia-smi name and power limit);
* wall time per page, split into detect and recognize as the engine
  records them (`last_timings`: detect from the dispatch to the combined
  fetch, which includes a speculative recognition, and recognize a
  correctly sized recognition pass where one ran);
* device busy time per page (union of CUDA kernel and memcpy intervals on
  the trace) and the device's idle share of the wall time;
* CRAFT's device time per page: the kernels launched inside its forward
  (a `record_function` range around `engine.craft`, its launches matched
  to their kernels by correlation id) and their number, the figures that
  say whether K8 (`--fused-stage1`) beats the cuDNN chain end to end and
  what int8 CRAFT (`--config production`) costs against bf16;
* the CUDA kernels with the most device time, grouped by name, and the
  number of kernel launches per page.

Writes the chrome trace to build/profile_torch_port_<config>.json.
Usage: python3 scripts/profile_torch_port.py [--reps N]
       [--config default|latency|production|lowthresh|rotated|rotated_pca|tiled|tiled512]
       [--calibrate] [--fused-stage1]
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "evals", "production_weights")
PAGES = ("resume_example", "funsd_0001129658", "funsd_91372360", "table_english")


def busy_us(events):
    """Length of the union of [start, end) intervals, in microseconds."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def range_kernels(events, name):
    """The kernel records launched inside the CPU ranges called `name`: the
    runtime and driver calls (cudaLaunchKernel, cuLaunchKernel and the
    like) that fall in a range, matched to their kernels by correlation
    id."""
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == name]
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})
            and any(a <= e["ts"] <= b for a, b in ranges)}
    return [e for e in events if e.get("cat") == "kernel"
            and e.get("args", {}).get("correlation") in corr]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--config", choices=("default", "latency", "production", "lowthresh",
                                         "rotated", "rotated_pca", "tiled", "tiled512"),
                    default="default")
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--fused-stage1", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import tuatara_tpu_torch
    from tuatara_tpu_torch.models import craft
    from tuatara_tpu_torch.utils.image import load_image

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    print(f"config: {args.config}; calibrated: {args.calibrate}; fused stage 1: "
          f"{args.fused_stage1}")
    if args.fused_stage1:
        craft.FUSED_STAGE1 = "on"
    pages = [load_image(os.path.join(ROOT, "images", f"{n}.png")) for n in PAGES]
    cfg = tuatara_tpu_torch.OcrConfig
    config = {"default": cfg,
              "latency": cfg.latency,
              "production": cfg.production,
              "lowthresh": lambda: cfg(text_threshold=0.3),
              "rotated": lambda: cfg(box_mode="rotated"),
              "rotated_pca": lambda: cfg(box_mode="rotated", rotated_fit="pca"),
              "tiled": lambda: cfg(tiled_detection=True),
              "tiled512": lambda: cfg(tiled_detection=True, canvas_size=512)}[args.config]()
    engine = tuatara_tpu_torch.OcrEngine(config, weights_dir=WEIGHTS)
    if args.calibrate:
        engine.calibrate([img[None] for img in pages[:2]])
    craft_forward = engine.craft.forward

    def traced_craft(*a, **kw):
        with torch.profiler.record_function("craft"):
            return craft_forward(*a, **kw)

    engine.craft.forward = traced_craft
    for img in pages:  # warm-up: cuDNN plans, allocator, kernel build
        engine.run(img)
    torch.cuda.synchronize()

    n_pages = args.reps * len(pages)
    stages = {"detect_s": 0.0, "recognize_s": 0.0}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            for img in pages:
                engine.run(img)
                for k in stages:
                    stages[k] += engine.last_timings[k]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, f"profile_torch_port_{args.config}"
                         f"{'_stage1' if args.fused_stage1 else ''}.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        every = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    events = [e for e in every if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    craft_kernels = range_kernels(every, "craft")
    craft_ms = sum(e["dur"] for e in craft_kernels) / 1e3
    kernels = [e for e in events if e["cat"] == "kernel"]
    busy = busy_us(events) / 1e3
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e["name"], [0.0, 0])
        d[0] += e["dur"] / 1e3
        d[1] += 1
    print(f"wall: {wall / n_pages * 1e3:.2f} ms/page ({n_pages / wall:.2f} pages/s); "
          f"detect {stages['detect_s'] / n_pages * 1e3:.2f} ms, recognize "
          f"{stages['recognize_s'] / n_pages * 1e3:.2f} ms")
    print(f"device busy: {busy / n_pages:.2f} ms/page; idle share "
          f"{1 - busy / (wall * 1e3):.3f}; kernel launches/page "
          f"{len(kernels) / n_pages:.0f}")
    total_k = sum(v[0] for v in by_name.values())
    print(f"kernel time: {total_k / n_pages:.2f} ms/page; CRAFT kernels "
          f"{craft_ms / n_pages:.3f} ms/page, {len(craft_kernels) / n_pages:.0f} launches/page")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ms / n_pages:8.3f} ms/page {cnt / n_pages:7.1f} launches/page "
              f"{ms / total_k * 100:5.1f}%  {name[:110]}")
    ours = {n: v for n, v in by_name.items()
            if any(f"(anonymous namespace)::{k}" in n
                   for k in ("cc_", "area_", "component_stats", "gemm_kernel",
                             "attention", "decode_kernel", "fused_conv_pool",
                             "lower_chains"))}
    print("port kernels: " + json.dumps(
        {n: {"ms_per_page": v[0] / n_pages, "launches_per_page": v[1] / n_pages}
         for n, v in ours.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
