#!/usr/bin/env python3
"""One run of one benchmark cell of tuatara_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`)
names a configuration (`benchmark/configs/`) and a traffic mix
(`benchmark/traffic/`). Set-up makes the mix's pool of pages from the
seed, builds the engine from the committed weights, and warms up every
shape the pool holds. The window then drives the program's public entry
for `--seconds`, a closed loop cycling through the pool. With `--trace 1`
a bounded slice (the mix's `trace_batches` or `trace_pages`) follows under
`torch.profiler`, kept in memory, and the run reports the cell's per-layer
metrics (`benchmark/metrics/<name>.py`) instead of its end-to-end ones.

Once the window has closed and the program is freed, a sample of the
pages it served goes through the plain reference (`benchmark/reference/`:
fp32, the convs the configuration states in int8 in int8), and `correct`
says whether every number stayed within its limit
(`benchmark/limits/<cell>.json`; `benchlib/check.py`). An earlier line
says what the host did during the window (`benchlib/host.py`).

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error too. Without a CUDA
card, or with fewer than the cell asks for, the run exits with code 3 and
prints no result; if JAX or the JAX package was loaded, with code 4.
"""

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "tuatara_tpu"}


def process_start() -> float:
    """The wall time at which this process started (from /proc), or this
    module's import time where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def check_config(ocr, cfg, weights) -> None:
    """The configuration file is what runs: the preset's fields and the
    weights' architecture equal the file's."""
    for k, v in cfg["ocr"].items():
        got = getattr(ocr, k)
        if (list(got) if isinstance(got, tuple) else got) != v:
            raise ValueError(f"{cfg['name']}: OcrConfig.{k} is {got!r}, the file says {v!r}")
    with open(os.path.join(weights, "config.json")) as f:
        meta = json.load(f)
    for k in ("craft", "parseq", "charset"):
        if meta[k] != cfg[k]:
            raise ValueError(f"{cfg['name']}: the weights' {k} differs from the file's")


class Capture:
    """CRAFT's score maps as the window computes them, kept by pool page for
    the first pass over the pool (the window starts at the pool's first
    page and calls CRAFT in page order): what `correct` holds against the
    reference's maps. Keeping them adds their memory (~1.5 MB a page) and
    no device work."""

    def __init__(self, n: int):
        self.n, self.seen, self.maps, self.on = n, 0, {}, False

    def start(self) -> None:
        self.seen, self.maps, self.on = 0, {}, True

    def add(self, scores) -> None:
        if self.on:
            for i in range(scores.shape[0]):
                if self.seen < self.n:
                    self.maps[self.seen] = scores[i]
                self.seen += 1


def setup_cell(spec, cell, seed: int, device: str, mix_override=None):
    """The cell's engine, driver and pool, warmed up. -> a namespace."""
    import torch

    import tuatara_tpu_torch as T
    from tuatara_tpu_torch import api
    from benchlib import drivers
    from traffic.pages import generate

    cfg = spec.config(cell["config"])
    mix = dict(spec.mix(cell["traffic"]), **(mix_override or {}))
    ocr = getattr(T.OcrConfig, cfg["preset"])(**cfg.get("overrides", {}))
    weights = os.path.join(ROOT, cfg["weights"])
    check_config(ocr, cfg, weights)
    pool = generate(ROOT, mix, seed)
    if mix["entry"] == "run_stream":
        engine = T.OcrEngine(ocr, weights_dir=weights, device=device)
        driver = drivers.StreamDriver(engine, pool, mix)
        n_trace = {"batches": mix["trace_batches"]}
    elif mix["entry"] == "image_to_data":
        engine = api.get_engine(ocr, weights, device)

        def call(page):
            return T.image_to_data(page, weights, config=ocr, device=device)

        driver = drivers.PageDriver(call, engine, pool)
        n_trace = {"pages": mix["trace_pages"]}
    else:
        raise ValueError(f"unknown entry {mix['entry']!r}")
    craft_forward = engine.craft.forward
    capture = Capture(len(pool))

    def spanned_craft(*a, **kw):
        with torch.profiler.record_function("bench_craft"):
            out = craft_forward(*a, **kw)
        capture.add(out[0])
        return out

    engine.craft.forward = spanned_craft
    driver.warm()
    return SimpleNamespace(cfg=cfg, mix=mix, ocr=ocr, weights=weights, pool=pool,
                           engine=engine, driver=driver, n_trace=n_trace, capture=capture)


def free(c, device: str) -> None:
    """Drop the program's engine and its device memory."""
    import torch

    from tuatara_tpu_torch import api

    api.clear_engines()
    c.engine = c.driver = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def judge(c, window, seed: int, device: str):
    """The reference's reading of a sample of the window's pages. ->
    (correct, [(name, value, limit)], the sample's size)."""
    import torch

    from benchlib import check
    from reference.pipeline import Reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference.of_config(c.weights, c.cfg, device)
    sampled = check.sample(window["results"], c.limits["sample_pages"], seed)
    picked = [i for i, _ in sampled]
    wants = check.reference_maps(ref, c.pool, picked, c.mix.get("pages_per_batch", 1))
    values = check.numbers(ref, [c.pool[i] for i in picked], [r for _, r in sampled],
                           [c.capture.maps.get(i) for i in picked], wants)
    values["repeats_differ"] = check.repeats_agree(window["results"])
    values["failed"] = window["failed"]
    ok, rows = check.judge(values, dict(c.limits["limits"], repeats_differ=0, failed=0))
    return ok, rows, sampled


def main(argv=None, device: str = "cuda", mix_override=None) -> int:
    """One run. `device` and `mix_override` serve the benchmark's own CPU
    tests (a small mix, no card); a run on the card takes neither."""
    args = parse(argv)
    t_start = process_start()
    set_caches()
    for p in (BENCH, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from benchlib.host import HostWatch
    from benchlib.spec import Spec, reader
    from benchlib.trace import Trace

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    if device == "cuda":
        if not torch.cuda.is_available():
            print("run.py: no CUDA device; the benchmark does not run on the CPU",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell["chips"]:
            print(f"run.py: {cell['name']} needs {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 3
    print(f"card: {card_line() if device == 'cuda' else device}; torch {torch.__version__}",
          flush=True)
    c = setup_cell(spec, cell, args.seed, device, mix_override)
    c.limits = spec.limits(cell["name"])
    setup_s = time.time() - t_start
    print(f"set-up: {setup_s:.3f} s", flush=True)

    watch = HostWatch()
    c.capture.start()
    watch.start()
    window = c.driver.run(seconds=args.seconds)
    host = watch.stop(window["times_s"])
    c.capture.on = False
    boxes = [len(r) for _, r in window["results"] if r is not None]
    print(f"window: {window['pages']} pages in {window['seconds']:.3f} s; boxes a page "
          f"mean {sum(boxes) / max(len(boxes), 1):.1f}, min {min(boxes, default=0)}, "
          f"max {max(boxes, default=0)}; counters {window['stats']}", flush=True)
    print(f"host during the window: {json.dumps(host)}", flush=True)
    traced = trace = None
    if args.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            traced = c.driver.run(**c.n_trace)
        trace = Trace(prof, traced["seconds"])
        del prof
        slow = (traced["seconds"] / traced["pages"]) / (window["seconds"] / window["pages"])
        paced = window["seconds"] / window["pages"] * traced["pages"]
        print(f"traced slice: {traced['pages']} pages in {traced['seconds']:.3f} s; "
              f"tracing overhead {100 * (slow - 1):.1f}% of the untraced s/page; device idle "
              f"{1 - trace.busy_s() / trace.wall_s:.4f} of the traced wall, "
              f"{1 - trace.busy_s() / paced:.4f} of the same pages at the untraced pace",
              flush=True)
    mem_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if device == "cuda" else device

    # The program's state is freed before the reference runs.
    free(c, device)
    t_check = time.time()
    ok, rows, sampled = judge(c, window, args.seed, device)
    print(f"check: {len(sampled)} pages, {sum(len(r or ()) for _, r in sampled)} words in "
          f"{time.time() - t_check:.1f} s", flush=True)

    ctx = SimpleNamespace(window=window, traced=traced, trace=trace, setup_s=setup_s,
                          cfg=c.cfg)
    metrics = {}
    for m in spec.metrics(cell["name"], bool(args.trace)):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            print(f"run.py: {m['name']} found nothing to read in this run", file=sys.stderr)
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind, "count": 1,
           "memory_peak_bytes": mem_peak}
    result = {"correct": ok, "attempted": window["pages"], "failed": window["failed"],
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.wall_s
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    # A number that is not finite (a page whose maps were not kept) is
    # written as text: JSON has no infinity.
    result["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                        for name, v, lim in rows}

    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"run.py: the process loaded {loaded}; the benchmark runs no JAX", file=sys.stderr)
        return 4
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
