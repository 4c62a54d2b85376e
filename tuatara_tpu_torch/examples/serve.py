"""Serving-loop example, the counterpart of the repo's examples/serve.py:
sustained OCR over a stream of page batches with a persistent engine,
warm-up before the timed region, the pipelined `run_stream` (uploads on a
side stream, `depth` batches in flight), mixed-size batching, line
grouping, the serving counters and the opt-in int8 detector.

    python -m tuatara_tpu_torch.examples.serve page1.png page2.png ... [--weights DIR]
        [--batch 16] [--batches 8] [--quantized [--calibrate]] [--lines] [--device D]

With one image given it is replicated into a stream of `--batches`
batches, so the pipeline still shows sustained throughput.
"""

import argparse
import dataclasses
import time

import numpy as np

from tuatara_tpu_torch.api import OcrEngine
from tuatara_tpu_torch.config import DEFAULT_CONFIG
from tuatara_tpu_torch.utils.image import load_image


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tuatara_tpu_torch.examples.serve")
    ap.add_argument("images", nargs="+")
    ap.add_argument("--weights", default=None, help="weights directory (omit: random weights)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--batches", type=int, default=8,
                    help="stream length when replicating a single image")
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--calibrate", action="store_true",
                    help="with --quantized: freeze static int8 activation scales from the "
                         "given pages before the timed stream")
    ap.add_argument("--lines", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.batches < 1:
        ap.error("--batch and --batches must be >= 1")
    if args.calibrate and not args.quantized:
        ap.error("--calibrate requires --quantized")

    cfg = DEFAULT_CONFIG
    if args.quantized:
        cfg = dataclasses.replace(cfg, quantized_serving=True)
    engine = OcrEngine(cfg, weights_dir=args.weights, device=args.device)

    pages = [load_image(p, keep_gray=True) for p in args.images]
    shapes = {p.shape for p in pages}

    if args.calibrate:
        n = engine.calibrate([p[None] for p in pages])
        print(f"calibrated {n} layers from {len(pages)} page(s)")

    if len(shapes) > 1:
        # Mixed sizes: batches grouped by shape, the original order kept.
        engine.run_mixed(pages, max_batch=args.batch)  # untimed warm-up pass
        t0 = time.perf_counter()
        results = engine.run_mixed(pages, max_batch=args.batch)
        dt = time.perf_counter() - t0
        print(f"run_mixed: {len(pages)} pages, {len(shapes)} shapes, "
              f"{len(pages) / dt:.1f} pages/sec")
    else:
        # One shape: the pipelined loop over all pages (the last batch
        # filled with copies of its last page).
        if len(pages) == 1:
            batches = [np.broadcast_to(
                pages[0], (args.batch,) + pages[0].shape).copy()] * args.batches
        else:
            batches = []
            for i in range(0, len(pages), args.batch):
                chunk = pages[i:i + args.batch]
                chunk += [chunk[-1]] * (args.batch - len(chunk))
                batches.append(np.stack(chunk))
        engine.run_pages(batches[0])  # warm-up on a batch of the stream's shape
        t0 = time.perf_counter()
        stream = engine.run_stream(batches, prefetch=4, depth=2)
        dt = time.perf_counter() - t0
        results = stream[-1]
        n = sum(b.shape[0] for b in batches)
        print(f"run_stream: {n} pages in {dt:.2f}s = {n / dt:.1f} pages/sec")

    sample = results[0] if results and isinstance(results[0], list) else results
    if args.lines:
        from tuatara_tpu_torch.ops.grouping import group_lines

        sample = group_lines(sample)
    for item in sample[:5]:
        print(item)
    print("engine.stats:", {k: round(v, 3) if isinstance(v, float) else v
                            for k, v in engine.stats.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
