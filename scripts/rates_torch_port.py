#!/usr/bin/env python3
"""Untraced rates of one tree of the PyTorch port on one CUDA card: warm
pages/s of the default `OcrConfig()` and `OcrConfig.latency()` engines on
the four main-path pages (`chip_smoke.warm_rates`, the two engines in
turns), and with `--train` the full-width bf16 training steps' ms a step
(`chip_smoke.train_rates`: fit_recognizer's, fit_detector's and the joint
`train_step`'s).

The tree is `--root` (default: this script's own), whose package,
`chip_smoke.py`, weights and pages are used, so a parent commit unpacked
into a directory that .gitignore lists is measured by its own code. To
compare two trees, run this once for each, in turns (parent, new, new,
parent), in one call on the card:

    python3 scripts/rates_torch_port.py [--root DIR] [--reps N] [--train]
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("rates_torch_port: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels._build import build_all
    from tuatara_tpu_torch.utils.image import load_image

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"card: {card}; tree: {root}; package: {tuatara_tpu_torch.__file__}", flush=True)
    print(f"build: {build_all():.1f} s", flush=True)
    pages = {n: load_image(os.path.join(root, "images", f"{n}.png")) for n in chip_smoke.PAGES}
    cfg = tuatara_tpu_torch.OcrConfig
    engines = {name: tuatara_tpu_torch.api.get_engine(config, chip_smoke.WEIGHTS)
               for name, config in (("default", cfg()), ("latency", cfg.latency()))}
    for engine in engines.values():  # warm-up: cuDNN plans, allocator, kernel loads
        for img in pages.values():
            engine.run(img)
    chip_smoke.warm_rates(engines, pages, reps=args.reps)
    if args.train:
        chip_smoke.train_rates(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
