#!/usr/bin/env python3
"""Times BA (`bias_act`, csrc/bias_act.cu) of one tree of the PyTorch port
on one CUDA card, at the calls of the default path's first page, and
prints one JSON line ("bias_act_times {...}").

The tree is `--root` (default: this script's own): its package is
imported and its kernels built, so a parent commit unpacked into a
directory that .gitignore lists is measured by its own code, with this
tree's chip_smoke phase 10a timing (`bias_act_calls`, `time_relu_mode`,
`time_f32_mode`, `time_gelu_mode`: CUDA events, traced device time, host
time a call beside the pair each mode replaces, byte bounds). To compare
two trees, run this once for each, in turns (parent, new, new, parent), in
one call on the card:

    python3 scripts/time_bias_act.py [--root DIR]
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_bias_act: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    import chip_smoke  # this tree's, whatever --root says

    sys.path.insert(0, root)
    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels._build import build_all
    from tuatara_tpu_torch.utils.image import load_image

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; tree: {root}; package: {tuatara_tpu_torch.__file__}; "
          f"build: {build_all():.1f} s", flush=True)
    engine = tuatara_tpu_torch.api.get_engine(tuatara_tpu_torch.OcrConfig(), chip_smoke.WEIGHTS)
    page = chip_smoke.PAGES[0]
    img = load_image(os.path.join(root, "images", f"{page}.png"))
    engine.run(img)  # warm
    calls, _, f32_first, gelu_first = chip_smoke.bias_act_calls(engine, {page: img})
    relu = [c for c in calls if c[4] == 1]
    out = {"card": card, "tree": root, "page": page,
           "relu": chip_smoke.time_relu_mode(relu),
           "f32": chip_smoke.time_f32_mode(f32_first),
           "gelu": chip_smoke.time_gelu_mode(gelu_first)}
    print("bias_act_times " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
