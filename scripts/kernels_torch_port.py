#!/usr/bin/env python3
"""Times SC (`stem_conv`, csrc/stem.cu), H1 (`lower_chains`,
csrc/hull.cu) and GG (`gelu_grad`, csrc/bias_act.cu) of one tree of the
PyTorch port on one CUDA card, at the calls its main paths give them, and
prints one JSON line ("kernel_times {...}").

The tree is `--root` (default: this script's own): its package is
imported and its kernels built, so a parent commit unpacked into a
directory that .gitignore lists is measured by its own code, with this
tree's chip_smoke phases 4g and 4f doing the work (`check_stem`: SC on the
four pages' production() canvases against its plain version, CUDA-event
and traced device time, cuDNN's conv beside it, the operation bound, the
edge shapes; `check_hull`: H1 on the rotated exact engine's five pages and
the stress and edge profiles, bit-equal to its plain version, event and
traced device time, records a call, the byte bound; `check_gelu_grad`
with `exhaustive=False`: GG on the calls of phase 7's two bf16 training
steps, recorded from the tree's own step, and at fit_recognizer's [256,
128, 1536], bit-equal to its plain version, event and traced device
time, the byte and operation bounds). The records a call are printed,
not held. To compare two trees, run this once for each, in turns
(parent, new, new, parent), in one call on the card:

    python3 scripts/kernels_torch_port.py [--root DIR] [--only stem|hull|gelu_grad]
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
    ap.add_argument("--only", choices=("stem", "hull", "gelu_grad"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernels_torch_port: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    import chip_smoke  # this tree's, whatever --root says

    sys.path.insert(0, root)
    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.kernels._build import build_all
    from tuatara_tpu_torch.utils.image import load_image

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; tree: {root}; package: {tuatara_tpu_torch.__file__}; "
          f"build: {build_all():.1f} s", flush=True)
    kinds = (args.only,) if args.only else ("hull", "stem", "gelu_grad")
    pages = {n: load_image(os.path.join(HERE, "images", f"{n}.png"))
             for n in chip_smoke.GEOMETRY_PAGES}
    main_pages = {n: pages[n] for n in chip_smoke.PAGES}
    out = {"card": card, "tree": root}
    cfg = tuatara_tpu_torch.OcrConfig
    if "hull" in kinds:
        rot = tuatara_tpu_torch.OcrEngine(cfg(box_mode="rotated"), weights_dir=chip_smoke.WEIGHTS)
        for img in pages.values():
            rot.run(img)  # warm
        reset_launches()
        for img in pages.values():
            rot.run(img)
        launches = dict(LAUNCHES)
        out["hull"] = chip_smoke.check_hull(rot, pages, launches, max_records=None)
    if "stem" in kinds:
        prod = tuatara_tpu_torch.OcrEngine(cfg.production(), weights_dir=chip_smoke.WEIGHTS)
        for img in main_pages.values():
            prod.run(img)  # warm
        reset_launches()
        for img in main_pages.values():
            prod.run(img)
        launches = dict(LAUNCHES)
        out["stem"] = chip_smoke.check_stem(prod, main_pages, launches)
    if "gelu_grad" in kinds:
        out["gelu_grad"] = gelu_grad(chip_smoke)
    print("kernel_times " + json.dumps(out), flush=True)
    return 0


def gelu_grad(chip_smoke):
    """GG on the calls of phase 7's two bf16 training steps (the tree's own
    step on chip_smoke's record, each call's g and v recorded) and at
    fit_recognizer's shape (`check_gelu_grad`)."""
    import numpy as np
    import torch

    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.kernels import bias_act as BA

    with np.load(chip_smoke.TRAIN_RECORD) as z:
        rec = {k: z[k] for k in z.files}
    calls, saved = [], BA.gelu_grad

    def record(g, v):
        calls.append((g.clone(), v.clone()))
        return saved(g, v)

    BA.gelu_grad = record
    reset_launches()
    try:
        chip_smoke.check_train_parity(rec, torch.bfloat16, "bf16")
    finally:
        BA.gelu_grad = saved
    return chip_smoke.check_gelu_grad(calls, LAUNCHES[BA.GG], exhaustive=False)


if __name__ == "__main__":
    sys.exit(main())
