#!/usr/bin/env python3
"""Drive the PyTorch port's main OCR path on one CUDA card and check it.

Run from the repo root with no arguments: `python3 chip_smoke.py`. Every
phase is fatal on failure; the script exits nonzero and prints no result
line without a CUDA device or outside the repo.

1. device:   require CUDA; print `nvidia-smi` name and power limit.
2. build:    compile the CUDA kernels (csrc/) and print the seconds.
3. main path: `image_to_data` at the default `OcrConfig()` (bf16) with
             the trained full-width weights in `evals/production_weights`
             on four pages read with the port's PNG reader. Launch counts
             are zeroed just before and read just after: every kernel must
             have run. Every page must give boxes with text. Prints boxes,
             first words and warm pages/sec.
4. kernels:  each kernel against its plain PyTorch version on the card, on
             the inputs the main path gives it (the four pages) and on
             seeded random masks at 384x384 and 512x384 with K = 256. All
             outputs must be equal. Times with CUDA events after warm-up;
             prints one {"kernels": [...]} line.
5. parity:   the same pages at compute_dtype float32 (TF32 off for convs
             and matmuls) against the JAX package's float32 result
             (tests/fixtures/torch_reference_production.json): at least
             95% of the reference words per page must be matched by a word
             with the same bbox and text.

The last line is {"ok": true, "device": {...}}.
"""

import faulthandler
import json
import os
import subprocess
import sys
import time

faulthandler.dump_traceback_later(1000, exit=True)

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "evals", "production_weights")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_reference_production.json")
PAGES = ("resume_example", "funsd_0001129658", "funsd_91372360", "table_english")
MIN_WORD_SHARE = 0.95
# H100 SXM peaks (NVIDIA data sheet, 700 W): memory rate, and the vector
# (non-tensor-core) rate used for the kernels' compares, adds and atomics.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(engine, pages):
    """(label, comb, hot, keep) on the card: each page's binarized heatmap
    from the main path's detector, then seeded random masks."""
    import numpy as np
    import torch

    from tuatara_tpu_torch.api import content_mask
    from tuatara_tpu_torch.ops.boxes import binarize

    cfg = engine.config
    cases = []
    for name, img in pages.items():
        h, w = img.shape[:2]
        scores = engine.detect(torch.from_numpy(img[None]).cuda())["scores"][0]
        comb, keep, hot = binarize(scores[:, :, 0], scores[:, :, 1],
                                   content_mask(h, w, cfg, "cuda"), cfg)
        cases.append((name, comb.contiguous(), hot.contiguous(), keep.contiguous()))
    rng = np.random.default_rng(0)
    for hh, ww in ((384, 384), (512, 384)):
        comb = rng.random((hh, ww)) < 0.55   # near the percolation threshold
        hot = comb & (rng.random((hh, ww)) < 0.05)
        keep = rng.random((hh, ww)) < 0.8
        cases.append((f"random{hh}x{ww}",) + tuple(
            torch.from_numpy(a).cuda() for a in (comb, hot, keep)))
    return cases


def check_kernels(engine, pages, launches):
    """Phase 4: every kernel equal to its plain version; times and bounds."""
    import torch

    from tuatara_tpu_torch.kernels import cc, stats
    from tuatara_tpu_torch.ops import connected_components as plain

    K = engine.config.max_boxes
    m = engine.config.min_component_area
    rows = {n: [] for n in (cc.K1, cc.K2, stats.K3)}
    for label, comb, hot, keep in kernel_cases(engine, pages):
        h, w = comb.shape
        n = h * w
        lab, aux = cc.label_components_aux(comb, hot)
        plab, paux = plain.label_components_aux(comb, hot)
        ok_map = cc.area_ok(lab, m)
        p_ok = plain.area_ok(lab, m)
        roots, _ = plain.component_roots_filtered(lab, K, aux, ok_map)
        got = stats.component_stats_nopeak(lab, keep, roots)
        ref = stats.component_stats_nopeak_plain(lab, keep, roots)
        torch.cuda.synchronize()
        n_roots = int((roots < plain.BIG).sum())
        checks = {
            cc.K1: ([lab, aux], [plab, paux],
                    lambda: cc.label_components_aux(comb, hot),
                    lambda: plain.label_components_aux(comb, hot),
                    n * (2 + 8), n * 12),
            cc.K2: ([ok_map], [p_ok], lambda: cc.area_ok(lab, m),
                    lambda: plain.area_ok(lab, m), n * (4 + 1), n * 4),
            stats.K3: (list(got), list(ref),
                       lambda: stats.component_stats_nopeak(lab, keep, roots),
                       lambda: stats.component_stats_nopeak_plain(lab, keep, roots),
                       n * 5 + K * 4 + (2 * h + 2 * w) * K * 4, n * 8),
        }
        for name, (outs, refs, kfn, pfn, nbytes, nops) in checks.items():
            err = max(float((a.long() - b.long()).abs().max()) if not a.is_floating_point()
                      else float((a - b).abs().max()) for a, b in zip(outs, refs))
            equal = all(torch.equal(a, b) for a, b in zip(outs, refs))
            if not equal:
                fail(f"{name} differs from its plain version on {label} "
                     f"(max abs err {err})")
            ms = cuda_ms(kfn, 50)
            pms = cuda_ms(pfn, 3, warmup=1)
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / VECTOR_OPS_PER_S * 1e3
            rows[name].append({"input": label, "shape": [h, w], "roots": n_roots,
                               "ms": ms, "plain_ms": pms, "bound_ms": max(bytes_ms, ops_ms),
                               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                               "max_abs_err": err})
            print(f"kernel {name:24s} {label:18s} {h}x{w} ms={ms:.4f} "
                  f"plain_ms={pms:.3f} bound_ms={max(bytes_ms, ops_ms):.5f}", flush=True)

    sources = {cc.K1: ("tuatara_tpu_torch/csrc/cc.cu", "tuatara_tpu/ops/pallas/cc.py:213"),
               cc.K2: ("tuatara_tpu_torch/csrc/cc.cu", "tuatara_tpu/ops/pallas/cc.py:146"),
               stats.K3: ("tuatara_tpu_torch/csrc/stats.cu",
                          "tuatara_tpu/ops/pallas/stats.py:172")}
    out = []
    for name, rs in rows.items():
        main = [r for r in rs if not r["input"].startswith("random")]

        def mean(key):
            return sum(r[key] for r in main) / len(main)

        out.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches.get(name, 0),
            "equal": True, "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": mean("ms"), "kernel_ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"), "bound_by": main[0]["bound_by"],
            "library_ms": None, "timed_on": "mean over the main path's pages",
            "random_ms": {r["input"]: r["ms"] for r in rs if r["input"].startswith("random")},
        })
    return out


def word_share(ref_words, got_words) -> float:
    """Share of reference words matched by a distinct port word with the
    same bbox and text."""
    pool = {}
    for w in got_words:
        key = (w["text"], tuple(w["bbox"]))
        pool[key] = pool.get(key, 0) + 1
    hit = 0
    for w in ref_words:
        key = (w["text"], tuple(w["bbox"]))
        if pool.get(key, 0) > 0:
            pool[key] -= 1
            hit += 1
    return hit / max(len(ref_words), 1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.kernels._build import build_all
    from tuatara_tpu_torch.utils.image import load_image

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    print(f"build: {build_all():.1f} s", flush=True)

    # 3. main path, default config (bf16)
    if not os.path.isdir(WEIGHTS):
        fail(f"weights not found: {WEIGHTS}")
    pages = {n: load_image(os.path.join(ROOT, "images", f"{n}.png")) for n in PAGES}
    t0 = time.perf_counter()
    engine = tuatara_tpu_torch.api.get_engine(tuatara_tpu_torch.OcrConfig(), WEIGHTS)
    print(f"engine load: {time.perf_counter() - t0:.1f} s", flush=True)
    reset_launches()
    results = {n: tuatara_tpu_torch.image_to_data(img, WEIGHTS) for n, img in pages.items()}
    launches = dict(LAUNCHES)
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    for name in ("label_components_aux", "area_ok", "component_stats_nopeak"):
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the main path")
    for name, words in results.items():
        if not words or not any(w["text"] for w in words):
            fail(f"page {name}: no boxes with text")
        print(f"bf16 {name}: {len(words)} boxes: "
              + " ".join(w["text"] for w in words[:10]), flush=True)
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages = {"detect_s": 0.0, "recognize_s": 0.0}
    for _ in range(reps):
        for img in pages.values():
            tuatara_tpu_torch.image_to_data(img, WEIGHTS)
            for k in stages:
                stages[k] += engine.last_timings[k]
    dt = time.perf_counter() - t0
    print(f"bf16 warm: {reps * len(pages) / dt:.3f} pages/s "
          f"({dt / (reps * len(pages)) * 1e3:.1f} ms/page; detect "
          f"{stages['detect_s'] / (reps * len(pages)) * 1e3:.1f} ms, recognize "
          f"{stages['recognize_s'] / (reps * len(pages)) * 1e3:.1f} ms)", flush=True)

    # 4. kernels vs their plain versions
    kernels = check_kernels(engine, pages, launches)

    # 5. float32 parity with the JAX reference
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(FIXTURE) as f:
        ref = json.load(f)["pages"]
    f32 = tuatara_tpu_torch.OcrEngine(
        tuatara_tpu_torch.OcrConfig(compute_dtype="float32"), weights_dir=WEIGHTS)
    for name, img in pages.items():
        got = f32.run(img)
        share = word_share(ref[name]["words"], got)
        print(f"fp32 parity {name}: {share:.4f} of {len(ref[name]['words'])} "
              f"JAX words matched ({len(got)} port words)", flush=True)
        if share < MIN_WORD_SHARE:
            fail(f"fp32 parity on {name}: {share:.4f} < {MIN_WORD_SHARE}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
