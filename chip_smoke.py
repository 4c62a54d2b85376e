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
3b. latency: the same pages through `image_to_data(..., config=
             OcrConfig.latency())`: the /32 canvas, the 16-first slab ladder
             and the fused recognizer kernels K6 (`vit_blocks`) and K7
             (`greedy_decode`). Counts zeroed just before and read just
             after: K1-K3, K6 and K7 must each have run. Then warm pages/sec
             of the default and the latency path, in turns in this call.
3d. production: the same pages through `image_to_data(..., config=
             OcrConfig.production())`: int8 CRAFT (dynamic activation
             scales) in front of K6 and K7. Page by page, counts zeroed
             just before and read just after: K1-K3, K6, K7 and the int8
             convolutions (`int8_conv`, every quantized layer) must each
             have run on every page, and every page must give boxes with
             text. Then calibration on the card: a second production engine
             calibrates on two pages, saves `calibration.npz` (under
             build/), and a third engine loads it from its weights
             directory: the scales must be equal, and so must the three
             calibrated engines' results on the four pages.
             Warm pages/sec of the default path, latency() and production()
             (dynamic and calibrated), the four in turns in this call.
3e. serving: the dense batch (funsd_0001129658 read gray, 16 pages in
             one [16, H, W] batch; six batches `pages + i % 5`, as
             bench.py builds them) through the default engine, latency()
             and 3d's calibrated production() engine. Each: a loop of
             `run_pages` from a cold speculation state must dispatch every
             batch after the first speculatively (engine.stats hits +
             misses = 5); `run_stream(prefetch=4, depth=2)` from a cold
             state, counts zeroed just before and read just after, must
             equal the loop element by element, with K1-K3 launched on
             every page, K6 and K7 on every batch of the fused presets and
             every int8 conv on every batch under production(); `run_mixed`
             over the four pages and two dense pages (max_batch=2) must
             equal `run` on each. Prints the loop's and the stream's warm
             pages/s in turns, their device busy ms/page and idle share
             over one traced run each, the stream's peak memory and the
             phase's seconds. First, what those equalities rest on: the
             recognizer head's padded product must give rows 0-15 the
             same values at 32 to 4096 rows (the unpadded 95-column one
             printed beside it), and float CRAFT batched beside a page at
             a time (scores and ms/page on the 16 dense pages) is printed.
3f. geometry: rotated boxes and tiled detection. At fp32, TF32
             off: each variant of tests/fixtures/torch_reference_rotated.json
             (box_mode="rotated", fit exact and pca) and _tiled.json
             (tiled_detection at canvas 1024, where only table_english
             tiles, and 512, where the four pages do) on the four pages and
             rotated_text, page by page with counts zeroed just before and
             read just after: >= 95% of JAX's words with the same bbox and
             text, K1-K3 on every page, H1 (`lower_chains`) on every page
             of the exact fit that does not tile and on no other.
             production(tiled_detection=True, canvas_size=512): each tiled
             page's tiles as one int8 CRAFT batch (rows counted by a
             forward hook), every int8 conv and K1-K3 launched. The tiled
             engine at canvas 512: run_mixed over the five pages and a
             mirrored table_english equal to run; run_stream equal to a
             run_pages loop. Warm pages/s of default, latency(), rotated
             exact and pca, tiled at canvas 1024 and 512, in turns; each
             one's `detect` under torch.cuda.set_sync_debug_mode("error"):
             fatal if a rotated or tiled engine reads the host where the
             default does not.
             latency(box_mode="rotated") on the dense batch under phase
             3e's gates, H1 launched on every page.
3c. path A:  the same pages at `OcrConfig(text_threshold=0.3)`, the
             detection branch text_threshold < low_text: counts zeroed just
             before and read just after, K4 (`label_components`), K2 and K5
             (`component_stats`) must have run on every page and K1, K3 not
             at all. Prints each page's box count beside the default
             path's.
4. kernels:  each kernel against its plain PyTorch version on the card, on
             the inputs the main path gives it (the four pages), on seeded
             random masks at 384x384 and 512x384, and on masks that stress
             the labeler (`stress_masks`: full-width rows at widths 384 and
             512, a serpentine, a comb, pixels that touch only diagonally,
             all foreground), with K = 256. All outputs must be equal. Times
             with CUDA events after warm-up (`ms`), and device time per call
             (`device_ms`) and records per call from the kernel and memset
             records of a `torch.profiler` trace of 10 calls (null where the
             trace lost records); K1 may take at most 3, K4 at most 2, K3
             and K5 at most 1 launch a call. K3 and K5 also run (gated the
             same way) on each page at K = 16, at K = 1024 on the diagonal
             and random masks (roots shuffled), on an empty mask (every
             root padding, every peak -1e30) and on roots chosen to share
             a bucket of their hash table (printed; the bucket is checked
             against csrc/stats.cu's own hash), on a 509x381 crop and at
             K = 4096; K = 8193 must raise ValueError. K2 also runs (equal
             to its plain version, at most 1 record a call) at min_area 1,
             2, 10 and 16 on the pages, the random and stress masks, and
             masks built for its window (`area_stress_masks`: components
             of area m-1, m and m+1 as lines, staircases and an L across
             tile and image borders; all foreground; empty) at 512x384 and
             509x381. Prints one {"kernels": [...]} line.
    Also on the stitched heatmaps of tiled pages (the four
             pages at canvas 512; table_english and four funsd_0001129658
             pages joined 2 x 2 into one 2000 x 1508 page at canvas 1024),
             in the `other_inputs` of the kernels line.
4f. H1:      `lower_chains` (csrc/hull.cu) against its plain version, bit
             for bit (stacks and counts), on the dilated profiles the
             rotated exact engine builds on 3f's five pages, seeded random
             profiles at K = 256 and degenerate ones (nothing valid, one
             row, one column, H = 1, K = 1, chains of 194 vertices, past
             the budget of 192);
             at most 2 records a call (the kernel and the stacks' memset);
             ms, device ms, plain ms and the byte bound, and the edge
             sweep's (`sweep_chains`) device ms a page, its corners equal
             to the CPU's within 1e-4 (the same edge wins). Its entry
             joins the kernels line.
4c. K4, K5:  the same, on path A's inputs (hot at text_threshold 0.3, the
             normalized region map): labels, the four count planes and the
             peak (-1e30 in empty slots) equal bit for bit; ms/call, traced
             device ms/call, device ms/page (device ms/call x launches/page
             in 3c) and the byte bound.
4b. recognizer kernels: K6 and K7 against their plain versions on the
             slabs the latency path gives them on the four pages and on a
             seeded random [32, 128, 384]: K6's output, and the final
             memory (after the encoder's last LayerNorm), within a relative
             (Frobenius) error of 7e-3 (bf16 roundings flipped by another
             sum order grow through 12 blocks), and a control that must
             exceed it: the default lowering's eager block chain (erf GELU)
             on the same input; K7's ids equal up to the first EOS on >= 99%
             of crops and its step-0 logits within 5e-2. Times, bounds
             (K7's bytes counted from the tiles' steps and tokens on each
             input), beside K6 the eager block chain (cuBLAS) at the same N.
             K6's device time per encode split by launch role (LN1+QKV,
             attention, out-projection, LN2+fc1, fc2; `torch.profiler`,
             whose kernel records a call give the launches an encode), each
             GEMM beside the device time of `torch.matmul` of its shapes;
             K6 on seeded random blocks at an MLP width of 1280 (fc1's
             64 x 128 tiles) under the same limit; K7's
             time per step (the call over its longest tile's steps) and at
             4, 8 and 16 crops x 4 and 6 CTAs per cluster. K6 also runs on
             S = 64 slabs, each real slab's first 64 token rows (the 32x64
             crops of `rec_width=64`), under the same limit and control.
4d. K8:      `fused_conv_pool` on the four pages' real conv1_1 -> ReLU
             activations (the default canvases, B = 1, in the trunk's
             channels_last layout), and on funsd_0001129658's repeated 16
             times (B = 16, the dense serving batch), with CRAFT's packed
             conv1_2 weights, against its plain version: relative
             (Frobenius) error within 1e-3, and a control that must exceed
             it, the plain version with the 3x3 taps flipped. Timed (CUDA
             events and traced device time) beside the cuDNN chain the port
             runs otherwise (bf16 conv2d -> relu -> max_pool2d).
4e. int8 conv: on funsd_0001129658's real trunk activations under
             production() (a 3x3 layer, the dilated fc6 and a decoder
             conv1a/conv1b), the card's int32 sums (`kernels/int8.py`:
             im2col + torch._int_mm) must equal those of a float64 convolution
             of the same int8 operands on the card (exact) everywhere, and
             an int64 matmul on the host at 256 sampled pixels. Timed beside
             the bf16 cuDNN convolution of the same shapes; the card's
             dequant (torch.addcmul, an fma) is compared with its float64
             form on the host (informational: mismatched values
             counted). Prints one {"int8_conv": ...} line.
5. parity:   the same pages at compute_dtype float32 (TF32 off for convs
             and matmuls) against the JAX package's float32 result
             (tests/fixtures/torch_reference_production.json): at least
             95% of the reference words per page must be matched by a word
             with the same bbox and text. The same for path A against
             tests/fixtures/torch_reference_lowthresh.json.
6. synthetic: the 16 held-out synthetic pages of
             tests/fixtures/torch_synthetic_pages.npz through
             `latency(canvas_size=256, max_boxes=32, rec_buckets=(32,))`:
             at least 98% of the JAX engine's recorded words matched by a
             distinct word with the same text and bbox IoU >= 0.5, and word
             accuracy against the truths at most 0.02 below the JAX
             engine's recorded accuracy.
6c. synthetic production: the same 16 pages through `production(
             canvas_size=256, max_boxes=32, rec_buckets=(32,))` against the
             JAX production() record tests/fixtures/torch_synthetic_
             production.json, under phase 6's gates; the int8 convs must
             have run.
6b. path B:  `models.craft.FUSED_STAGE1 = "on"`: phase 6 again with counts
             zeroed just before and read just after (K8 must have run),
             under the same gates; then the default path's transcripts of
             the four pages with K8, beside those without (informational),
             and the two gray pages read as [H, W] (a 1-channel canvas
             broadcast to conv1_1): K8 must run on each and every page must
             give boxes with text. The gate is restored after.

The last line is {"ok": true, "device": {...}}.
"""

import faulthandler
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "evals", "production_weights")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_reference_production.json")
FIXTURE_LOW = os.path.join(ROOT, "tests", "fixtures", "torch_reference_lowthresh.json")
FIXTURE_ROTATED = os.path.join(ROOT, "tests", "fixtures", "torch_reference_rotated.json")
FIXTURE_TILED = os.path.join(ROOT, "tests", "fixtures", "torch_reference_tiled.json")
LOW_THRESHOLD = 0.3  # text_threshold of path A, below the default low_text 0.4
SYNTHETIC = os.path.join(ROOT, "tests", "fixtures", "torch_synthetic_pages")
SYNTHETIC_PRODUCTION = os.path.join(ROOT, "tests", "fixtures", "torch_synthetic_production.json")
PAGES = ("resume_example", "funsd_0001129658", "funsd_91372360", "table_english")
GRAY_PAGES = ("funsd_0001129658", "funsd_91372360")  # gray PNG files
GEOMETRY_PAGES = PAGES + ("rotated_text",)  # phase 3f's pages
MIN_WORD_SHARE = 0.95
K6_MAX_REL = 7e-3
K7_MIN_IDS = 0.99
K7_MAX_STEP0 = 5e-2
K7_TILES = ((4, 4), (4, 6), (8, 4), (8, 6), (16, 4), (16, 6))  # (crops, CTAs) per cluster
K8_MAX_REL = 1e-3
K8_BATCH, K8_BATCH_PAGE = 16, "funsd_0001129658"  # BASELINE.md config 1's dense batch
DENSE_STREAM = 6  # batches of the dense batch in phase 3e's stream, as bench.py builds them
MIN_AGREEMENT = 0.98
SWEEP_MAX_DIFF = 1e-4  # the edge sweep's corners, card against CPU (another edge: >= 1 px)
K2_MIN_AREAS = (1, 2, 10, 16)
INT8_LAYERS = ("vgg/conv2_2/conv", "fc/fc6", "up/upconv2/conv1a", "up/upconv2/conv1b")
INT8_PAGE = "funsd_0001129658"
MAX_ACC_DROP = 0.02
# H100 SXM peaks (NVIDIA data sheet, 700 W): memory rate, the vector
# (non-tensor-core) rate used for the kernels' compares, adds and atomics,
# and the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def mean_of(values):
    """The mean of the values that were measured (not None), else None."""
    have = [v for v in values if v is not None]
    return sum(have) / len(have) if have else None


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


def stress_masks():
    """[(label, mask)] of numpy bool masks that stress the labeler: rows
    that run the full width (384 and 512 pixels, across every 32-pixel
    segment border), a serpentine (one component through every other row,
    joined at alternate ends, so most of its pixels lie far from its
    minimum), a comb (teeth on every other column joined only by the
    bottom row: a component's minimum at the top of the first tooth),
    pixels that touch only diagonally (4-connectivity keeps each apart)
    and all foreground."""
    import numpy as np

    h, w = 512, 384
    out = []
    for hh, ww in ((512, 384), (384, 512)):
        m = np.zeros((hh, ww), bool)
        m[::2] = True
        out.append((f"rows{ww}", m))
    m = np.zeros((h, w), bool)
    m[::2] = True
    m[1:h - 1:4, -1] = True
    m[3:h - 1:4, 0] = True
    out.append(("serpentine", m))
    m = np.zeros((h, w), bool)
    m[:, ::2] = True
    m[-1] = True
    out.append(("comb", m))
    yy, xx = np.mgrid[:h, :w]
    out.append(("diagonal", (yy + xx) % 2 == 0))
    out.append(("all", np.ones((h, w), bool)))
    return out


def area_shapes(a):
    """[(name, [(dy, dx)])] of the components of area a that K2's window
    must judge exactly: straight lines (from either end the farthest member
    lies a-1 away, the window's edge when a = m), staircases of unit steps
    and of steps 3 long, and an L (both reach that edge along a path)."""
    shapes = [("hline", [(0, i) for i in range(a)]), ("vline", [(i, 0) for i in range(a)])]
    for step in (1, 3):
        pts, y, x = [], 0, 0
        while len(pts) < a:
            pts.append((y, x))
            if len(pts) % (step + 1) == 0:
                y += 1
            else:
                x += 1
        shapes.append((f"stairs{step}", pts))
    half = a // 2
    shapes.append(("ell", [(0, i) for i in range(half + 1)]
                   + [(i, half) for i in range(1, a - half)]))
    return shapes


def area_stress_masks(m, h, w, seed=0):
    """[(label, numpy bool mask [h, w])] for K2 at min_area m: components of
    area m-1, m and m+1 (`area_shapes`) placed across every 32-pixel tile
    border, against the four image borders and at seeded random spots
    (never 4-adjacent to another, so each keeps its area; diagonal
    neighbours, other labels inside the window, are allowed); then all
    foreground and empty."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mask = np.zeros((h, w), bool)
    taken = np.zeros((h, w), bool)  # occupied pixels and their 4-neighbours

    def place(pts, y0, x0):
        ys = np.array([p[0] for p in pts]) + y0
        xs = np.array([p[1] for p in pts]) + x0
        if ys.min() < 0 or xs.min() < 0 or ys.max() >= h or xs.max() >= w:
            return
        if taken[ys, xs].any():
            return
        mask[ys, xs] = True
        for dy, dx in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
            taken[np.clip(ys + dy, 0, h - 1), np.clip(xs + dx, 0, w - 1)] = True

    shapes = [pts for a in (m - 1, m, m + 1) if a >= 1 for _, pts in area_shapes(a)]
    for pts in shapes:
        sy = max(p[0] for p in pts) + 1
        sx = max(p[1] for p in pts) + 1
        for t in range(32, max(h, w), 32):  # straddling tile borders
            place(pts, t - sy // 2, int(rng.integers(0, w)))
            place(pts, int(rng.integers(0, h)), t - sx // 2)
        for y0, x0 in ((0, int(rng.integers(0, w))), (h - sy, int(rng.integers(0, w))),
                       (int(rng.integers(0, h)), 0), (int(rng.integers(0, h)), w - sx),
                       (0, 0), (h - sy, w - sx)):
            place(pts, y0, x0)
    for _ in range(4 * len(shapes)):
        pts = shapes[int(rng.integers(len(shapes)))]
        place(pts, int(rng.integers(0, h)), int(rng.integers(0, w)))
    return [(f"area_shapes/m{m}", mask), ("all", np.ones((h, w), bool)),
            ("empty", np.zeros((h, w), bool))]


def kernel_cases(engine, pages, tiled=()):
    """(label, comb, hot, keep, tn, hot_low) on the card: each page's
    binarized heatmap from the main path's detector (hot_low: the hot
    pixels at path A's text_threshold), the stitched heatmaps of `tiled`
    ((label, tiled engine, page) of pages that tile), then seeded random
    masks, then the stress masks with seeded random hot, keep and tn."""
    import dataclasses

    import numpy as np
    import torch

    from tuatara_tpu_torch.api import content_mask
    from tuatara_tpu_torch.ops.boxes import binarize

    cfg = engine.config
    low = dataclasses.replace(cfg, text_threshold=LOW_THRESHOLD)
    cases = []
    for name, img in pages.items():
        h, w = img.shape[:2]
        scores = engine.detect(torch.from_numpy(img[None]).cuda())["scores"][0]
        mask = content_mask(h, w, cfg, "cuda")
        comb, keep, hot, tn = binarize(scores[:, :, 0], scores[:, :, 1], mask, cfg)
        hot_low = binarize(scores[:, :, 0], scores[:, :, 1], mask, low)[2]
        cases.append((name,) + tuple(t.contiguous() for t in (comb, hot, keep, tn, hot_low)))
    for label, eng, img in tiled:
        h, w = img.shape[:2]
        if not eng._tiled(h, w):
            fail(f"{label}: the page does not tile")
        scores = eng.detect(torch.from_numpy(img[None]).cuda())["scores"][0]
        mask = eng._tiled_geometry(h, w, scores.device)[4]
        comb, keep, hot, tn = binarize(scores[:, :, 0], scores[:, :, 1], mask, eng.config)
        hot_low = binarize(scores[:, :, 0], scores[:, :, 1], mask,
                           dataclasses.replace(eng.config, text_threshold=LOW_THRESHOLD))[2]
        hh, ww = comb.shape
        cases.append((f"{label}/{hh}x{ww}",) + tuple(
            t.contiguous() for t in (comb, hot, keep, tn, hot_low)))
    rng = np.random.default_rng(0)
    for hh, ww in ((384, 384), (512, 384)):
        comb = rng.random((hh, ww)) < 0.55   # near the percolation threshold
        hot = comb & (rng.random((hh, ww)) < 0.05)
        keep = rng.random((hh, ww)) < 0.8
        tn = rng.random((hh, ww)).astype(np.float32)
        hot_low = comb & (rng.random((hh, ww)) < 0.2)
        cases.append((f"random{hh}x{ww}",) + tuple(
            torch.from_numpy(a).cuda() for a in (comb, hot, keep, tn, hot_low)))
    for label, comb in stress_masks():
        hh, ww = comb.shape
        hot = comb & (rng.random((hh, ww)) < 0.05)
        keep = rng.random((hh, ww)) < 0.8
        tn = rng.random((hh, ww)).astype(np.float32)
        hot_low = comb & (rng.random((hh, ww)) < 0.2)
        cases.append((label,) + tuple(
            torch.from_numpy(a).cuda() for a in (comb, hot, keep, tn, hot_low)))
    return cases


def traced_per_call(fn, calls=10):
    """Device ms and device records (kernels and memsets) per call of fn,
    from one `torch.profiler` trace of `calls` calls: the sum of the
    records' durations over the calls. A trace whose record count is not a
    multiple of `calls` lost records and is taken again, up to three times.
    -> (ms, records) per call, or (None, None)."""
    import torch

    path = os.path.join(ROOT, "build", "per_call_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()

    for _attempt in range(3):
        events = traced_kernels(run, path, False, cats=("kernel", "gpu_memset"))
        if events and len(events) % calls == 0:
            return sum(e["dur"] for e in events) / 1e3 / calls, len(events) // calls
    return None, None


def collision_roots(lab, k):
    """k roots of `lab`, shuffled, led by the largest group of its labels
    that share a home bucket in K3/K5's hash table for k (their first
    probe; they part at the second), and that bucket. The first two probes
    of each are checked against csrc/stats.cu's own hash
    (`tt_stats_table_probe`) -> (roots, group, bucket)."""
    import ctypes

    import numpy as np
    import torch

    from tuatara_tpu_torch.kernels import _build, stats

    probe_c = _build.load("stats").tt_stats_table_probe
    probe_c.argtypes, probe_c.restype = [ctypes.c_int] * 3, ctypes.c_int
    labels = np.unique(lab.cpu().numpy())
    labels = labels[labels >= 0]
    home = np.array([stats.table_probe(int(x), k) for x in labels])
    bucket = int(np.bincount(home).argmax())
    group = [int(x) for x in labels[home == bucket][:k // 2]]
    for x in group:
        for i in (0, 1):
            if probe_c(x, k, i) != stats.table_probe(x, k, i):
                fail(f"stats hash: csrc/stats.cu's probe {i} of root {x} is bucket "
                     f"{probe_c(x, k, i)}, kernels/stats.py's {stats.table_probe(x, k, i)}")
    rng = np.random.default_rng(7)
    rest = rng.permutation(labels[home != bucket])[:k - len(group)]
    roots = np.full(k, 2**30, np.int32)
    roots[:len(group) + len(rest)] = np.concatenate([group, rest])
    return torch.from_numpy(rng.permutation(roots)).cuda(), group, bucket


def stats_cases(cases, pages, min_area):
    """(label, labels, keep, tn, roots) on the card for K3 and K5 beyond the
    main path's K = 256: each page at K = 16 (max_boxes=16, not a multiple
    of 128) with path A's root selection; K = 1024 roots drawn in a
    shuffled order from the diagonal and random masks' labels (strips sized
    for a large K; nearly every diagonal label misses the table); an empty
    mask (every root padding); roots of random512x384 chosen to collide in
    the hash table, printed with the bucket they share; a 509x381 crop of it
    (odd sizes: partial strips and bands); K = 4096 on random512x384 (strips
    of fewer than 8 columns, one CTA an SM)."""
    import numpy as np
    import torch

    from tuatara_tpu_torch.kernels import cc, stats
    from tuatara_tpu_torch.ops import connected_components as plain

    rng = np.random.default_rng(3)
    by_label = {c[0]: c for c in cases}
    out = []
    for name in pages:
        _, comb, _, keep, tn, hot_low = by_label[name]
        lab = cc.label_components(comb)
        roots, _ = plain.component_roots_filtered(lab, 16, None, cc.area_ok(lab, min_area),
                                                  hot=hot_low, keep=keep)
        out.append((f"{name}/K16", lab, keep, tn, roots))
    for name in ("diagonal", "random384x384", "random512x384"):
        _, comb, _, keep, tn, _ = by_label[name]
        lab = cc.label_components(comb)
        labels = torch.unique(lab).cpu().numpy()
        labels = labels[labels >= 0]
        roots = np.full(1024, 2**30, np.int32)
        pick = rng.permutation(labels)[:1020]
        roots[:len(pick)] = pick
        out.append((f"{name}/K1024", lab, keep, tn,
                    torch.from_numpy(rng.permutation(roots)).cuda()))
    _, comb, _, keep, tn, hot_low = by_label["random512x384"]
    crop = [t[:509, :381].contiguous() for t in (comb, keep, tn, hot_low)]
    lab = cc.label_components(crop[0])
    roots, _ = plain.component_roots_filtered(lab, 256, None, cc.area_ok(lab, min_area),
                                              hot=crop[3], keep=crop[1])
    out.append(("random509x381", lab, crop[1], crop[2], roots))
    empty = torch.zeros_like(comb)
    lab = cc.label_components(empty)
    roots, _ = plain.component_roots_filtered(lab, 256, None, cc.area_ok(lab, min_area),
                                              hot=empty, keep=keep)
    out.append(("empty512x384", lab, keep, tn, roots))
    lab = cc.label_components(comb)
    roots, group, bucket = collision_roots(lab, 256)
    print(f"stats collision case: roots {group} share home bucket {bucket} of "
          f"2^{stats.table_bits(256)}", flush=True)
    out.append(("collision512x384", lab, keep, tn, roots))
    labels = torch.unique(lab).cpu().numpy()
    roots = np.full(4096, 2**30, np.int32)
    pick = rng.permutation(labels[labels >= 0])[:4000]
    roots[:len(pick)] = pick
    out.append(("random512x384/K4096", lab, keep, tn,
                torch.from_numpy(rng.permutation(roots)).cuda()))
    torch.cuda.synchronize()
    return out


def check_stats(label, lab, keep, tn, roots, rows, max_launches):
    """K3 and K5 on one input: equal to the plain versions bit for bit (an
    empty slot's peak exactly -1e30), at most max_launches records a call;
    times and the byte bound into rows."""
    import torch

    from tuatara_tpu_torch.kernels import stats
    from tuatara_tpu_torch.ops.connected_components import BIG

    h, w = lab.shape
    n, k = h * w, roots.shape[0]
    n_roots = int((roots < BIG).sum())
    for name, kfn, pfn, nbytes, nops in (
            (stats.K3, lambda: stats.component_stats_nopeak(lab, keep, roots),
             lambda: stats.component_stats_nopeak_plain(lab, keep, roots),
             n * 5 + k * 4 + (2 * h + 2 * w) * k * 4, n * 8),
            (stats.K5, lambda: stats.component_stats(lab, tn, keep, roots),
             lambda: stats.component_stats_plain(lab, tn, keep, roots),
             n * (4 + 4 + 1) + k * 4 + (2 * h + 2 * w) * k * 4 + k * 4, n * 9)):
        got, ref = kfn(), pfn()
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"{name} differs from its plain version on {label} (max abs err {err})")
        if name == stats.K5 and not bool((got[4][roots >= n] == stats.EMPTY_PEAK).all()):
            fail(f"{name} on {label}: a padding root's peak is not -1e30")
        ms = cuda_ms(kfn, 30)
        dev_ms, per_call = traced_per_call(kfn)
        if per_call is not None and per_call > max_launches[name]:
            fail(f"{name} took {per_call} launches a call on {label} (at most "
                 f"{max_launches[name]})")
        pms = cuda_ms(pfn, 3, warmup=1)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / VECTOR_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        rows[name].append({"input": label, "shape": [h, w], "roots": n_roots, "ms": ms,
                           "device_ms": dev_ms, "launches_per_call": per_call,
                           "plain_ms": pms, "bound_ms": bound,
                           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                           "max_abs_err": err})
        print(f"kernel {name:24s} {label:18s} {h}x{w} K={k} roots={n_roots} ms={ms:.4f} "
              f"device_ms={dev_ms} launches/call={per_call} plain_ms={pms:.3f} "
              f"bound_ms={bound:.5f}", flush=True)


def check_area_ok(cases, main_m, rows):
    """K2 at every min_area of K2_MIN_AREAS on the masks of `cases` (the
    main loop has run it at main_m) and on `area_stress_masks` at 512x384
    and 509x381: equal to its plain version bit for bit, at most 1 traced
    record a call; times into rows."""
    import torch

    from tuatara_tpu_torch.kernels import cc
    from tuatara_tpu_torch.ops import connected_components as plain

    inputs = [(c[0], c[1], [m for m in K2_MIN_AREAS if m != main_m]) for c in cases]
    for hh, ww in ((512, 384), (509, 381)):
        masks = {}
        for m in K2_MIN_AREAS:
            for label, mask in area_stress_masks(m, hh, ww, seed=m):
                masks[f"{label}/{hh}x{ww}"] = mask
        inputs += [(label, torch.from_numpy(mask).cuda(), K2_MIN_AREAS)
                   for label, mask in masks.items()]
    for label, comb, areas in inputs:
        lab = cc.label_components(comb)
        h, w = lab.shape
        for m in areas:
            got, ref = cc.area_ok(lab, m), plain.area_ok(lab, m)
            if not torch.equal(got, ref):
                fail(f"{cc.K2} differs from its plain version on {label} at min_area {m} "
                     f"({int((got != ref).sum())} pixels)")
            dev_ms, per_call = traced_per_call(lambda: cc.area_ok(lab, m))
            if per_call is not None and per_call > 1:
                fail(f"{cc.K2} took {per_call} launches a call on {label} at min_area {m}")
            ms = cuda_ms(lambda: cc.area_ok(lab, m), 30)
            rows.append({"input": f"{label}/m{m}", "shape": [h, w], "ms": ms,
                         "device_ms": dev_ms, "launches_per_call": per_call,
                         "plain_ms": None, "bound_ms": h * w * 5 / HBM_BYTES_PER_S * 1e3,
                         "bound_by": "bytes", "max_abs_err": 0.0})
            print(f"kernel {cc.K2:24s} {label:26s} m={m:2d} {h}x{w} fg={int((lab >= 0).sum())} "
                  f"ms={ms:.4f} device_ms={dev_ms} launches/call={per_call}", flush=True)


def check_kernels(engine, pages, launches, low_launches, tiled=()):
    """Phases 4 and 4c: every kernel of detection post-processing equal to
    its plain version; times and bounds. K1-K3 on the default path's
    inputs, K4 and K5 on path A's; all five also on the stitched heatmaps
    of `tiled` (see kernel_cases)."""
    import torch

    from tuatara_tpu_torch.kernels import cc, stats
    from tuatara_tpu_torch.ops import connected_components as plain

    K = engine.config.max_boxes
    m = engine.config.min_component_area
    rows = {n: [] for n in (cc.K1, cc.K2, stats.K3, cc.K4, stats.K5)}
    max_launches = {cc.K1: 3, cc.K2: 1, cc.K4: 2, stats.K3: 1, stats.K5: 1}
    cases = kernel_cases(engine, pages, tiled)
    for label, comb, hot, keep, tn, hot_low in cases:
        h, w = comb.shape
        n = h * w
        lab, aux = cc.label_components_aux(comb, hot)
        plab, paux = plain.label_components_aux(comb, hot)
        ok_map = cc.area_ok(lab, m)
        p_ok = plain.area_ok(lab, m)
        roots, _ = plain.component_roots_filtered(lab, K, aux, ok_map)
        got = stats.component_stats_nopeak(lab, keep, roots)
        ref = stats.component_stats_nopeak_plain(lab, keep, roots)
        lab4 = cc.label_components(comb)
        plab4 = plain.label_components(comb)
        roots5, _ = plain.component_roots_filtered(lab4, K, None, cc.area_ok(lab4, m),
                                                   hot=hot_low, keep=keep)
        got5 = stats.component_stats(lab4, tn, keep, roots5)
        ref5 = stats.component_stats_plain(lab4, tn, keep, roots5)
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
            cc.K4: ([lab4], [plab4], lambda: cc.label_components(comb),
                    lambda: plain.label_components(comb), n * (1 + 4), n * 6),
            stats.K5: (list(got5), list(ref5),
                       lambda: stats.component_stats(lab4, tn, keep, roots5),
                       lambda: stats.component_stats_plain(lab4, tn, keep, roots5),
                       n * (4 + 4 + 1) + K * 4 + (2 * h + 2 * w) * K * 4 + K * 4, n * 9),
        }
        for name, (outs, refs, kfn, pfn, nbytes, nops) in checks.items():
            err = max(float((a.long() - b.long()).abs().max()) if not a.is_floating_point()
                      else float((a - b).abs().max()) for a, b in zip(outs, refs))
            equal = all(torch.equal(a, b) for a, b in zip(outs, refs))
            if not equal:
                fail(f"{name} differs from its plain version on {label} "
                     f"(max abs err {err})")
            ms = cuda_ms(kfn, 30)
            dev_ms, per_call = traced_per_call(kfn)
            if per_call is not None and per_call > max_launches.get(name, per_call):
                fail(f"{name} took {per_call} launches a call on {label} (at most "
                     f"{max_launches[name]})")
            pms = cuda_ms(pfn, 3, warmup=1)
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / VECTOR_OPS_PER_S * 1e3
            rows[name].append({"input": label, "shape": [h, w], "roots": n_roots,
                               "ms": ms, "device_ms": dev_ms, "launches_per_call": per_call,
                               "plain_ms": pms, "bound_ms": max(bytes_ms, ops_ms),
                               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                               "max_abs_err": err})
            print(f"kernel {name:24s} {label:18s} {h}x{w} ms={ms:.4f} device_ms={dev_ms} "
                  f"launches/call={per_call} plain_ms={pms:.3f} "
                  f"bound_ms={max(bytes_ms, ops_ms):.5f}", flush=True)
        empty = int((got5[4] == stats.EMPTY_PEAK).sum())
        print(f"kernel {stats.K5:24s} {label:18s} roots={int((roots5 < plain.BIG).sum())} "
              f"empty_peak_slots={empty}", flush=True)
    for label, lab, keep, tn, roots in stats_cases(cases, pages, m):
        check_stats(label, lab, keep, tn, roots, rows, max_launches)
    check_area_ok(cases, m, rows[cc.K2])
    too_many = torch.full((8193,), plain.BIG, dtype=torch.int32, device=lab.device)
    for name, fn in ((stats.K3, lambda: stats.component_stats_nopeak(lab, keep, too_many)),
                     (stats.K5, lambda: stats.component_stats(lab, tn, keep, too_many))):
        try:
            fn()
        except ValueError:
            continue
        fail(f"{name} took K = 8193 roots, whose table does not fit one CTA")

    sources = {cc.K1: ("tuatara_tpu_torch/csrc/cc.cu", "tuatara_tpu/ops/pallas/cc.py:213"),
               cc.K2: ("tuatara_tpu_torch/csrc/cc.cu", "tuatara_tpu/ops/pallas/cc.py:146"),
               stats.K3: ("tuatara_tpu_torch/csrc/stats.cu",
                          "tuatara_tpu/ops/pallas/stats.py:172"),
               cc.K4: ("tuatara_tpu_torch/csrc/cc.cu", "tuatara_tpu/ops/pallas/cc.py:89"),
               stats.K5: ("tuatara_tpu_torch/csrc/stats.cu",
                          "tuatara_tpu/ops/pallas/stats.py:120")}
    out = []
    for name, rs in rows.items():
        main = [r for r in rs if r["input"] in pages]
        path = launches if name in (cc.K1, cc.K2, stats.K3) else low_launches

        def mean(key):
            return sum(r[key] for r in main) / len(main)

        per_page = path.get(name, 0) / len(pages)
        dev_ms = mean_of([r["device_ms"] for r in main])
        traced = [r["launches_per_call"] for r in rs if r["launches_per_call"] is not None]
        out.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": path.get(name, 0),
            "launches_per_page": per_page,
            "device_ms_per_page": dev_ms * per_page if dev_ms is not None else None,
            "equal": True, "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": mean("ms"), "device_ms": dev_ms,
            "launches_per_call": max(traced) if traced else None,
            "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": main[0]["bound_by"], "library_ms": None,
            "timed_on": "mean over the main path's pages",
            "other_inputs": {r["input"]: {"ms": r["ms"], "device_ms": r["device_ms"]}
                             for r in rs if r["input"] not in pages},
        })
    return out


def stage1_inputs(engine, pages):
    """Each page's conv1_1 -> ReLU activation [1, 64, H, W] bf16 on the
    default path's canvas (a forward hook on conv1_1), in the memory layout
    the trunk holds (channels_last); then funsd_0001129658's repeated 16
    times, the dense serving batch (B = 16)."""
    import torch
    import torch.nn.functional as F

    seen = []
    conv = engine.craft.vgg["conv1_1"]["conv"]
    handle = conv.register_forward_hook(lambda mod, args, out: seen.append(F.relu(out)))
    try:
        for img in pages.values():
            engine.detect(torch.from_numpy(img[None]).cuda())
    finally:
        handle.remove()
    cases = list(zip(pages, seen))
    x = dict(cases)[K8_BATCH_PAGE]
    batch = x.expand(K8_BATCH, -1, -1, -1).contiguous(memory_format=torch.channels_last)
    return cases + [(f"{K8_BATCH_PAGE}x{K8_BATCH}", batch)]


def check_stage1(engine, pages, launches):
    """Phase 4d: K8 against its plain version on real activations, with a
    control that must fail the limit; times beside the cuDNN chain."""
    import torch
    import torch.nn.functional as F

    from tuatara_tpu_torch.kernels import stage1

    c12 = engine.craft.vgg["conv1_2"]["conv"]
    w, b = c12.weight, c12.bias
    wp = engine.craft.conv1_2_packed
    flipped_wp = stage1.pack_conv_pool_weights(w.flip(-1, -2))
    rows = []
    for label, x in stage1_inputs(engine, pages):
        bsz, c, h, wd = x.shape
        o = w.shape[0]
        got = stage1.fused_conv_pool(x, wp, b)
        ref = stage1.fused_conv_pool_plain(x, wp, b)
        flipped = stage1.fused_conv_pool_plain(x, flipped_wp, b)
        torch.cuda.synchronize()

        def rel(y):
            return float((y.float() - ref.float()).norm() / ref.float().norm())

        err, ctl = rel(got), rel(flipped)
        del flipped
        if not torch.isfinite(got.float()).all() or err > K8_MAX_REL:
            fail(f"{stage1.K8} on {label}: relative error {err} > {K8_MAX_REL}")
        if ctl <= K8_MAX_REL:
            fail(f"{stage1.K8} tolerance {K8_MAX_REL} on {label} does not reject the "
                 f"flipped taps: relative error {ctl}")

        def kernel():
            return stage1.fused_conv_pool(x, wp, b)

        def library():
            return F.max_pool2d(F.relu(c12(x)), 2, 2)

        nbytes = (bsz * h * wd * c + bsz * (h // 2) * (wd // 2) * o) * 2
        ops = 2 * 9 * c * o * bsz * h * wd
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
        dev_ms, per_call = traced_per_call(kernel)
        lib_dev_ms, lib_per_call = traced_per_call(library)
        row = {"input": label, "shape": [bsz, c, h, wd], "rel_err": err,
               "control_rel_err": ctl,
               "max_abs_err": float((got.float() - ref.float()).abs().max()),
               "ms": cuda_ms(kernel, 20), "device_ms": dev_ms, "launches_per_call": per_call,
               "plain_ms": cuda_ms(lambda: stage1.fused_conv_pool_plain(x, wp, b), 3, 1),
               "library_ms": cuda_ms(library, 20), "library_device_ms": lib_dev_ms,
               "library_launches_per_call": lib_per_call,
               "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}
        rows.append(row)
        print(f"kernel {stage1.K8:24s} {label:18s} {bsz}x{h}x{wd} rel_err={err:.2e} "
              f"control={ctl:.2e} ms={row['ms']:.4f} device_ms={dev_ms} "
              f"launches/call={per_call} plain_ms={row['plain_ms']:.3f} "
              f"library_ms={row['library_ms']:.4f} library_device_ms={lib_dev_ms} "
              f"bound_ms={row['bound_ms']:.5f}", flush=True)

    main = [r for r in rows if r["input"] in pages]

    def mean(key):
        return mean_of([r[key] for r in main])

    batch = rows[-1]
    return [{"name": stage1.K8, "route": "cuda", "source": "tuatara_tpu_torch/csrc/stage1.cu",
             "replaces": "tuatara_tpu/ops/pallas/stage1.py:134",
             "launches": launches.get(stage1.K8, 0),
             "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": mean("ms"),
             "device_ms": mean("device_ms"),
             "launches_per_call": max((r["launches_per_call"] for r in rows
                                       if r["launches_per_call"] is not None), default=None),
             "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
             "bound_by": main[0]["bound_by"], "library_ms": mean("library_ms"),
             "library_device_ms": mean("library_device_ms"),
             "library": "cuDNN conv2d -> relu -> max_pool2d, bf16",
             "timed_on": "mean over the default path's four canvases",
             "batch16": {k: batch[k] for k in ("input", "ms", "device_ms", "library_ms",
                                                "library_device_ms", "bound_ms", "rel_err",
                                                "control_rel_err")},
             "per_input": rows}]


def check_int8_conv(prod, pages):
    """Phase 4e: the int8 convolution's int32 sums on real trunk activations
    (INT8_LAYERS on INT8_PAGE under production()) against a float64
    convolution of the same operands on the card, everywhere, and an int64
    matmul on the host at 256 sampled pixels: equal exactly. Times beside
    the bf16 cuDNN convolution of the same shapes. -> a summary dict."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tuatara_tpu_torch.kernels import int8
    from tuatara_tpu_torch.models.layers import dequant

    qconvs = dict(prod.craft.qconvs())
    seen = {}
    handles = [qconvs[n].register_forward_hook(
        lambda mod, args, out, n=n: seen.__setitem__(n, args[0])) for n in INT8_LAYERS]
    try:
        prod.detect(torch.from_numpy(pages[INT8_PAGE][None]).cuda())
    finally:
        for hd in handles:
            hd.remove()
    rng = np.random.default_rng(9)
    rows = []
    for name in INT8_LAYERS:
        q, x = qconvs[name], seen[name]
        xq, xs = q.quantize_input(x)
        kh = q.wq.shape[0]
        acc = int8.int8_conv(xq, q.wmat, kh, q.dilation)
        pad = q.dilation * (kh - 1) // 2
        ref = F.conv2d(xq.permute(0, 3, 1, 2).double(), q.wq.permute(3, 2, 0, 1).double(),
                       padding=pad, dilation=q.dilation).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        if not torch.equal(acc.long(), ref.long()) or not torch.equal(ref, ref.round()):
            fail(f"int8 conv {name}: int32 sums differ from the float64 convolution "
                 f"(max abs {float((acc.double() - ref).abs().max())})")
        b, h, w, c = xq.shape
        xp = F.pad(xq.cpu().long(), (0, 0, pad, pad, pad, pad))
        picks = [(int(rng.integers(b)), int(rng.integers(h)), int(rng.integers(w)))
                 for _ in range(256)]
        cols = torch.stack([torch.cat([xp[bi, y + ky * q.dilation, x + kx * q.dilation]
                                       for ky in range(kh) for kx in range(kh)])
                            for bi, y, x in picks])
        want = cols @ q.wq.cpu().long().reshape(-1, q.cout)
        got = torch.stack([acc[bi, y, x].cpu().long() for bi, y, x in picks])
        if not torch.equal(got, want):
            fail(f"int8 conv {name}: int32 sums differ from the int64 matmul at sampled pixels")
        scale = q.sw / xs
        card = dequant(acc, scale, q.bias, torch.float32).cpu()
        host = dequant(acc.cpu(), scale.cpu(), None if q.bias is None else q.bias.cpu(),
                       torch.float32)
        fma_diff = int((card != host).sum())
        wb = q.wq.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
        xb = x.to(torch.bfloat16)
        rows.append({
            "layer": name, "shape": [b, h, w, c], "cout": q.cout, "kernel": kh,
            "dilation": q.dilation, "equal": True, "dequant_fma_mismatches": fma_diff,
            "ms": cuda_ms(lambda: int8.int8_conv(xq, q.wmat, kh, q.dilation), 20),
            "layer_ms": cuda_ms(lambda: q(x), 20),
            "bf16_cudnn_ms": cuda_ms(lambda: F.conv2d(xb, wb, padding=pad,
                                                      dilation=q.dilation), 20)})
        r = rows[-1]
        print(f"int8 conv {name:20s} {b}x{h}x{w}x{c}->{q.cout} k={kh} d={q.dilation} equal "
              f"(float64 everywhere, int64 at 256 pixels); dequant fma mismatches "
              f"{fma_diff}; ms={r['ms']:.4f} layer_ms={r['layer_ms']:.4f} "
              f"bf16_cudnn_ms={r['bf16_cudnn_ms']:.4f}", flush=True)
    return {"route": "library", "library": "torch._int_mm (cuBLASLt) over im2col rows",
            "source": "tuatara_tpu_torch/kernels/int8.py",
            "replaces": "tuatara_tpu/models/layers.py:216 (XLA int8 conv, not Pallas)",
            "per_layer": rows}


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


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def capture_slabs(engine, pages):
    """Run the latency path once more with K6/K7 wrapped, keeping each page's
    inputs to them: [(page, x, (mem_k, mem_v))]."""
    from tuatara_tpu_torch.kernels import decode, vit

    seen = {"x": [], "mem": []}
    k6, k7 = vit.vit_blocks, decode.greedy_decode

    def vit_spy(x, st, heads, eps=1e-6):
        seen["x"].append(x.clone())
        return k6(x, st, heads, eps)

    def decode_spy(mem_k, mem_v, *args, **kw):
        seen["mem"].append((mem_k.clone(), mem_v.clone()))
        return k7(mem_k, mem_v, *args, **kw)

    vit.vit_blocks, decode.greedy_decode = vit_spy, decode_spy
    try:
        for img in pages.values():
            engine.run(img)
    finally:
        vit.vit_blocks, decode.greedy_decode = k6, k7
    return list(zip(pages, seen["x"], seen["mem"]))


def tile_steps(logits, tb):
    """[(first crop, crops, steps)] of each K7 tile: a tile runs until every
    crop in it has emitted EOS, or all T steps."""
    ended = (logits.argmax(-1) == 0).int().cumsum(1) > 0
    n, t = ended.shape
    out = []
    for t0 in range(0, n, tb):
        done = ended[t0:t0 + tb].all(0).nonzero()
        out.append((t0, min(tb, n - t0), int(done[0]) + 1 if len(done) else t))
    return out


def decode_ops(logits, tb, d, hidden, s, n_classes) -> int:
    """Operations K7 needs on this input: every crop of a tile runs the
    tile's steps."""
    total = 0
    for _, rows, steps in tile_steps(logits, tb):
        per_crop = sum(2 * (3 * d * d + 2 * d * hidden + d * n_classes)
                       + 4 * (i + 1) * d + 4 * s * d for i in range(steps))
        total += per_crop * rows
    return total


def decode_bytes(logits, mem_k, mem_v, st, tb, bos) -> int:
    """Bytes K7 must move on this input, each read or written once: the
    memory K/V, the matmul weights, biases and LayerNorms, the rows of
    pos_q / qh_all of the steps run, the distinct (position, token) rows of
    the K/V table that those steps attend over, and the logits."""
    import torch

    from tuatara_tpu_torch.kernels import decode

    n, t, _ = logits.shape
    d = mem_k.shape[2]
    v = st["k_tab"].shape[1]
    ids = logits.argmax(-1)
    toks = torch.cat([torch.full_like(ids[:, :1], bos), ids[:, :-1]], dim=1)  # fed at j
    keys, max_steps = [], 0
    for t0, rows, steps in tile_steps(logits, tb):
        j = torch.arange(steps, device=ids.device)
        keys.append((j * v + toks[t0:t0 + rows, :steps]).reshape(-1))
        max_steps = max(max_steps, steps)
    table_rows = int(torch.unique(torch.cat(keys)).numel())
    per_step = ("pos_q", "qh_all", "k_tab", "v_tab")
    fixed = nbytes(st[k] for k in decode.WEIGHTS if k not in per_step)
    step_rows = max_steps * d * (st["pos_q"].element_size() + st["qh_all"].element_size())
    table = table_rows * d * (st["k_tab"].element_size() + st["v_tab"].element_size())
    return nbytes((mem_k, mem_v)) + fixed + step_rows + table + logits.numel() * 4


def traced_kernels(fn, path, port_only, cats=("kernel",)):
    """The device records of one `torch.profiler` trace of fn(), in start
    order: the kernel records (and those of the other categories in
    `cats`, e.g. "gpu_memset"), of the port's own kernels only or (port_only
    False) all."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in cats]
    if port_only:
        events = [e for e in events
                  if "(anonymous namespace)::" in e["name"] and "at::" not in e["name"]]
    return sorted(events, key=lambda e: e["ts"])


def k6_split(x, st, heads, eps, reps=3, gemm_calls=10):
    """K6's device time per encode by launch role (`vit.LAUNCH_ROLES`, the
    launches of one block in order), from `torch.profiler` traces of
    `reps` calls, one call a trace, and beside each GEMM role the device
    time of `torch.matmul` of its shapes (bf16; `gemm_calls` calls in one
    trace) times the block count, as its yardstick. A trace that lost
    kernel records is taken again, up to three times. -> ({role: ms},
    {role: library ms}, kernels traced a call), or ({}, {}, None) if the
    traces kept losing kernel records."""
    import torch

    from tuatara_tpu_torch.kernels import vit

    roles = vit.LAUNCH_ROLES
    n, s, d = x.shape
    nb, _, hidden = st["f1_w"].shape
    vit.vit_blocks(x, st, heads, eps)
    torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", "k6_split_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    split = dict.fromkeys(roles, 0.0)
    counted = []  # kernel records in each accepted trace of one call
    for _ in range(reps):
        for _attempt in range(3):
            events = traced_kernels(lambda: vit.vit_blocks(x, st, heads, eps), path, True)
            if len(events) == nb * len(roles):
                break
        else:  # a measurement, not a gate: reported as not measured
            print(f"kernel {vit.K6} split not measured: {len(events)} kernels traced in a "
                  f"call, expected {nb * len(roles)}", flush=True)
            return {}, {}, None
        counted.append(len(events))
        for i, e in enumerate(events):
            split[roles[i % len(roles)]] += e["dur"] / 1e3 / reps
    m = n * s
    shapes = {"qkv": (m, d, 3 * d), "out_proj": (m, d, d), "fc1": (m, d, hidden),
              "fc2": (m, hidden, d)}
    g = torch.Generator(device="cuda").manual_seed(1)
    library = {}
    for role in roles:
        gemm = next((k for k in shapes if k in role), None)
        if gemm is None:
            continue
        mm, kk, nn = shapes[gemm]
        a = torch.randn(mm, kk, device="cuda", generator=g).to(torch.bfloat16)
        b = torch.randn(kk, nn, device="cuda", generator=g).to(torch.bfloat16)
        torch.matmul(a, b)

        def calls():
            for _ in range(gemm_calls):
                torch.matmul(a, b)

        for _attempt in range(3):  # cuBLAS launches the same kernels every call
            events = traced_kernels(calls, path, False)
            if events and len(events) % gemm_calls == 0:
                library[role] = nb * sum(e["dur"] for e in events) / 1e3 / gemm_calls
                break
        else:
            library[role] = None
    return split, library, sum(counted) / len(counted)


def check_k6_mlp_width(heads, eps, hidden=1280, n=16, s=128, d=384, n_blocks=2):
    """K6 at an MLP width that 192 does not divide, which takes fc1's
    64 x 128 tiles (PARSEQ's 1536 takes 64 x 192): seeded random blocks
    against the plain version, to the same limit as the real slabs."""
    import torch

    from tuatara_tpu_torch.kernels import vit

    g = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale + shift

    shapes = {"qkv_w": (d, 3 * d), "qkv_b": (3 * d,), "o_w": (d, d), "o_b": (d,),
              "f1_w": (d, hidden), "f1_b": (hidden,), "f2_w": (hidden, d), "f2_b": (d,),
              "ln1_g": (d,), "ln1_b": (d,), "ln2_g": (d,), "ln2_b": (d,)}
    st = {}
    for k in vit.WEIGHTS:
        shape = (n_blocks, *shapes[k])
        if k.endswith("_w"):
            st[k] = rnd(*shape, scale=shape[1] ** -0.5).to(torch.bfloat16)
        else:
            st[k] = rnd(*shape, scale=0.1, shift=1.0 if k.endswith("_g") else 0.0)
    x = rnd(n, s, d)
    got = vit.vit_blocks(x, st, heads, eps)
    ref = vit.vit_blocks_plain(x, st, heads, eps)
    torch.cuda.synchronize()
    rel = float((got - ref).norm() / ref.norm())
    err = float((got - ref).abs().max())
    label = f"random{n}/mlp{hidden}"
    print(f"kernel {vit.K6:24s} {label:18s} N={n} S={s} hidden={hidden} rel_err={rel:.2e}",
          flush=True)
    if not torch.isfinite(got).all() or rel > K6_MAX_REL:
        fail(f"{vit.K6} on {label}: relative error {rel} > {K6_MAX_REL}")
    return {"input": label, "n": n, "s": s, "hidden": hidden, "rel_err": rel,
            "max_abs_err": err}


def first_eos_ids(logits):
    """[N, T] ids with every position after the first EOS set to 0."""
    ids = logits.argmax(-1)
    eos = (ids == 0).int()
    return ids.masked_fill((eos.cumsum(1) - eos) > 0, 0)


def check_recognizer_kernels(lat, default, pages, launches):
    """Phase 4b: K6 and K7 against their plain versions on the latency
    path's slabs and on a seeded random [32, 128, 384], and K6 on each real
    slab's first 64 tokens; times and bounds."""
    import torch

    from tuatara_tpu_torch.kernels import decode, vit

    pq = lat.parseq
    cfg = pq.cfg
    heads, eps = cfg.enc_heads, cfg.layer_norm_eps
    T, C, bos = cfg.max_label_length + 1, cfg.charset_size + 1, cfg.num_tokens - 2
    dargs = (pq.dec_stacked, cfg.dec_heads, T, C, bos, eps)
    cases = capture_slabs(lat, pages)
    g = torch.Generator(device="cuda").manual_seed(0)
    xr = torch.randn(32, 128, cfg.embed_dim, device="cuda", generator=g)
    with torch.no_grad():
        mem = torch.randn(32, 128, cfg.embed_dim, device="cuda", generator=g)
        ca = pq.dec[0].cross_attn
        memr = (ca.k(mem).to(torch.bfloat16).contiguous(),
                ca.v(mem).to(torch.bfloat16).contiguous())
    cases.append(("random32", xr, memr))
    st6 = pq.enc_stacked
    w6 = nbytes(st6[k] for k in vit.WEIGHTS)
    rows = {vit.K6: [], decode.K7: []}

    def check_k6(label, x):
        n, s, d = x.shape
        got = vit.vit_blocks(x, st6, heads, eps)
        ref = vit.vit_blocks_plain(x, st6, heads, eps)
        with torch.no_grad():  # the final memory: the encoder's last LayerNorm
            mem_ref = pq.enc_norm(ref)
        torch.cuda.synchronize()
        hidden = st6["f1_w"].shape[2]
        nb = st6["qkv_w"].shape[0]
        ops = 2 * n * nb * (s * d * (3 * d + d + 2 * hidden) + 2 * s * s * d)
        b_ms = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3 + w6 / HBM_BYTES_PER_S * 1e3
        o_ms = ops / BF16_OPS_PER_S * 1e3

        def eager():
            y = x
            with torch.no_grad():
                for blk in default.parseq.enc:
                    y = blk(y)
            return y

        def rels(y):
            """Relative (Frobenius) error of y against the plain version, on
            the blocks' output and on the final memory."""
            y = y.float()
            with torch.no_grad():
                my = pq.enc_norm(y)
            return (float((y - ref).norm() / ref.norm()),
                    float((my - mem_ref).norm() / mem_ref.norm()))

        rel, mem_rel = rels(got)
        # Control: a plausibly wrong kernel, the default lowering's eager
        # block chain (erf GELU, bf16 activations between modules), must
        # fail the same tolerance, or the tolerance proves nothing.
        ctl, mem_ctl = rels(eager())
        err6 = float((got - ref).abs().max())
        if not torch.isfinite(got).all() or max(rel, mem_rel) > K6_MAX_REL:
            fail(f"{vit.K6} on {label}: relative error {rel} (blocks), {mem_rel} "
                 f"(final memory) > {K6_MAX_REL}")
        if max(ctl, mem_ctl) <= K6_MAX_REL:
            fail(f"{vit.K6} tolerance {K6_MAX_REL} on {label} does not reject the eager erf "
                 f"block chain: relative error {ctl} (blocks), {mem_ctl} (final memory)")
        split, split_lib, per_call = k6_split(x, st6, heads, eps) \
            if not label.startswith("random") else ({}, {}, None)
        row = {"input": label, "n": n, "s": s, "rel_err": rel, "memory_rel_err": mem_rel,
               "control_rel_err": ctl, "control_memory_rel_err": mem_ctl,
               "max_abs_err": err6,
               "ms": cuda_ms(lambda: vit.vit_blocks(x, st6, heads, eps), 20),
               "plain_ms": cuda_ms(lambda: vit.vit_blocks_plain(x, st6, heads, eps), 3, 1),
               "eager_ms": cuda_ms(eager, 10),
               "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
               "split_ms": split, "split_library_ms": split_lib,
               "launches_per_call": per_call,
               "device_ms": sum(split.values()) if split else None}
        print(f"kernel {vit.K6:24s} {label:18s} N={n} S={s} rel_err={rel:.2e} "
              f"memory_rel_err={mem_rel:.2e} control={ctl:.2e}/{mem_ctl:.2e} ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.3f} eager_ms={row['eager_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.5f}", flush=True)
        if split:
            print(f"kernel {vit.K6:24s} {label:18s} launches/encode {per_call} (traced)",
                  flush=True)
            print(f"kernel {vit.K6:24s} {label:18s} split ms/encode "
                  + " ".join(f"{k}={v:.4f}" for k, v in split.items())
                  + "; torch.matmul device ms/encode "
                  + " ".join(f"{k}={v}" for k, v in split_lib.items()), flush=True)
        return row

    for label, x, (mk, mv) in cases:
        n, s, d = x.shape
        rows[vit.K6].append(check_k6(label, x))
        if not label.startswith("random"):
            # 64 tokens per crop (32x64 crops): each slab's first 64 token
            # rows; every slab bucket is a multiple of 16, so N is even.
            rows[vit.K6].append(check_k6(f"{label}/S=64", x[:, :64].contiguous()))

        lg = decode.greedy_decode(mk, mv, *dargs)
        pl = decode.greedy_decode_plain(mk, mv, *dargs)
        torch.cuda.synchronize()
        same = float((first_eos_ids(lg) == first_eos_ids(pl)).all(1).float().mean())
        err7 = float((lg[:, 0] - pl[:, 0]).abs().max())
        if not torch.isfinite(lg).all() or same < K7_MIN_IDS or err7 > K7_MAX_STEP0:
            fail(f"{decode.K7} on {label}: ids equal on {same:.4f} of crops, step-0 "
                 f"max abs err {err7}")
        b_ms = decode_bytes(lg, mk, mv, pq.dec_stacked, decode.TB, bos) / HBM_BYTES_PER_S * 1e3
        o_ms = decode_ops(lg, decode.TB, d, pq.dec_stacked["f1_b"].shape[0], s, C) \
            / BF16_OPS_PER_S * 1e3
        row = {"input": label, "n": n, "ids_equal": same, "max_abs_err": err7,
               "ms": cuda_ms(lambda: decode.greedy_decode(mk, mv, *dargs), 20),
               "plain_ms": cuda_ms(lambda: decode.greedy_decode_plain(mk, mv, *dargs), 3, 1),
               "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
               "ms_by_tile": {}, "ids_equal_by_tile": {}}
        # The tiles run side by side: a call lasts as long as its longest tile.
        row["steps"] = max(steps for _, _, steps in tile_steps(lg, decode.TB))
        row["ms_per_step"] = row["ms"] / row["steps"]
        row["device_ms"], row["launches_per_call"] = traced_per_call(
            lambda: decode.greedy_decode(mk, mv, *dargs))
        for tb, cs in K7_TILES:  # why the engine takes decode.TB crops, CLUSTER CTAs
            key = f"{tb}x{cs}"
            lt = decode.greedy_decode(mk, mv, *dargs, tb=tb, cluster=cs)
            pt = decode.greedy_decode_plain(mk, mv, *dargs, tb=tb) if tb != decode.TB else pl
            row["ids_equal_by_tile"][key] = float(
                (first_eos_ids(lt) == first_eos_ids(pt)).all(1).float().mean())
            row["ms_by_tile"][key] = cuda_ms(
                lambda: decode.greedy_decode(mk, mv, *dargs, tb=tb, cluster=cs), 10)
        rows[decode.K7].append(row)
        print(f"kernel {decode.K7:24s} {label:18s} N={n} ids_equal={same:.4f} "
              f"step0_err={err7:.2e} ms={row['ms']:.4f} plain_ms={row['plain_ms']:.3f} "
              f"bound_ms={row['bound_ms']:.5f} steps={row['steps']} "
              f"ms_per_step={row['ms_per_step']:.4f} ms_by_tile="
              f"{json.dumps(row['ms_by_tile'])}", flush=True)

    rows[vit.K6].append(check_k6_mlp_width(heads, eps))
    sources = {vit.K6: ("tuatara_tpu_torch/csrc/vit.cu", "tuatara_tpu/ops/pallas/vit.py:181"),
               decode.K7: ("tuatara_tpu_torch/csrc/decode.cu",
                           "tuatara_tpu/ops/pallas/decode.py:271")}
    out = []
    for name, rs in rows.items():
        main_rows = [r for r in rs if not r["input"].startswith("random")]

        def mean(key):
            return sum(r[key] for r in main_rows) / len(main_rows)

        s64 = [r for r in main_rows if r.get("s") == 64]
        main_rows = [r for r in main_rows if r.get("s", 128) == 128]
        row = {"name": name, "route": "cuda", "source": sources[name][0],
               "replaces": sources[name][1], "launches": launches.get(name, 0),
               "max_abs_err": max(r["max_abs_err"] for r in rs),
               "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
               "bound_by": main_rows[0]["bound_by"], "library_ms": None,
               "timed_on": "mean over the latency path's slabs of the four pages",
               "per_input": rs}
        if name == vit.K6:
            traced = [r["launches_per_call"] for r in main_rows if r["launches_per_call"]]
            row["launches_per_call"] = max(traced) if traced else None
            row["eager_ms"] = mean("eager_ms")
            row["s64"] = {k: sum(r[k] for r in s64) / len(s64)
                          for k in ("ms", "plain_ms", "eager_ms", "bound_ms")}
            row["s64"]["max_rel_err"] = max(max(r["rel_err"], r["memory_rel_err"]) for r in s64)
            for key in ("split_ms", "split_library_ms"):  # S = 128 slabs, where traced
                have = [r[key] for r in main_rows if r[key]]
                row[key] = {k: mean_of([h[k] for h in have]) for k in have[0]} \
                    if have else None
            row["s64"]["min_control_rel_err"] = min(
                max(r["control_rel_err"], r["control_memory_rel_err"]) for r in s64)
        row["device_ms"] = mean_of([r["device_ms"] for r in main_rows])
        if name == decode.K7:
            row["ms_per_step"] = mean("ms_per_step")
            traced = [r["launches_per_call"] for r in main_rows if r["launches_per_call"]]
            row["launches_per_call"] = max(traced) if traced else None
        out.append(row)
    return out


def check_synthetic(weights, preset="latency", record=SYNTHETIC + ".json"):
    """Phase 6 (and 6c with preset "production"): the 16 synthetic pages
    through `OcrConfig.<preset>(canvas_size=256, max_boxes=32,
    rec_buckets=(32,))` against the JAX record."""
    import numpy as np

    import tuatara_tpu_torch
    from tuatara_tpu_torch.utils.metrics import transcript_agreement, word_accuracy

    pages = np.load(SYNTHETIC + ".npz")["pages"]
    with open(SYNTHETIC + ".json") as f:
        truths = json.load(f)["truths"]
    with open(record) as f:
        ref = json.load(f)
    cfg = getattr(tuatara_tpu_torch.OcrConfig, preset)(canvas_size=256, max_boxes=32,
                                                       rec_buckets=(32,))
    got = [tuatara_tpu_torch.image_to_data(p, weights, config=cfg) for p in pages]
    hit = sum(transcript_agreement(r, g)[0] for r, g in zip(ref["words"], got))
    total = sum(len(r) for r in ref["words"])
    acc = word_accuracy(got, truths)
    print(f"synthetic {preset}: {hit}/{total} JAX words matched ({hit / total:.4f}); word "
          f"accuracy {acc:.4f} (JAX record {ref['word_acc']:.4f})", flush=True)
    if hit / total < MIN_AGREEMENT:
        fail(f"synthetic pages ({preset}): transcript agreement {hit / total:.4f} < "
             f"{MIN_AGREEMENT}")
    if acc < ref["word_acc"] - MAX_ACC_DROP:
        fail(f"synthetic pages ({preset}): word accuracy {acc:.4f} more than {MAX_ACC_DROP} "
             f"below the JAX record's {ref['word_acc']:.4f}")


def check_fused_stage1(engine, pages, results):
    """Phase 6b: FUSED_STAGE1 = "on"; the synthetic gate with launch counts
    zeroed just before and read just after, then the default path's four
    pages beside their transcripts without K8. -> the synthetic run's
    launch counts."""
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.kernels.stage1 import K8
    from tuatara_tpu_torch.models import craft
    from tuatara_tpu_torch.utils.image import load_image

    old = craft.FUSED_STAGE1
    craft.FUSED_STAGE1 = "on"
    try:
        reset_launches()
        check_synthetic(WEIGHTS)
        launches = dict(LAUNCHES)
        print(f"path B launches (16 synthetic pages): {json.dumps(launches)}", flush=True)
        if launches.get(K8, 0) < 1:
            fail(f"kernel {K8} was not launched on path B")
        for name, img in pages.items():
            words = engine.run(img)
            same = sum(a["text"] == b["text"] for a, b in zip(words, results[name]))
            print(f"path B default {name}: {len(words)} boxes ({len(results[name])} without "
                  f"K8; {same} transcripts equal): "
                  + " ".join(w["text"] for w in words[:10]), flush=True)
        for name in GRAY_PAGES:
            img = load_image(os.path.join(ROOT, "images", f"{name}.png"), keep_gray=True)
            reset_launches()
            words = engine.run(img)
            if img.ndim != 2 or LAUNCHES[K8] < 1:
                fail(f"path B gray page {name} {img.shape}: {K8} launched {LAUNCHES[K8]} times")
            if not any(w["text"] for w in words):
                fail(f"path B gray page {name}: no boxes with text")
            print(f"path B gray {name}: {len(words)} boxes: "
                  + " ".join(w["text"] for w in words[:10]), flush=True)
    finally:
        craft.FUSED_STAGE1 = old
    return launches


def drive(config, pages, required):
    """Run `image_to_data` on every page with launch counts zeroed just
    before and read just after; every kernel in `required` must have run
    and every page must give boxes with text."""
    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    results = {n: tuatara_tpu_torch.image_to_data(img, WEIGHTS, config=config)
               for n, img in pages.items()}
    launches = dict(LAUNCHES)
    for name in required:
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the path")
    for name, words in results.items():
        if not words or not any(w["text"] for w in words):
            fail(f"page {name}: no boxes with text")
    return results, launches


def drive_each_page(config, pages, required):
    """`image_to_data` page by page, launch counts zeroed just before and
    read just after each page: every kernel in `required` must have run on
    every page ({name: least launches a page}), and every page must give
    boxes with text. -> (results, summed launches)."""
    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches

    results, total = {}, {}
    for page, img in pages.items():
        reset_launches()
        results[page] = tuatara_tpu_torch.image_to_data(img, WEIGHTS, config=config)
        launches = dict(LAUNCHES)
        for name, least in required.items():
            if launches.get(name, 0) < least:
                fail(f"page {page}: kernel {name} launched {launches.get(name, 0)} times "
                     f"(at least {least})")
        if not any(w["text"] for w in results[page]):
            fail(f"page {page}: no boxes with text")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return results, total


def check_calibration(pages):
    """Calibrate a production() engine on two pages, save calibration.npz
    beside links to the weights under build/, load it in a new engine
    from there: equal scales and equal results on the four pages. -> the
    calibrated engine."""
    import shutil

    import torch

    import tuatara_tpu_torch
    from tuatara_tpu_torch.utils import weights as W

    cfg = tuatara_tpu_torch.OcrConfig.production()
    first = tuatara_tpu_torch.OcrEngine(cfg, weights_dir=WEIGHTS)
    names = list(pages)[:2]
    n = first.calibrate([pages[p][None] for p in names])
    wdir = os.path.join(ROOT, "build", "calibrated_weights")
    shutil.rmtree(wdir, ignore_errors=True)
    os.makedirs(wdir)
    try:
        for f in (W.CRAFT_FILE, W.PARSEQ_FILE, W.CONFIG_FILE):
            os.symlink(os.path.join(WEIGHTS, f), os.path.join(wdir, f))
        first.save_calibration(os.path.join(wdir, W.CALIB_FILE))
        second = tuatara_tpu_torch.OcrEngine(cfg, weights_dir=wdir)
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    a, b = dict(first.craft.qconvs()), dict(second.craft.qconvs())
    if a.keys() != b.keys() or any(a[k].sx is None or not torch.equal(a[k].sx, b[k].sx)
                                   for k in a):
        fail("calibration: the loaded scales differ from the saved ones")
    for page, img in pages.items():
        if first.run(img) != second.run(img):
            fail(f"calibration: page {page} differs between the calibrated engine and the "
                 f"engine that loaded its calibration.npz")
    sx = {k: float(q.sx) for k, q in a.items()}
    print(f"calibration: {n} layers on {names}; saved, loaded, equal scales and results on "
          f"{len(pages)} pages; sx {json.dumps(sx)}", flush=True)
    return first


def warm_rates(engines, pages, reps=3):
    """Warm ms/page of each engine, in turns, with its detect/recognize
    split (`last_timings`: with speculative recognition, detect spans the
    dispatch to the combined fetch, recognition included, and recognize
    only a fallback pass)."""
    import torch

    print(f"warm, in turns: {', '.join(engines)}", flush=True)

    acc = {k: {"s": 0.0, "detect_s": 0.0, "recognize_s": 0.0} for k in engines}
    for _ in range(reps):
        for name, engine in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for img in pages.values():
                engine.run(img)
                for k in ("detect_s", "recognize_s"):
                    acc[name][k] += engine.last_timings[k]
            torch.cuda.synchronize()
            acc[name]["s"] += time.perf_counter() - t0
    n = reps * len(pages)
    for name, a in acc.items():
        print(f"{name} warm: {n / a['s']:.3f} pages/s ({a['s'] / n * 1e3:.1f} ms/page; detect "
              f"{a['detect_s'] / n * 1e3:.1f} ms, recognize {a['recognize_s'] / n * 1e3:.1f} ms)",
              flush=True)


def dense_batches():
    """BASELINE.md config 1 as bench.py builds it: funsd_0001129658 read
    gray, 16 times as one [16, H, W] batch; the stream is DENSE_STREAM
    batches `pages + i % 5`."""
    import numpy as np

    from tuatara_tpu_torch.utils.image import load_image

    img = load_image(os.path.join(ROOT, "images", f"{K8_BATCH_PAGE}.png"), keep_gray=True)
    pages = np.broadcast_to(img, (K8_BATCH,) + img.shape).copy()
    return [pages + np.uint8(i % 5) for i in range(DENSE_STREAM)]


def traced_busy(fn):
    """Device busy ms (the union of kernel, memcpy and memset records) and
    the wall ms of one `torch.profiler` trace (CUDA activity only) of fn."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from profile_torch_port import busy_us

    path = os.path.join(ROOT, "build", "serving_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return busy_us(events) / 1e3, wall


def check_invariance(engine, batches):
    """What the serving loop's equalities rest on, on this card: the
    recognizer head's product (`PaddedLinear`, 96 columns) gives a row the
    same result at any row count, where the plain 95-column product need
    not (printed as a control; fatal if the padded one differs); and float
    CRAFT batched beside page by page, in scores and in time on the dense
    batch (printed: why `detect` runs it one page at a time, and what that
    costs)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tuatara_tpu_torch.ops.resize import canvas_prep

    head = engine.parseq.head
    dev = engine.device
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4096, head.weight.shape[1], device=dev, generator=g).to(head.weight.dtype)
    rows = (32, 64, 256, 512, 1024, 4096)
    bad = {}
    with torch.inference_mode():
        for name, fn in (("padded", head), ("plain", lambda v: F.linear(v, head.weight,
                                                                         head.bias))):
            ref = fn(x[:16])
            bad[name] = [m for m in rows if not torch.equal(fn(x[:m])[:16], ref)]
        pair = torch.from_numpy(np.stack([batches[0][0], batches[1][0]])).to(dev)[..., None]
        can = torch.stack([canvas_prep(p, engine.config) for p in pair])
        both = engine.craft(can)[0]
        diff = max(float((engine.craft(can[i:i + 1])[0][0] - both[i]).abs().max())
                   for i in range(2))
        dense = torch.from_numpy(batches[0]).to(dev)[..., None]
        can = torch.stack([canvas_prep(p, engine.config) for p in dense])
        batched = cuda_ms(lambda: engine.craft(can), 3) / len(can)
        one = cuda_ms(lambda: [engine.craft(c[None]) for c in can], 3) / len(can)
    print(f"invariance: recognizer head ({tuple(head.weight.shape)}, {head.weight.dtype}) rows "
          f"0-15 differ from a 16-row call at row counts {bad['padded']} padded to 96 columns, "
          f"{bad['plain']} unpadded; float CRAFT, two dense pages batched vs one at a time: "
          f"max abs score diff {diff}; on the {len(can)} dense pages {batched:.3f} ms/page "
          f"batched, {one:.3f} ms/page one at a time (CUDA events)", flush=True)
    if bad["padded"]:
        fail(f"the padded recognizer head depends on the row count: {bad['padded']}")


def check_serving(engines, pages, required, phase="3e"):
    """Phase 3e: the serving loop on the dense batch. For each engine: a
    loop of run_pages from a cold speculation state (every batch after the
    first dispatched speculatively), then run_stream(prefetch=4, depth=2)
    from a cold state with launch counts zeroed just before and read just
    after: equal results element by element, and every kernel of
    `required[name]` ({kernel: least launches a batch}) launched; run_mixed
    over the four pages and two dense pages equals run on each; warm
    pages/s of the loop and the stream in turns, a traced run of each
    (device busy ms/page, idle share) and the stream's peak memory."""
    import torch

    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    batches = dense_batches()
    if "default" in engines:
        check_invariance(engines["default"], batches)
    n_pages = sum(len(b) for b in batches)
    mixed = list(pages.values()) + [batches[0][0], batches[1][0]]
    for name, engine in engines.items():
        engine._spec.clear()
        engine.reset_stats()
        want = [engine.run_pages(b) for b in batches]
        st = dict(engine.stats)
        spec = st["spec_hits"] + st["spec_misses"]
        print(f"serving {name}: run_pages loop, cold: {st['boxes']} boxes on {n_pages} pages, "
              f"spec hits {st['spec_hits']} misses {st['spec_misses']} wasted "
              f"{st['spec_wasted']}", flush=True)
        if spec != len(batches) - 1:
            fail(f"serving {name}: {spec} speculative batches in the run_pages loop, not "
                 f"{len(batches) - 1}")
        engine._spec.clear()
        engine.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        got = engine.run_stream(batches, prefetch=4, depth=2)
        launches = dict(LAUNCHES)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        st = dict(engine.stats)
        print(f"serving {name}: run_stream launches {json.dumps(launches)}; spec hits "
              f"{st['spec_hits']} misses {st['spec_misses']}; peak memory {peak:.2f} GiB",
              flush=True)
        for kernel, least in required[name].items():
            if launches.get(kernel, 0) < least * len(batches):
                fail(f"serving {name}: kernel {kernel} launched {launches.get(kernel, 0)} "
                     f"times on {len(batches)} batches (at least {least} a batch)")
        if got != want:
            diff = sum(g != w for gb, wb in zip(got, want) for g, w in zip(gb, wb))
            fail(f"serving {name}: run_stream differs from the run_pages loop on {diff} of "
                 f"{n_pages} pages")
        if engine.run_mixed(mixed, max_batch=2) != [engine.run(p) for p in mixed]:
            fail(f"serving {name}: run_mixed differs from run on each page")
        rates = {"run_pages": 0.0, "run_stream": 0.0}
        for kind in ("run_pages", "run_stream", "run_stream", "run_pages"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "run_pages":
                for b in batches:
                    engine.run_pages(b)
            else:
                engine.run_stream(batches, prefetch=4, depth=2)
            torch.cuda.synchronize()
            rates[kind] += time.perf_counter() - t0
        line = [f"{kind} {2 * n_pages / s:.3f} pages/s" for kind, s in rates.items()]
        for kind, fn in (("run_pages", lambda: [engine.run_pages(b) for b in batches]),
                         ("run_stream", lambda: engine.run_stream(batches, prefetch=4,
                                                                  depth=2))):
            busy, wall = traced_busy(fn)
            line.append(f"{kind} traced: device busy {busy / n_pages:.3f} ms/page, wall "
                        f"{wall / n_pages:.3f} ms/page, idle share {1 - busy / wall:.3f}")
        print(f"serving {name} warm, in turns: " + "; ".join(line), flush=True)
    print(f"serving: run_stream == run_pages on {len(batches)} dense batches of "
          f"{K8_BATCH} pages and run_mixed == run for {', '.join(engines)}; phase {phase} "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def geometry_engine(config):
    """An engine of a rotated or tiled configuration, outside get_engine's
    cache."""
    import tuatara_tpu_torch

    return tuatara_tpu_torch.OcrEngine(config, weights_dir=WEIGHTS)


def check_geometry_parity(pages, post):
    """Phase 3f, fp32 (TF32 off, as phase 5): each variant of the rotated
    and tiled records on the four pages and rotated_text, page by page
    with counts zeroed just before and read just after: at least
    MIN_WORD_SHARE of JAX's words with the same bbox and text; K1-K3 on
    every page; H1 on every page of the exact fit that does not tile and
    on no other. -> {variant: summed launches}."""
    import torch

    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.kernels.hull import H1

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for fixture in (FIXTURE_ROTATED, FIXTURE_TILED):
            with open(fixture) as f:
                variants = json.load(f)["variants"]
            for variant, rec in variants.items():
                cfg = tuatara_tpu_torch.OcrConfig(**rec["config"])
                eng = geometry_engine(cfg)
                total = {}
                for name, img in pages.items():
                    h, w = img.shape[:2]
                    exact = eng._rotated(h, w) and cfg.rotated_fit == "exact"
                    reset_launches()
                    got = eng.run(img)
                    launches = dict(LAUNCHES)
                    for k in post:
                        if launches.get(k, 0) < 1:
                            fail(f"geometry {variant} {name}: kernel {k} was not launched")
                    if bool(launches.get(H1, 0)) != exact:
                        fail(f"geometry {variant} {name}: {H1} launched {launches.get(H1, 0)} "
                             f"times ({'an' if exact else 'no'} exact fit)")
                    share = word_share(rec["pages"][name]["words"], got)
                    print(f"geometry fp32 {variant} {name}: tiled={eng._tiled(h, w)} {share:.4f} "
                          f"of {len(rec['pages'][name]['words'])} JAX words matched ({len(got)} "
                          f"port words); launches {json.dumps(launches)}", flush=True)
                    if share < MIN_WORD_SHARE:
                        fail(f"geometry fp32 {variant} on {name}: {share:.4f} < {MIN_WORD_SHARE}")
                    for k, n in launches.items():
                        total[k] = total.get(k, 0) + n
                out[variant] = total
                del eng
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def check_geometry(engines, pages, post):
    """Phase 3f: rotated boxes and tiled detection on the card. fp32
    parity (check_geometry_parity); production(tiled_detection=True,
    canvas_size=512) page by page: every page's tiles in one int8 CRAFT
    batch (a forward hook counts the rows), all 28 int8 convs, K1-K3;
    the tiled engine (canvas 512: the four pages tile, rotated_text does
    not): run_mixed equal to run, run_stream equal to a run_pages loop;
    warm pages/s of default, latency(), rotated exact and pca, tiled at
    canvas 1024 and 512, in turns; then latency(box_mode="rotated") on
    the dense batch under phase 3e's gates, H1 on every page.
    -> (parity launches, the bf16 engines timed: default, latency,
    rotated_exact, rotated_pca, tiled, tiled512)."""
    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.kernels.hull import H1
    from tuatara_tpu_torch.ops.tiling import tile_positions

    t_phase = time.perf_counter()
    OcrConfig = tuatara_tpu_torch.OcrConfig
    parity = check_geometry_parity(pages, post)

    prod = geometry_engine(OcrConfig.production(tiled_detection=True, canvas_size=512))
    n_q = len(prod.craft.qconvs())
    rows = []
    hook = prod.craft.register_forward_pre_hook(lambda m, args: rows.append(args[0].shape[0]))
    try:
        for name, img in pages.items():
            h, w = img.shape[:2]
            if not prod._tiled(h, w):
                continue
            _, _, ph, pw, _ = prod._tiled_geometry(h, w, "cpu")
            stride = prod.config.canvas_size - prod.config.tile_overlap
            n_tiles = (len(tile_positions(ph, prod.config.canvas_size, stride))
                       * len(tile_positions(pw, prod.config.canvas_size, stride)))
            rows.clear()
            reset_launches()
            got = prod.run(img)
            launches = dict(LAUNCHES)
            print(f"geometry production tiled512 {name}: {n_tiles} tiles, CRAFT batches "
                  f"{rows}, {len(got)} boxes; launches {json.dumps(launches)}", flush=True)
            if rows != [n_tiles]:
                fail(f"production tiled {name}: CRAFT saw batches {rows}, not one of "
                     f"{n_tiles} tiles")
            if launches.get("int8_conv", 0) < n_q or any(launches.get(k, 0) < 1 for k in post):
                fail(f"production tiled {name}: int8 convs or K1-K3 not launched")
            if not any(w_["text"] for w_ in got):
                fail(f"production tiled {name}: no boxes with text")
    finally:
        hook.remove()

    tiled512 = geometry_engine(OcrConfig(tiled_detection=True, canvas_size=512))
    mixed = list(pages.values()) + [pages["table_english"][:, ::-1].copy()]
    if tiled512.run_mixed(mixed, max_batch=2) != [tiled512.run(p) for p in mixed]:
        fail("geometry tiled512: run_mixed differs from run on each page")
    table = pages["table_english"]
    batches = [table[None], table[None, :, ::-1].copy(), table[None]]
    want = [tiled512.run_pages(b) for b in batches]
    tiled512._spec.clear()
    if tiled512.run_stream(batches, prefetch=2, depth=2) != want:
        fail("geometry tiled512: run_stream differs from the run_pages loop")
    print("geometry tiled512: run_mixed == run over pages that tile and one that does not; "
          "run_stream == run_pages loop", flush=True)

    rot = {fit: geometry_engine(OcrConfig(box_mode="rotated", rotated_fit=fit))
           for fit in ("exact", "pca")}
    timed = {**engines, "rotated_exact": rot["exact"], "rotated_pca": rot["pca"],
             "tiled": geometry_engine(OcrConfig(tiled_detection=True)), "tiled512": tiled512}
    for eng in timed.values():  # first calls at a new page size pick cuDNN plans
        for img in pages.values():
            eng.run(img)
    warm_rates(timed, pages)
    check_detect_sync_free(timed, pages)

    lat_rot = geometry_engine(OcrConfig.latency(box_mode="rotated"))
    per_page = dict.fromkeys(post + (H1,), K8_BATCH)
    check_serving({"latency_rotated": lat_rot}, {k: pages[k] for k in PAGES},
                  {"latency_rotated": {**per_page, "vit_blocks": 1, "greedy_decode": 1}},
                  phase="3f")
    print(f"geometry: phase 3f {time.perf_counter() - t_phase:.1f} s", flush=True)
    return parity, timed


def check_detect_sync_free(engines, pages):
    """`detect` issues its work with no host read (so `_dispatch` can queue
    recognition behind it): each engine's detect on each page, from a
    batch already on the card, under torch.cuda.set_sync_debug_mode
    ("error"). Fatal for an engine whose detect reads the host where the
    default engine's does not."""
    import torch

    bad = {}
    for name, eng in engines.items():
        for page, img in pages.items():
            batch = torch.from_numpy(img[None]).cuda()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.detect(batch)
            except RuntimeError as e:
                bad.setdefault(name, f"{page}: {str(e).splitlines()[0][:160]}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    print(f"detect without a host read: {json.dumps({n: bad.get(n, 'yes') for n in engines})}",
          flush=True)
    if "default" not in bad and bad:
        fail(f"detect reads the host on {sorted(bad)}, the default path does not")


def hull_cases(engine, pages):
    """(label, dmin, dmax, dval) on the card for H1: the dilated profiles
    the rotated exact engine hands it on each page (captured by wrapping
    `minarearect.lower_chains` during a run), seeded random profiles at the
    main path's K = 256 (rows valid at random, x at random: many pops),
    and degenerate ones: nothing valid, one valid row, one column of equal
    x (every middle point popped), H = 1, K = 1, and convex chains of 194
    vertices, past the budget of 192."""
    import numpy as np
    import torch

    from tuatara_tpu_torch.ops import minarearect

    seen = []
    inner = minarearect.lower_chains

    def record(dmin, dmax, dval):
        seen.append((dmin.clone(), dmax.clone(), dval.clone()))
        return inner(dmin, dmax, dval)

    minarearect.lower_chains = record
    cases = []
    try:
        for name, img in pages.items():
            seen.clear()
            engine.run(img)
            if len(seen) != 1:
                fail(f"{name}: the rotated exact fit built its chains {len(seen)} times")
            cases.append((name,) + seen[0])
    finally:
        minarearect.lower_chains = inner
    rng = np.random.default_rng(11)

    def case(label, dmin, dmax, dval):
        cases.append((label, torch.from_numpy(np.float32(dmin)).cuda(),
                      torch.from_numpy(np.float32(dmax)).cuda(), torch.from_numpy(dval).cuda()))

    for h in (384, 512):
        x0 = rng.integers(0, 380, (h, 256))
        case(f"random{h}x256", x0, x0 + rng.integers(0, 40, (h, 256)),
             rng.random((h, 256)) < 0.3)
    x = np.zeros((512, 256))
    case("empty512x256", x, x, np.zeros((512, 256), bool))
    one = np.zeros((512, 256), bool)
    one[200] = True
    case("one_row512x256", x + 5, x + 9, one)
    case("column512x256", x + 7, x + 7, np.ones((512, 256), bool))
    case("h1", x[:1] + 3, x[:1] + 4, np.ones((1, 256), bool))
    case("k1", rng.integers(0, 99, (512, 1)), rng.integers(100, 200, (512, 1)),
         rng.random((512, 1)) < 0.5)
    # Rows 0-193 on a strictly convex (even columns) or concave (odd)
    # curve of 193 slopes: one chain of each holds 194 vertices, past the
    # budget of 192; differences stay below 2^14, products below 2^24.
    curve = np.zeros((512, 256))
    steps = np.cumsum(np.arange(-96, 97))
    curve[1:194, 0::2] = steps[:, None]
    curve[1:194, 1::2] = -steps[:, None]
    rows = np.zeros((512, 256), bool)
    rows[:194] = True
    case("convex194x256", curve + 5000, 9000 - curve, rows)
    torch.cuda.synchronize()
    return cases


def check_hull(engine, pages, launches):
    """Phase 4f: H1 against its plain version on `hull_cases`, bit for bit
    (hx, hy and cnt), at most 1 traced record a call; ms, device ms and
    the byte bound a call; beside it the edge sweep's device ms a page
    (`sweep_chains` on each page's chains, held to the CPU's corners
    within SWEEP_MAX_DIFF: the same edge must win). -> the kernels line's
    entry."""
    import torch

    from tuatara_tpu_torch.kernels import hull
    from tuatara_tpu_torch.ops.minarearect import sweep_chains

    rows = []
    sweep = []
    for label, dmin, dmax, dval in hull_cases(engine, pages):
        h, k = dmin.shape
        got = hull.lower_chains(dmin, dmax, dval)
        ref = hull.lower_chains_plain(dmin, dmax, dval)
        torch.cuda.synchronize()
        err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"{hull.H1} differs from its plain version on {label} (max abs err {err})")
        kfn = lambda: hull.lower_chains(dmin, dmax, dval)  # noqa: E731
        ms = cuda_ms(kfn, 30)
        dev_ms, per_call = traced_per_call(kfn)
        if per_call is not None and per_call > 2:  # the kernel and the stacks' memset
            fail(f"{hull.H1} took {per_call} records a call on {label}")
        pms = cuda_ms(lambda: hull.lower_chains_plain(dmin, dmax, dval), 2, warmup=1)
        nbytes = h * k * (4 + 4 + 1) + 2 * k * h * 4 * 2 + 2 * k * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        counts = got[2]
        rows.append({"input": label, "shape": [h, k], "ms": ms, "device_ms": dev_ms,
                     "launches_per_call": per_call, "plain_ms": pms, "bound_ms": bound,
                     "max_abs_err": err})
        print(f"kernel {hull.H1:24s} {label:18s} H={h} K={k} max_chain={int(counts.max())} "
              f"ms={ms:.4f} device_ms={dev_ms} records/call={per_call} plain_ms={pms:.3f} "
              f"bound_ms={bound:.5f}", flush=True)
        if label in pages:
            corners, over = sweep_chains(*got)
            cpu, cpu_over = sweep_chains(*(t.cpu() for t in got))
            diff = float((corners.cpu() - cpu).abs().max())
            if diff > SWEEP_MAX_DIFF or not torch.equal(over.cpu(), cpu_over):
                fail(f"edge sweep on {label}: the card's corners differ from the CPU's by "
                     f"{diff} (another edge won)")
            s_ms = cuda_ms(lambda: sweep_chains(*got), 10)
            events = traced_kernels(lambda: [sweep_chains(*got) for _ in range(5)],
                                    os.path.join(ROOT, "build", "sweep_trace.json"), False,
                                    cats=("kernel", "gpu_memset", "gpu_memcpy"))
            s_dev = sum(e["dur"] for e in events) / 1e3 / 5
            sweep.append((s_ms, s_dev))
            print(f"edge sweep {label:18s} K={k} ms={s_ms:.4f} device_ms={s_dev:.4f} "
                  f"records/call={len(events) / 5} card==cpu bit for bit: "
                  f"{torch.equal(corners.cpu(), cpu)} (max diff {diff})", flush=True)
    main = [r for r in rows if r["input"] in pages]

    def mean(key):
        return mean_of([r[key] for r in main])

    n_pages = len(pages)
    per_page = launches.get(hull.H1, 0) / n_pages
    traced = [r["launches_per_call"] for r in rows if r["launches_per_call"] is not None]
    sweep_ms = mean_of([a for a, _ in sweep])
    sweep_dev = mean_of([b for _, b in sweep])
    print(f"edge sweep: mean over the pages ms/page={sweep_ms} device_ms/page={sweep_dev}",
          flush=True)
    return {
        "name": hull.H1, "route": "cuda", "source": "tuatara_tpu_torch/csrc/hull.cu",
        "replaces": "tuatara_tpu/ops/minarearect.py:117 (_lower_chains, outside Pallas: "
                    "no TPU kernel)",
        "launches": launches.get(hull.H1, 0), "launches_per_page": per_page,
        "equal": True, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mean("ms"), "device_ms": mean("device_ms"),
        "device_ms_per_page": (mean("device_ms") * per_page
                               if mean("device_ms") is not None else None),
        "launches_per_call": max(traced) if traced else None,
        "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"), "bound_by": "bytes",
        "library_ms": None, "timed_on": "mean over the rotated exact path's pages",
        "edge_sweep_ms_per_page": sweep_ms, "edge_sweep_device_ms_per_page": sweep_dev,
        "other_inputs": {r["input"]: {"ms": r["ms"], "device_ms": r["device_ms"]}
                         for r in rows if r["input"] not in pages},
    }


def large_page():
    """Four funsd_0001129658 pages tiled 2 x 2 into one 2000 x 1508 RGB page."""
    import numpy as np

    from tuatara_tpu_torch.utils.image import load_image

    img = load_image(os.path.join(ROOT, "images", f"{K8_BATCH_PAGE}.png"))
    return np.concatenate([np.concatenate([img, img], 1)] * 2, 0)


def main() -> int:
    faulthandler.dump_traceback_later(1000, exit=True)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels._build import build_all
    from tuatara_tpu_torch.utils.image import load_image

    # The phases keep the first engines of get_engine's cache to the end
    # and add others through image_to_data: room for all, so none is
    # evicted (and closed) while held.
    tuatara_tpu_torch.api.ENGINE_CACHE_MAX = 8

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
    post = ("label_components_aux", "area_ok", "component_stats_nopeak")
    t0 = time.perf_counter()
    default = tuatara_tpu_torch.OcrConfig()
    engine = tuatara_tpu_torch.api.get_engine(default, WEIGHTS)
    print(f"engine load: {time.perf_counter() - t0:.1f} s", flush=True)
    results, launches = drive(default, pages, post)
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    for name, words in results.items():
        print(f"bf16 {name}: {len(words)} boxes: "
              + " ".join(w["text"] for w in words[:10]), flush=True)

    # 3b. the latency() preset: fused recognizer kernels
    latency = tuatara_tpu_torch.OcrConfig.latency()
    lat = tuatara_tpu_torch.api.get_engine(latency, WEIGHTS)
    lat_results, lat_launches = drive(latency, pages, post + ("vit_blocks", "greedy_decode"))
    print(f"latency path launches: {json.dumps(lat_launches)}", flush=True)
    for name, words in lat_results.items():
        same = sum(a["text"] == b["text"] for a, b in zip(words, results[name]))
        print(f"latency {name}: {len(words)} boxes ({same} transcripts as the default "
              f"path's): " + " ".join(w["text"] for w in words[:10]), flush=True)
    warm_rates({"default": engine, "latency": lat}, pages)

    # 3d. production(): int8 CRAFT + K6/K7; calibration; warm rates in turns
    production = tuatara_tpu_torch.OcrConfig.production()
    prod = tuatara_tpu_torch.api.get_engine(production, WEIGHTS)
    n_q = len(prod.craft.qconvs())
    prod_results, prod_launches = drive_each_page(
        production, pages, {**dict.fromkeys(post + ("vit_blocks", "greedy_decode"), 1),
                            "int8_conv": n_q})
    print(f"production path launches ({n_q} int8 convs a page): "
          f"{json.dumps(prod_launches)}", flush=True)
    for name, words in prod_results.items():
        same = sum(a["text"] == b["text"] for a, b in zip(words, lat_results[name]))
        print(f"production {name}: {len(words)} boxes ({len(lat_results[name])} on the latency "
              f"path; {same} transcripts as its): " + " ".join(w["text"] for w in words[:10]),
              flush=True)
    calibrated = check_calibration(pages)
    warm_rates({"default": engine, "latency": lat, "production": prod,
                "production_calibrated": calibrated}, pages)

    # 3e. the serving loop on the dense batch
    per_page = dict.fromkeys(post, K8_BATCH)
    fused = {**per_page, "vit_blocks": 1, "greedy_decode": 1}
    check_serving({"default": engine, "latency": lat, "production_calibrated": calibrated},
                  pages, {"default": per_page, "latency": fused,
                          "production_calibrated": {**fused, "int8_conv": n_q}})

    # 3c. path A: text_threshold < low_text (K4, K5)
    low = tuatara_tpu_torch.OcrConfig(text_threshold=LOW_THRESHOLD)
    low_results, low_launches = drive(low, pages, ("label_components", "area_ok",
                                                   "component_stats"))
    print(f"path A launches: {json.dumps(low_launches)}", flush=True)
    for name in ("label_components", "area_ok", "component_stats"):
        if low_launches.get(name, 0) < len(pages):
            fail(f"path A: {name} launched {low_launches.get(name, 0)} times on "
                 f"{len(pages)} pages")
    for name in ("label_components_aux", "component_stats_nopeak"):
        if low_launches.get(name, 0):
            fail(f"path A launched {name}, a kernel of the other branch")
    for name, words in low_results.items():
        print(f"path A {name}: {len(words)} boxes (default path {len(results[name])}): "
              + " ".join(w["text"] for w in words[:10]), flush=True)

    # 3f. rotated boxes (H1) and tiled detection
    geo_pages = {**pages, "rotated_text": load_image(os.path.join(ROOT, "images",
                                                                  "rotated_text.png"))}
    geo_launches, geo_engines = check_geometry({"default": engine, "latency": lat}, geo_pages,
                                               post)

    # 4. kernels vs their plain versions (4, 4c, 4b; 4d after 6b, which
    # gives K8's launches on its path)
    tiled512, tiled1024 = geo_engines["tiled512"], geo_engines["tiled"]
    stitched = ([(f"tiled512/{n}", tiled512, img) for n, img in pages.items()]
                + [("tiled1024/table_english", tiled1024, pages["table_english"]),
                   ("tiled1024/funsd2x2", tiled1024, large_page())])
    kernels = check_kernels(engine, pages, launches, low_launches, stitched)
    kernels.append(check_hull(geo_engines["rotated_exact"], geo_pages, geo_launches["exact"]))
    kernels += check_recognizer_kernels(lat, engine, pages, lat_launches)
    int8_summary = check_int8_conv(prod, pages)
    int8_summary["launches"] = prod_launches.get("int8_conv", 0)

    # 5. float32 parity with the JAX reference
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag, fixture, overrides in (("", FIXTURE, {}),
                                    (" path A", FIXTURE_LOW, {"text_threshold": LOW_THRESHOLD})):
        with open(fixture) as f:
            ref = json.load(f)["pages"]
        f32 = tuatara_tpu_torch.OcrEngine(
            tuatara_tpu_torch.OcrConfig(compute_dtype="float32", **overrides),
            weights_dir=WEIGHTS)
        for name, img in pages.items():
            got = f32.run(img)
            share = word_share(ref[name]["words"], got)
            print(f"fp32 parity{tag} {name}: {share:.4f} of {len(ref[name]['words'])} "
                  f"JAX words matched ({len(got)} port words)", flush=True)
            if share < MIN_WORD_SHARE:
                fail(f"fp32 parity{tag} on {name}: {share:.4f} < {MIN_WORD_SHARE}")

    # 6. confident pages through the latency path; 6c through production()
    check_synthetic(WEIGHTS)
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    check_synthetic(WEIGHTS, "production", SYNTHETIC_PRODUCTION)
    if LAUNCHES["int8_conv"] < 1:
        fail("synthetic production: no int8 conv ran")

    # 6b. path B: the same with K8 in CRAFT's stage 1; then 4d
    stage1_launches = check_fused_stage1(engine, pages, results)
    kernels += check_stage1(engine, pages, stage1_launches)

    print(json.dumps({"int8_conv": int8_summary}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
