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
             have run (K1-K3 and `bias_act`, the bias add and ReLU of
             CRAFT's float convolutions, the bias add and GELU of
             PARSEQ's fc1, and the fp32 bias and residual adds of its
             residual Linears). Every page must give boxes with text. Prints boxes,
             first words and warm pages/sec.
3b. latency: the same pages through `image_to_data(..., config=
             OcrConfig.latency())`: the /32 canvas, the 16-first slab ladder
             and the fused recognizer kernels K6 (`vit_blocks`) and K7
             (`greedy_decode`). Counts zeroed just before and read just
             after: K1-K3, K6, K7 and `bias_act` must each have run. Then
             warm pages/sec
             of the default and the latency path, in turns in this call.
3d. production: the same pages through `image_to_data(..., config=
             OcrConfig.production())`: int8 CRAFT (dynamic activation
             scales) in front of K6 and K7. Page by page, counts zeroed
             just before and read just after: K1-K3, K6, K7, SC
             (`stem_conv`, int8 CRAFT's conv1_1 at bf16) and the int8
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
3g. modes:   beam and NAR decode and the int8 recognizer encoder. At
             fp32, TF32 off: each variant of tests/fixtures/
             torch_reference_modes.json (decode_mode "beam" and "nar";
             quantized_serving=True with the int8 encoder, calibrated on
             the record's two pages) on the four pages and rotated_text,
             page by page: >= 95% of JAX's words with the same bbox and
             text under beam and NAR, K1-K3 on every page, every int8 conv
             and int8 linear layer on every page of the int8 engine,
             K6/K7 on none. The int8 engine's shares on those pages are
             printed, not gated (these weights read real pages as
             near-ties, and int8 grows the float layers' ulps into whole
             steps: ROADMAP Queue 3 item 14); its words are held on the 16
             synthetic pages at fp32, dynamic and calibrated, against
             tests/fixtures/torch_synthetic_quantized_fp32.json under
             phase 6's gates.
             latency(decode_mode="beam"), latency(decode_mode="nar") and
             production(encoder_impl="xla") on the four pages, page by
             page: K1-K3 everywhere, K6 under beam and NAR and K7 not, K7
             and every int8 layer and no K6 under the int8 encoder. The 16
             synthetic pages through the same three (the int8 one dynamic
             and calibrated on two pages) against the JAX records
             tests/fixtures/torch_synthetic_{latency_beam,latency_nar,
             production_xla}.json under phase 6's gates (the dynamic int8
             encoder at 97% of JAX's words: MIN_AGREEMENT_DYNAMIC_INT8).
             `int8_linear` on
             the encoder's real inputs (INT8_LINEARS): int32 sums equal to
             a float64 product on the card and an int64 one on the host,
             timed beside bf16 cuBLAS (one {"int8_linear": ...} line).
             Beam's T steps under set_sync_debug_mode("error"), and the
             `invariance:` probe of the beam decoder at 32-4096 rows
             (fatal if a crop's ids or score change). Phase 3e's serving
             gates on the dense batch for latency(decode_mode="beam") and
             the int8 encoder calibrated on two pages. Warm pages/s in
             turns (latency() greedy beside the new engines) at B = 1 on
             the four pages and on the dense batch's run_pages loop, with
             device busy and idle share. The command line once:
             `python -m tuatara_tpu_torch images/resume_example.png
             evals/production_weights --json-out ...`, exit 0 and >= 95%
             of the in-process default engine's words.
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
             the budget of 192), and `hull_edge_profiles` at the edges of
             its warps and rounds (K = 37 over H = 300: nothing valid, one
             row, one column, valid rows split by gaps, random; H = 1;
             K = 1), also against the plain version on the CPU;
             at most 1 record a call (the kernel writes every entry: no
             memset);
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
             (Frobenius) error of 5.5e-3 (bf16 roundings flipped by another
             sum order grow through 12 blocks), and a control that must
             exceed it: the default lowering's eager block chain (erf GELU)
             on the same input; K7's ids equal up to the first EOS on every
             crop and its step-0 logits within K7_MAX_STEP0 (its error on
             every step up to the first EOS printed). Times, bounds
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
4g. SC:      `stem_conv` (csrc/stem.cu: int8 CRAFT's conv1_1 at bf16, each
             output summed in XLA's order, its bias and ReLU) on the four
             pages' production() canvases as the path gives them, bit for
             bit against its plain version on the card and on the CPU;
             timed (CUDA events, traced device time or, where a trace
             loses records, events) beside the plain version and cuDNN's
             bf16 conv2d with its bias (the library call), with its bound
             (operations: 9 cin fp32 fma an output). Then, bit for bit on
             the card and the CPU, seeded inputs at STEM_EDGE_SHAPES (1, 2,
             tile - 1 and tile + 1 rows and columns of its 8 x 32 tile, odd
             widths near 600, gray and RGB, cout 8, 64 and 256).
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
7. training: at full width (CraftConfig(), ParseqConfig()) from
             `evals/production_weights`, two joint `train_step`s on the
             batch of tests/fixtures/torch_train_fullwidth.npz (one 128x128
             page, 4 crops) with JAX's permutations, at fp32 (TF32 off) and
             bf16, held to that JAX record (metrics, each leaf's and each
             model's update norm, the first BatchNorm's running
             statistics; bounds at FP32_* and BF16_*); the bf16 CRAFT loss's
             gradient before AdamW from the production weights on that
             page against JAX's record (tests/fixtures/
             torch_train_craft_grads.npz): each leaf's relative L2 error,
             estimated from a sketch (`grad_sketch`), median, mean and the
             worst leaf printed, the worst held to CRAFT_GRAD_MAX_REL;
             counts zeroed just
             before the bf16 steps and read just after: `bias_act` and
             `gelu_grad` (the recognizer's fc1 bias + GELU and its
             backward) must have run, and `gelu_grad` on each of those
             calls equal bit for bit to its plain version, timed beside
             it (its kernels line entry), also on all 65,536 bit patterns
             of v in bf16 and fp16 under four seeded g draws
             (`gelu_grad_draws`) and at fit_recognizer's [256, 128, 1536]
             on seeded values at fc1's scale (events, traced device time,
             its plain version, the byte and operation bounds); resume: a child
             process with deterministic algorithms
             (CUBLAS_WORKSPACE_CONFIG=:4096:8) saves after step 1, loads
             into a fresh state and takes step 2, equal bit for bit to two
             straight steps; the step-0 checkpoint (the production weights
             through the trainable modules, saved under build/train/) is
             bit-equal to them and gives their words on the four pages
             under the default config and latency(); the trained state's
             checkpoint under latency() on one page, counts zeroed just
             before and read just after, launches K1-K3, K6 and K7;
             `fit_recognizer` from scratch on 32 words of the committed
             uint8 pool tests/fixtures/torch_train_words.npz (augmented on
             the card, k_perms 6, grad_clip 1.0, weight_decay 0.01, a
             warmup schedule) ends below 0.2x its first loss and reads >=
             0.5 of the words; `fit_detector` from scratch on 8 pages of
             256x256 ends below its first loss; ms a step, samples/s and
             peak memory of fit_recognizer's step (256 crops, k_perms 6),
             fit_detector's (8 pages) and the joint step (both), bf16,
             each beside the card's name and power limit.
8. conversion, mesh, profiling, native:
             8a: the production weights mapped back to the upstream names
             (tests/torch_surrogates.py), the replicas traced on the host
             and saved under the reference's file names in build/convert/,
             converted on the card with the normalization probe: verdict
             identity for both, and every npz leaf bit-equal to
             evals/production_weights; replicas that normalize inside
             (CRAFT behind ImageNet's statistics in the engine's variant,
             with the ReLU before the fc stage of ROADMAP Queue 3 item 16;
             PARSEQ behind 2x-1) must give imagenet and pm1, baked into
             config.json, and upstream's CRAFT behind ImageNet's
             statistics "unknown"; the converted directory under
             latency() on the four pages, counts zeroed just before and
             read just after: the production weights' words and bboxes,
             K1-K3 on every page, K6 and K7. 8b: two ranks share the card
             over gloo (`--mesh-child serve`): `OcrEngine(latency(),
             mesh=make_mesh())` and production() calibrated on phase 3d's
             two pages run the dense batch at 16 and 15 pages (padding),
             each rank's results equal to the single engines', its scales
             equal, and each rank launching K1-K3 on its pages, K6, K7
             (and every int8 conv); NCCL at world size 1 in this process:
             an all_reduce on the card and the mesh engine equal to the
             plain one. 8c: two ranks over gloo (`--mesh-child train`), at
             fp32 with TF32 off and deterministic algorithms: two joint
             steps at full width at dp=2 (the record's page and its
             mirror, one a rank) and at tp=2 (the record's batch) within
             MESH_TRAIN_RTOL of the single step's metrics; the tp shard of
             enc/0/attn/q/w and its moment half of 384 rows; a sharded
             checkpoint saved at dp=2 after one step, loaded onto dp=2,
             tp=2 and one device, its leaves and moments and the next step
             bit-equal to the same state built directly; ms a step beside
             the single step (ranks sharing the card: a correctness drive,
             not a scaling number). 8d: a `utils/profiling.trace` of one
             latency() page holds the four stage names and K6's and K7's
             kernels. 8e: the card's heatmaps of the four pages through
             `native.extract_boxes` on the host beside K1-K3's boxes,
             equal counts. Prints the phase's seconds and a {"phase8":
             ...} line.
9.  no weights and the native surface: 9a, `OcrEngine(cfg, seed=0)` with
             no weights_dir for OcrConfig(), latency(), production() and
             the extended charset (ParseqConfig(charset_size=95)) on the
             four pages, page by page with counts zeroed just before and
             read just after: K1-K3 on every page, K6 and K7 on every page
             with a box under the fused presets (and one such page at
             least), every int8 conv on every page under production(); the
             state dict bit-equal to the same engine drawn for the CPU, and
             every page's results equal to an engine loaded from the draws
             saved under build/random_weights. 9b, the C ABI
             (csrc/capi/, built with g++; the build's seconds printed):
             ctypes in this process on the four pages and a gray page with
             the production weights equal to image_to_data (text, bbox and
             confidence as float32), K1-K3 launched by each call; the port's
             C example, a process with no Python host, printing the
             in-process call's lines; the same binary under
             CUDA_VISIBLE_DEVICES="" exiting nonzero with "no CUDA device".
             9d, beside it: `python -m tuatara_tpu_torch.examples.resume`
             and `.table` (its ./weights a link to the production weights)
             with at least MIN_WORD_SHARE of the engine's words; then
             `.serve` on funsd_0001129658 at --batch 16 --batches 2 alone
             (its pages/s printed, not gated). 9c, the compiled binding
             `_pytuatara_torch` through `tuatara_tpu_torch.pytuatara`
             equal to the engine's {text, bbox} on the four pages, and its
             validation contract. Prints the phase's seconds and a
             {"phase9": ...} line.
10. bf16 rounded where JAX rounds (the bias after the product's
             rounding, the decoder's conv before its upsample, the
             upsample's two contractions), and not rounded where XLA does
             not round (a Linear whose sum goes straight into an fp32
             add: PARSEQ's residuals, patch_embed + pos_embed). 10a:
             `bias_act` (csrc/bias_act.cu) against its plain version bit
             for bit on every call of the default path's four pages:
             CRAFT's ReLU-followed convolutions in their layout and the
             other (channels_last / contiguous), with ReLU, and ReLU with
             the pre-ReLU output; PARSEQ's fc1 widths with their GELU;
             seeded fp16 and bf16 tensors, 95 channels and an unaligned
             view; the GELU mode on every finite bf16 and fp16 value
             (`finite_values`); its backward (`_BiasAct`, what the training graph runs)
             against autograd through the plain version, bit for bit;
             timed a call and a page beside its plain version, torch.add
             then F.relu, and its byte bound, traced at the page's largest
             map beside that map's bound, and its host time a call beside
             torch.add then F.relu (its kernels line entry); the
             GELU mode timed on fc1's calls of the first page (events and
             traced device time a call, its plain version, torch.add then
             F.gelu, its byte bound; traced device time by shape). Its
             fp32-output mode (`bias_add_f32`, tt_bias_add_f32, r +
             (fp32(y) + fp32(b))) likewise on every distinct residual
             call of the pages (widths 384, from products 384 and 1536
             wide; residuals of y's shape, [1, S, D] and [1, 1, D]), along
             dim 1 of every CRAFT map of the pages in both layouts (the
             training graph's form), and on seeded cases of every residual
             shape and of NCHW maps (95 channels, planes not a multiple of
             8 elements, an unaligned map), its backward
             (`_BiasAddF32`) against autograd through the plain version,
             timed a call over the first page's calls beside the torch
             chain y.float() + b.float(), then + r (the kernels line's
             library_ms) and its byte bound, traced device time by y's
             shape (where every trace loses records, the same calls timed
             by CUDA events, the route printed). A line prints each mode's
             host time a call beside the two PyTorch calls it replaces
             (ReLU: torch.add, F.relu; fp32: r + torch.add(y, b); GELU:
             torch.add, F.gelu). Then the default and
             latency() pages, counts zeroed just before and read just
             after: `bias_act` once for every float conv call that a ReLU
             follows (the trunk's, each decoder level's conv2, the head's
             first four), every float Linear call with a GELU (fc1) and
             every float Linear call with a residual, taken in fp32 (beside
             K6 and K7 too), and
             no other time (a rounded bias add with no activation is
             torch.add). 10b: every
             float conv and Linear of one default page, and each float
             decoder level, against "(the same bf16 product) rounded, +
             bias, rounded", or for a Linear with a residual "r +
             (fp32(product) + fp32(bias))", computed on the card from the
             layer's inputs: at least BF16_MIN_ROUNDED of the values
             bit-equal. Then one production() page's int8 CRAFT
             (INT8_ROUNDING_PAGE): each quantized layer's dynamic scale and
             int8 input on the card equal to the CPU's plain route fed the
             same inputs (the card's int8 inputs, scales and sums of the
             layers before), fatal on any difference. 10c: the default,
             latency() and production()
             engines on the four pages against JAX's bf16 records
             (tests/fixtures/torch_reference_bf16.json) of the same
             algorithm: `OcrConfig()`'s, and for the presets JAX's with its
             Pallas recognizer kernels forced ("latency_pallas",
             "production_pallas"): the share of JAX's records with the
             same text and bbox, printed and held to BF16_FLOOR; and,
             printed only, latency() against JAX's `latency()` off a TPU
             (XLA's eager encoder and scan decode, the record the floor
             held until the forced-Pallas records existed). Prints the
             phase's seconds and a {"phase10": ...} line.

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
# K6 against its plain version: at most 4.31e-3 on every input (PERF.md
# §6); the control, the eager block chain with erf GELU, at least 6.57e-3
# (table_english's slab) since that chain rounds as JAX does (1.2e-2 before, when the tolerance
# was 7e-3): the tolerance sits between the two.
K6_MAX_REL = 5.5e-3
# K7 against its plain version, both rounding each attention product to bf16
# as the Pallas kernel does: ids equal up to the first EOS on every crop of
# every slab, step-0 logits within 9.89e-3 (the matmuls' fp32 sums in mma
# order against cuBLAS's flip a bf16 activation now and then; NVIDIA H100
# 80GB HBM3, 700 W, PERF.md §6). With exact products the kernel was held to
# 99% of crops and 5e-2.
K7_MIN_IDS = 1.0
K7_MAX_STEP0 = 1.5e-2
K7_TILES = ((4, 4), (4, 6), (8, 4), (8, 6), (16, 4), (16, 6))  # (crops, CTAs) per cluster
K8_MAX_REL = 1e-3
K8_BATCH, K8_BATCH_PAGE = 16, "funsd_0001129658"  # BASELINE.md config 1's dense batch
DENSE_STREAM = 6  # batches of the dense batch in phase 3e's stream, as bench.py builds them
MIN_AGREEMENT = 0.98
# The bf16 int8 encoder with dynamic scales on the synthetic pages (3g): its
# abs-max spans the slab, padding rows included, whose crops come from the
# invalid slots of the card's bf16 detection; one near-tie character more
# than the calibrated engine's 2 misses (PERF.md §6, PR 13).
MIN_AGREEMENT_DYNAMIC_INT8 = 0.97
SWEEP_MAX_DIFF = 1e-4  # the edge sweep's corners, card against CPU (another edge: >= 1 px)
K2_MIN_AREAS = (1, 2, 10, 16)
INT8_LAYERS = ("vgg/conv2_2/conv", "fc/fc6", "up/upconv2/conv1a", "up/upconv2/conv1b")
INT8_PAGE = "funsd_0001129658"
MAX_ACC_DROP = 0.02
FIXTURE_MODES = os.path.join(ROOT, "tests", "fixtures", "torch_reference_modes.json")
SYNTHETIC_MODES = os.path.join(ROOT, "tests", "fixtures", "torch_synthetic_{}.json")
# Phase 3g's int8 encoder layers held exact (the patch embed: K = 96).
INT8_LINEARS = ("patch_embed", "enc/0/attn/q", "enc/5/mlp/fc1", "enc/11/mlp/fc2")
BEAM_ROWS = (32, 64, 256, 1024, 4096)  # beam decoder rows (crops x beams) in the probe
INT8_OPS_PER_S = 1979e12  # int8 tensor-core peak, dense (NVIDIA data sheet, SXM, 700 W)
# H100 SXM peaks (NVIDIA data sheet, 700 W): memory rate, the vector
# (non-tensor-core) rate used for the kernels' compares, adds and atomics,
# and the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# Phase 10: JAX's bf16 records (tests/gen_torch_reference.py --config bf16),
# the share of a layer's values that must equal "(product rounded) + bias,
# rounded" (or, at a residual site, "r + (fp32(product) + fp32(bias))") on
# the card, and the least share of JAX's bf16 records of the same algorithm
# the card must give under each preset (BF16_RECORD), the card's counts
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): 99 of 113 under `OcrConfig()`
# since its residual sites keep XLA's unrounded bias add (95 before); under
# `latency()` and `production()` the forced-Pallas records, 99 of 113 and 97
# of 111 (83 until int8 CRAFT folded its BatchNorms as XLA does and summed
# conv1_1 in XLA's order: its per-tensor dynamic scales turned an ulp of
# either into another scale for the whole map). These replaced JAX's
# `latency()` off a TPU, XLA's algorithm, against which `latency()` was held
# to 92 of 113.
FIXTURE_BF16 = os.path.join(ROOT, "tests", "fixtures", "torch_reference_bf16.json")
BF16_MIN_ROUNDED = 0.9999
BF16_RECORD = {"default": "default", "latency": "latency_pallas",
               "production": "production_pallas"}
BF16_FLOOR = {"default": 99 / 113, "latency": 99 / 113, "production": 97 / 111}
INT8_ROUNDING_PAGE = "resume_example"  # 10b's int8 page (the smallest canvas, 768 x 608)


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


def host_us(fn, n: int = 2000) -> float:
    """The host's time (us) of one call of fn: n back-to-back calls, no
    sync between them, after 50 warm ones."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return us


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


def stem_inputs(prod, pages):
    """{page: args} of conv1_1's `stem_conv` call in the production()
    engine's detection of each page (its module attribute wrapped while the
    pages run): (x, weight, bias), and the packed weights where the tree's
    CRAFT passes them."""
    import torch

    from tuatara_tpu_torch.kernels import stem

    seen, orig = {}, stem.stem_conv

    def record(*args):
        seen[page] = args
        return orig(*args)

    stem.stem_conv = record
    try:
        for page, img in pages.items():
            with torch.no_grad():
                prod.detect(torch.from_numpy(img[None]).cuda())
    finally:
        stem.stem_conv = orig
    return seen


# SC's edge shapes (H, W, canvas channels, cout) around its 8 x 32 output
# tile: 1, 2, tile - 1, tile + 1 rows and columns, one whole tile, and odd
# widths near 600 over two tile rows; gray (1 channel, broadcast to the
# conv's 3) and RGB canvases; cout 8, 64 and 256.
STEM_EDGE_SHAPES = ((1, 1, 3, 64), (2, 33, 1, 8), (7, 31, 3, 256), (9, 601, 1, 64),
                    (8, 32, 3, 8), (9, 2, 3, 64), (1, 601, 3, 8), (16, 599, 1, 256))


def stem_edge_case(h, w, ch, cout, seed=0):
    """Seeded numpy inputs of SC at one edge shape: (canvas [1, h, w, ch]
    fp32 in [0, 1], weight [cout, 3, 3, 3] fp32, bias [cout] fp32), the
    weights at conv1_1's scale so that the ReLU cuts about half."""
    import numpy as np

    rng = np.random.default_rng(seed + 1000 * h + w + cout)
    canvas = rng.random((1, h, w, ch), dtype=np.float32)
    weight = (rng.standard_normal((cout, 3, 3, 3)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return canvas, weight, bias


def stem_edge_tensors(canvas, weight, bias, device):
    """SC's arguments as the int8 CRAFT forward gives them: x [1, 3, H, W]
    an NCHW view of the NHWC canvas (a gray canvas expanded, stride 0 along
    channels), the weight and bias in bf16."""
    import torch

    x = torch.from_numpy(canvas).to(device).permute(0, 3, 1, 2)
    x = x.expand(-1, 3, -1, -1) if x.shape[1] == 1 else x
    return (x, torch.from_numpy(weight).to(device, torch.bfloat16),
            torch.from_numpy(bias).to(device, torch.bfloat16))


def stem_bound_ms(x, w):
    """(bound ms, "operations" or "bytes") of SC on x [B, C, H, W] (its
    broadcast channels read once) and w [O, C, 3, 3]: 2 * 9 * C fp32
    operations an output at VECTOR_OPS_PER_S (the order of the sums rules
    out tensor cores), against the canvas read once and the bf16 output
    written once at HBM_BYTES_PER_S."""
    b, c, h, wd = x.shape
    o = w.shape[0]
    cx = 1 if c > 1 and x.stride(1) == 0 else c
    ops = b * h * wd * o * 2 * 9 * c / VECTOR_OPS_PER_S * 1e3
    nbytes = (b * h * wd * (cx * 4 + o * 2) + w.numel() * 4 + o * 4) / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= nbytes else (nbytes, "bytes")


def check_stem(prod, pages, launches):
    """Phase 4g: SC (`kernels/stem.stem_conv`, int8 CRAFT's conv1_1 at bf16
    summed in XLA's order) on each page's production() canvas, as the path
    gives it, against its plain version on the card and on the CPU, bit
    for bit; timed beside the plain version and cuDNN's bf16 conv2d with
    its bias (the library call, which sums in its own order and leaves the
    ReLU out); traced device time with the CUDA-event time where a trace
    loses records. Then the same check on STEM_EDGE_SHAPES (the weights
    packed by the call). -> the kernels line's entry."""
    import torch
    import torch.nn.functional as F

    from tuatara_tpu_torch.kernels import stem

    def equal_to_plain(label, args):
        x, w, b = args[:3]
        got = stem.stem_conv(*args)
        ref = stem.stem_conv_plain(x, w, b)
        cpu = stem.stem_conv_plain(x.cpu(), w.cpu(), b.cpu())
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        if not (torch.equal(got, ref) and torch.equal(got.cpu(), cpu)):
            fail(f"{stem.SC} on {label}: differs from its plain version (max abs err {err}; "
                 f"the CPU's plain version equal: {torch.equal(got.cpu(), cpu)})")
        return err

    rows = []
    for page, args in stem_inputs(prod, pages).items():
        x, w, b = args[:3]
        err = equal_to_plain(page, args)
        fn = lambda: stem.stem_conv(*args)  # noqa: E731
        xb, wb, bb = x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)
        dev, route = device_ms_or_events(fn, os.path.join(ROOT, "build", "stem_trace.json"), 1)
        bound, by = stem_bound_ms(x, w)
        row = {"page": page, "shape": list(x.shape), "cout": w.shape[0], "ms": cuda_ms(fn, 20),
               "device_ms": dev, "device_ms_route": route,
               "plain_ms": cuda_ms(lambda: stem.stem_conv_plain(x, w, b), 3, warmup=1),
               "library_ms": cuda_ms(lambda: F.conv2d(xb, wb, bb, padding=1), 20),
               "bound_ms": bound, "bound_by": by, "max_abs_err": err}
        rows.append(row)
        print(f"kernel {stem.SC:24s} {page:18s} {list(x.shape)}->{w.shape[0]} equal to its plain "
              f"version (card and CPU) ms={row['ms']:.4f} device_ms={dev:.4f} ({route}) "
              f"plain_ms={row['plain_ms']:.3f} library_ms={row['library_ms']:.4f} "
              f"bound_ms={bound:.5f} ({by})", flush=True)
    edges = []
    for shape in STEM_EDGE_SHAPES:
        label = "edge{}x{}c{}->{}".format(*shape)
        err = equal_to_plain(label, stem_edge_tensors(*stem_edge_case(*shape), "cuda"))
        edges.append(label)
        print(f"kernel {stem.SC:24s} {label:18s} equal to its plain version (card and CPU), "
              f"max abs err {err}", flush=True)

    def mean(key):
        return mean_of([r[key] for r in rows])

    return {"name": stem.SC, "route": "cuda", "source": "tuatara_tpu_torch/csrc/stem.cu",
            "replaces": "none: int8 CRAFT's float conv1_1, an XLA conv "
                        "(tuatara_tpu/models/layers.py:84-95), summed in XLA's order",
            "launches": launches.get(stem.SC, 0),
            "launches_per_page": launches.get(stem.SC, 0) / len(pages), "equal": True,
            "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": mean("ms"),
            "device_ms": mean("device_ms"),
            "device_ms_route": sorted({r["device_ms_route"] for r in rows}),
            "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": rows[0]["bound_by"], "library_ms": mean("library_ms"),
            "library": "F.conv2d bf16 with its bias (cuDNN; no ReLU)",
            "timed_on": "mean over the four pages' production() canvases", "per_page": rows,
            "edge_shapes_equal": edges}


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


def traced_records_ms(fn, path, expect, tries=3):
    """The device times (ms), in launch order, of the port's kernel records
    in a `torch.profiler` trace of fn() that kept all `expect` of them; a
    trace that lost some is taken again, up to `tries` times. None if none
    kept them all."""
    for _ in range(tries):
        events = traced_kernels(fn, path, True)
        if len(events) == expect:
            return [e["dur"] / 1e3 for e in events]
    return None


def traced_device_ms(fn, path, expect, tries=3):
    """The sum of `traced_records_ms` (ms), or None."""
    records = traced_records_ms(fn, path, expect, tries)
    return None if records is None else sum(records)


def device_ms_or_events(fn, path, expect, tries=3):
    """(ms, route): the traced device time of fn() (`traced_device_ms`,
    route "trace"), or where every trace lost some of the `expect` kernel
    records, the CUDA-event time of one fn() (route "events": the launches'
    host time between the kernels included, so an upper bound)."""
    ms = traced_device_ms(fn, path, expect, tries)
    if ms is not None:
        return ms, "trace"
    return cuda_ms(fn, 5), "events"


def by_shape(shapes, records):
    """{shape: [calls, mean ms]} of per-call records (None: {})."""
    out = {}
    for shape, ms in zip(shapes, records or []):
        out.setdefault(str(list(shape)), []).append(ms)
    return {k: [len(v), sum(v) / len(v)] for k, v in out.items()}


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
        # Every step up to the plain version's first EOS, on the crops whose
        # ids agree there (informative; the gate reads step 0).
        ids = pl.argmax(-1)
        upto = ((ids == 0).int().cumsum(1) - (ids == 0).int()) == 0
        agree = (first_eos_ids(lg) == first_eos_ids(pl)).all(1)
        err_steps = float(((lg - pl).abs().amax(-1) * (upto & agree[:, None])).max())
        if not torch.isfinite(lg).all() or same < K7_MIN_IDS or err7 > K7_MAX_STEP0:
            fail(f"{decode.K7} on {label}: ids equal on {same:.4f} of crops, step-0 "
                 f"max abs err {err7}")
        b_ms = decode_bytes(lg, mk, mv, pq.dec_stacked, decode.TB, bos) / HBM_BYTES_PER_S * 1e3
        o_ms = decode_ops(lg, decode.TB, d, pq.dec_stacked["f1_b"].shape[0], s, C) \
            / BF16_OPS_PER_S * 1e3
        row = {"input": label, "n": n, "ids_equal": same, "max_abs_err": err7,
               "max_abs_err_to_eos": err_steps,
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
              f"step0_err={err7:.2e} err_to_eos={err_steps:.2e} "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.3f} "
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


def synthetic_pages():
    """(the 16 synthetic pages uint8, their truths)."""
    import numpy as np

    with open(SYNTHETIC + ".json") as f:
        truths = json.load(f)["truths"]
    return np.load(SYNTHETIC + ".npz")["pages"], truths


def synthetic_gate(label, got, ref, truths, min_agreement=MIN_AGREEMENT):
    """Phase 6's gates: at least `min_agreement` of the JAX record's words
    (`ref`: {"words", "word_acc"}) matched by a distinct word with the same
    text and bbox IoU >= 0.5, and word accuracy at most MAX_ACC_DROP below
    the record's."""
    from tuatara_tpu_torch.utils.metrics import transcript_agreement, word_accuracy

    hit = sum(transcript_agreement(r, g)[0] for r, g in zip(ref["words"], got))
    total = sum(len(r) for r in ref["words"])
    acc = word_accuracy(got, truths)
    print(f"synthetic {label}: {hit}/{total} JAX words matched ({hit / total:.4f}); word "
          f"accuracy {acc:.4f} (JAX record {ref['word_acc']:.4f})", flush=True)
    if hit / total < min_agreement:
        fail(f"synthetic pages ({label}): transcript agreement {hit / total:.4f} < "
             f"{min_agreement}")
    if acc < ref["word_acc"] - MAX_ACC_DROP:
        fail(f"synthetic pages ({label}): word accuracy {acc:.4f} more than {MAX_ACC_DROP} "
             f"below the JAX record's {ref['word_acc']:.4f}")


def check_synthetic(weights, preset="latency", record=SYNTHETIC + ".json"):
    """Phase 6 (and 6c with preset "production"): the 16 synthetic pages
    through `OcrConfig.<preset>(canvas_size=256, max_boxes=32,
    rec_buckets=(32,))` against the JAX record."""
    import tuatara_tpu_torch

    pages, truths = synthetic_pages()
    with open(record) as f:
        ref = json.load(f)
    cfg = getattr(tuatara_tpu_torch.OcrConfig, preset)(canvas_size=256, max_boxes=32,
                                                       rec_buckets=(32,))
    got = [tuatara_tpu_torch.image_to_data(p, weights, config=cfg) for p in pages]
    synthetic_gate(preset, got, ref, truths)


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


def hull_edge_profiles():
    """[(label, dmin, dmax, dval)] numpy [H, K] profiles at the edges of H1's
    warps and rounds (a warp a chain, 4 chains a block, 32 rows a ballot,
    256 rows a round): K = 37 (not a multiple of 32 or 4) over H = 300 rows
    (a round and part of one) with nothing valid, one valid row (in the
    second round), one column of equal x (every middle point popped), a
    component whose valid rows are split by gaps across ballots and
    rounds, rows valid at random; H = 1; K = 1. Coordinates are integers,
    as the dilated profiles' are."""
    import numpy as np

    rng = np.random.default_rng(12)
    h, k = 300, 37
    x = np.zeros((h, k), np.float32)
    none = np.zeros((h, k), bool)
    one = none.copy()
    one[257] = True
    bands = none.copy()
    for lo, hi in ((10, 41), (100, 181), (250, 262), (290, 300)):
        bands[lo:hi] = True
    bands &= rng.random((h, k)) < 0.9
    x0 = rng.integers(0, 380, (h, k)).astype(np.float32)
    x1 = x0 + rng.integers(0, 40, (h, k)).astype(np.float32)
    return [("empty300x37", x, x, none), ("one_row300x37", x + 5, x + 9, one),
            ("column300x37", x + 7, x + 7, ~none), ("gaps300x37", x0, x1, bands),
            ("random300x37", x0, x1, rng.random((h, k)) < 0.3),
            ("h1x37", x[:1] + 3, x[:1] + 4, ~none[:1]),
            ("k1x300", x0[:, :1], x1[:, :1], rng.random((h, 1)) < 0.5)]


def hull_cases(engine, pages):
    """(label, dmin, dmax, dval) on the card for H1: the dilated profiles
    the rotated exact engine hands it on each page (captured by wrapping
    `minarearect.lower_chains` during a run), seeded random profiles at the
    main path's K = 256 (rows valid at random, x at random: many pops),
    and degenerate ones: nothing valid, one valid row, one column of equal
    x (every middle point popped), H = 1, K = 1, and convex chains of 194
    vertices, past the budget of 192; and `hull_edge_profiles`."""
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
    for edge in hull_edge_profiles():
        case(*edge)
    torch.cuda.synchronize()
    return cases


def check_hull(engine, pages, launches, max_records=1):
    """Phase 4f: H1 against its plain version on `hull_cases`, bit for bit
    (hx, hy and cnt) on the card and on the CPU, at most `max_records`
    traced records a call (None: not held); ms, device ms and
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
        cpu = hull.lower_chains_plain(dmin.cpu(), dmax.cpu(), dval.cpu())
        torch.cuda.synchronize()
        err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
        if not all(torch.equal(a, b) and torch.equal(a.cpu(), c) for a, b, c in
                   zip(got, ref, cpu)):
            fail(f"{hull.H1} differs from its plain version on {label} (max abs err {err}; the "
                 f"CPU's equal: {all(torch.equal(a.cpu(), c) for a, c in zip(got, cpu))})")
        kfn = lambda: hull.lower_chains(dmin, dmax, dval)  # noqa: E731
        ms = cuda_ms(kfn, 30)
        dev_ms, per_call = traced_per_call(kfn)
        if max_records is not None and per_call is not None and per_call > max_records:
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


def mode_engines():
    """Phase 3g's bf16 engines: latency() under beam and NAR, and the int8
    encoder (`production(encoder_impl="xla")`), dynamic and calibrated on
    two pages of the dense batch's kind (the four pages' first two)."""
    import tuatara_tpu_torch

    cfg = tuatara_tpu_torch.OcrConfig
    return {"latency_beam": cfg.latency(decode_mode="beam"),
            "latency_nar": cfg.latency(decode_mode="nar"),
            "production_xla": cfg.production(encoder_impl="xla")}


def check_modes_parity(pages, post):
    """Phase 3g, fp32 (TF32 off, as phase 5): each variant of
    tests/fixtures/torch_reference_modes.json (decode_mode "beam" and
    "nar"; quantized_serving=True, the int8 encoder, calibrated on the
    record's two pages) on the four pages and rotated_text, page by page
    with counts zeroed just before and read just after: at least
    MIN_WORD_SHARE of JAX's words with the same bbox and text under beam
    and NAR (the int8 engine's shares of words and bboxes are printed: its
    words are held on the 16 synthetic pages at fp32, dynamic and
    calibrated, against tests/fixtures/torch_synthetic_quantized_fp32.json);
    K1-K3 on every page, every int8 conv and int8 linear layer on every
    page of the int8 engine, K6 and K7 on none (fp32 takes the plain
    recognizer). -> {variant: summed launches}."""
    import torch

    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        with open(FIXTURE_MODES) as f:
            variants = json.load(f)["variants"]
        for variant, rec in variants.items():
            eng = tuatara_tpu_torch.OcrEngine(tuatara_tpu_torch.OcrConfig(**rec["config"]),
                                              weights_dir=WEIGHTS)
            required = dict.fromkeys(post, 1)
            if "calibration_pages" in rec:
                n = eng.calibrate([pages[p][None] for p in rec["calibration_pages"]])
                if n != rec["calibration_layers"]:
                    fail(f"modes fp32 {variant}: {n} layers calibrated, JAX "
                         f"{rec['calibration_layers']}")
                required.update(int8_conv=len(eng.craft.qconvs()),
                                int8_linear=len(eng.parseq.qlinears()))
            total = {}
            for name, img in pages.items():
                reset_launches()
                got = eng.run(img)
                launches = dict(LAUNCHES)
                for k, least in required.items():
                    if launches.get(k, 0) < least:
                        fail(f"modes fp32 {variant} {name}: kernel {k} launched "
                             f"{launches.get(k, 0)} times (at least {least})")
                for k in ("vit_blocks", "greedy_decode"):
                    if launches.get(k, 0):
                        fail(f"modes fp32 {variant} {name}: {k} launched at fp32")
                want = rec["pages"][name]["words"]
                share = word_share(want, got)
                boxes = word_share([{"text": "", "bbox": w["bbox"]} for w in want],
                                   [{"text": "", "bbox": w["bbox"]} for w in got])
                print(f"modes fp32 {variant} {name}: {share:.4f} of {len(want)} JAX words "
                      f"matched, {boxes:.4f} of their bboxes ({len(got)} port words); launches "
                      f"{json.dumps(launches)}", flush=True)
                # The int8 encoder turns the float layers' ulps into int8
                # steps, and these weights read real pages as near-ties:
                # its words are held on the synthetic pages below instead.
                if share < MIN_WORD_SHARE and "calibration_pages" not in rec:
                    fail(f"modes fp32 {variant} on {name}: {share:.4f} < {MIN_WORD_SHARE}")
                for k, n in launches.items():
                    total[k] = total.get(k, 0) + n
            out[variant] = total
            del eng
        check_synthetic_modes(WEIGHTS, ("quantized_fp32",))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def check_synthetic_modes(weights, names=("latency_beam", "latency_nar", "production_xla")):
    """Phase 3g: the 16 synthetic pages through latency() under beam and
    NAR and production(encoder_impl="xla") (bf16), or `names`, e.g.
    "quantized_fp32" (OcrConfig(quantized_serving=True) at fp32), the
    int8 encoders dynamic and calibrated on the first two pages, each with
    counts zeroed just before and read just after, against the JAX records
    tests/fixtures/torch_synthetic_<name>.json under phase 6's gates: K6
    on every page of beam and NAR and K7 on none; under the int8 encoder
    K6 on none, the int8 linear layers (and at bf16 K7) on every page."""
    import dataclasses

    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches

    pages, truths = synthetic_pages()
    n = len(pages)
    cfgs = {**mode_engines(), "quantized_fp32": tuatara_tpu_torch.OcrConfig(
        quantized_serving=True, compute_dtype="float32")}
    for name in names:
        cfg = cfgs[name]
        with open(SYNTHETIC_MODES.format(name)) as f:
            ref = json.load(f)
        cfg = dataclasses.replace(cfg, canvas_size=256, max_boxes=32, rec_buckets=(32,))
        eng = tuatara_tpu_torch.OcrEngine(cfg, weights_dir=weights)
        runs = [("", ref)]
        if "calibrated" in ref:
            runs.append(("calibrated", ref["calibrated"]))
        for tag, want in runs:
            if tag:
                eng.calibrate([p[None] for p in pages[:ref["calibration_pages"]]])
            reset_launches()
            got = [eng.run(p) for p in pages]
            launches = dict(LAUNCHES)
            label = f"{name}{'/' + tag if tag else ''}"
            print(f"synthetic {label} launches: {json.dumps(launches)}", flush=True)
            quantized = eng.parseq.quantized
            fused = cfg.compute_dtype == "bfloat16"
            least = ({"int8_linear": n * len(eng.parseq.qlinears())} if quantized
                     else {"vit_blocks": n})
            if quantized and fused:
                least["greedy_decode"] = n
            for k, m in least.items():
                if launches.get(k, 0) < m:
                    fail(f"synthetic {label}: {k} launched {launches.get(k, 0)} times "
                         f"(at least {m})")
            for k in (("vit_blocks",) if quantized else ("greedy_decode",)):
                if launches.get(k, 0):
                    fail(f"synthetic {label}: {k} launched {launches[k]} times")
            dynamic_int8 = quantized and fused and not tag
            synthetic_gate(label, got, want, truths,
                           MIN_AGREEMENT_DYNAMIC_INT8 if dynamic_int8 else MIN_AGREEMENT)
        del eng


def check_int8_linear(engine, img):
    """Phase 3g: the int8 encoder's products (`kernels/int8.int8_linear`,
    torch._int_mm) on real inputs, INT8_LINEARS of `engine` (the int8
    encoder, bf16) on a page's slab: int32 sums equal to the plain version
    (a float64 product on the card, exact) everywhere and to an int64
    product on the host at 256 sampled rows. Times: int8_linear, the whole
    layer (quantize, product, dequant), the plain version and a bf16
    cuBLAS product of the same shapes; the bound (bytes or int8 peak).
    -> the {"int8_linear": ...} summary."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tuatara_tpu_torch.kernels import int8

    layers = dict(engine.parseq.qlinears())
    seen = {}
    handles = [layers[n].register_forward_hook(
        lambda mod, args, out, n=n: seen.__setitem__(n, args[0])) for n in INT8_LINEARS]
    try:
        engine.run(img)
    finally:
        for hd in handles:
            hd.remove()
    rng = np.random.default_rng(11)
    rows = []
    for name in INT8_LINEARS:
        q, x = layers[name], seen[name]
        xq, _ = q.quantize_input(x)
        acc = int8.int8_linear(xq, q.wmat)
        ref = int8.int8_linear_plain(xq, q.wmat)
        if not torch.equal(acc, ref):
            fail(f"int8 linear {name}: int32 sums differ from the float64 product")
        flat = xq.reshape(-1, q.cin)
        picks = torch.from_numpy(rng.integers(0, flat.shape[0], 256)).cuda()
        want = flat[picks].cpu().long() @ q.wq.cpu().long()
        if not torch.equal(acc.reshape(-1, q.cout)[picks].cpu().long(), want):
            fail(f"int8 linear {name}: int32 sums differ from the int64 product on the host")
        m, k, n_out = flat.shape[0], q.cin, q.cout
        xb, wb = x.to(torch.bfloat16), q.wmat.to(torch.bfloat16)
        nbytes = m * k + n_out * k + m * n_out * 4
        bound = max(nbytes / HBM_BYTES_PER_S, 2 * m * n_out * k / INT8_OPS_PER_S) * 1e3
        rows.append({
            "layer": name, "m": m, "k": k, "n": n_out, "equal": True,
            "ms": cuda_ms(lambda: int8.int8_linear(xq, q.wmat), 20),
            "layer_ms": cuda_ms(lambda: q(x), 20),
            "plain_ms": cuda_ms(lambda: int8.int8_linear_plain(xq, q.wmat), 5),
            "bf16_cublas_ms": cuda_ms(lambda: F.linear(xb, wb), 20),
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= 2 * m * n_out * k / INT8_OPS_PER_S
            else "operations"})
        r = rows[-1]
        print(f"int8 linear {name:14s} [{m}, {k}] x [{k}, {n_out}] equal (float64 everywhere, "
              f"int64 at 256 rows); ms={r['ms']:.4f} layer_ms={r['layer_ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} bf16_cublas_ms={r['bf16_cublas_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    return {"route": "library", "library": "torch._int_mm (cuBLASLt)",
            "source": "tuatara_tpu_torch/kernels/int8.py",
            "replaces": "tuatara_tpu/models/layers.py:412 (XLA linear_q, not Pallas)",
            "per_layer": rows}


def beam_memory(engine, img, n):
    """The encoder memory of `n` crops of a page's slab (its live crops,
    repeated), under `engine`."""
    import torch

    with torch.inference_mode():
        images = torch.from_numpy(img[None]).cuda()
        det = engine.detect(images)
        crops, _ = engine._crop_slab(images, det["rects"], det["valid"],
                                     min(int(det["count"].sum()), n))
        reps = -(-n // crops.shape[0])
        return engine.parseq.encode(crops.repeat(reps, 1, 1, 1)[:n])


def check_beam(engine, img):
    """Phase 3g: the beam decode under latency(decode_mode="beam") issues
    its T steps with no host read (torch.cuda.set_sync_debug_mode
    ("error")), and gives a crop the same ids and score at BEAM_ROWS rows
    (crops x beams; the serving loop's equalities rest on it, as on the
    padded head). Prints the probe as part of the `invariance:` record."""
    import torch

    beams = engine.config.beam_size
    memory = beam_memory(engine, img, max(BEAM_ROWS) // beams)
    with torch.inference_mode():
        m8 = memory[:8].clone()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            engine.parseq.beam_decode(m8, beams)
        except RuntimeError as e:
            fail(f"beam decode reads the host: {str(e).splitlines()[0][:200]}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ref_ids, ref_scores = engine.parseq.beam_decode(m8, beams)
        bad = []
        for rows in BEAM_ROWS:
            ids, scores = engine.parseq.beam_decode(memory[:rows // beams], beams)
            if not (torch.equal(ids[:8], ref_ids) and torch.equal(scores[:8], ref_scores)):
                bad.append(rows)
        ms = cuda_ms(lambda: engine.parseq.beam_decode(memory[:256], beams), 3)
    print(f"beam: {engine.config.max_label_length + 1} steps with no host read; "
          f"invariance: beam decoder ({beams} beams, bf16) crops 0-7 differ from an 8-crop "
          f"call at row counts {bad} of {list(BEAM_ROWS)}; {ms:.3f} ms a 256-crop slab "
          f"(CUDA events)", flush=True)
    if bad:
        fail(f"the beam decoder depends on the row count: {bad}")


def dense_rates(engines, reps=2):
    """Warm pages/s of each engine's run_pages loop over the dense batches,
    in turns, and one traced loop each (device busy ms/page, idle share)."""
    import torch

    batches = dense_batches()
    n_pages = sum(len(b) for b in batches)
    acc = dict.fromkeys(engines, 0.0)
    for _ in range(reps):
        for name, engine in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                engine.run_pages(b)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
    for name, engine in engines.items():
        busy, wall = traced_busy(lambda: [engine.run_pages(b) for b in batches])
        print(f"dense warm, in turns: {name} {reps * n_pages / acc[name]:.3f} pages/s; traced "
              f"device busy {busy / n_pages:.3f} ms/page, wall {wall / n_pages:.3f} ms/page, "
              f"idle share {1 - busy / wall:.3f}", flush=True)


def check_cli(reference):
    """Phase 3g: `python -m tuatara_tpu_torch images/resume_example.png
    evals/production_weights --json-out ...` once on the card: exit 0, and
    at least MIN_WORD_SHARE of `reference`'s words (the default engine's in
    this process) with the same bbox and text."""
    path = os.path.join(ROOT, "build", "cli_resume_example.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tuatara_tpu_torch",
                           os.path.join(ROOT, "images", "resume_example.png"), WEIGHTS,
                           "--json-out", path], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        fail(f"cli: exit {proc.returncode}: {proc.stderr.strip()[-400:]}")
    with open(path) as f:
        got = json.load(f)
    share = word_share(reference, got)
    print(f"cli: exit 0 in {time.perf_counter() - t0:.1f} s, {len(got)} words, {share:.4f} of "
          f"the in-process default engine's {len(reference)} ({'equal' if got == reference else 'not equal'}); "
          f"{proc.stderr.strip().splitlines()[-1]}", flush=True)
    if share < MIN_WORD_SHARE:
        fail(f"cli: {share:.4f} of the in-process words < {MIN_WORD_SHARE}")


def check_modes(lat, pages, geo_pages, post, reference):
    """Phase 3g: beam and NAR decode, the int8 recognizer encoder, the
    command line; `lat` is the latency() engine timed beside them. -> the
    int8_linear summary."""
    import tuatara_tpu_torch

    t_phase = time.perf_counter()
    parity = check_modes_parity(geo_pages, post)
    get = tuatara_tpu_torch.api.get_engine
    cfgs = mode_engines()
    mode = {name: get(cfg, WEIGHTS) for name, cfg in cfgs.items()}
    cal = tuatara_tpu_torch.OcrEngine(cfgs["production_xla"], weights_dir=WEIGHTS)
    names = list(pages)[:2]
    print(f"production_xla calibrated: {cal.calibrate([pages[p][None] for p in names])} layers "
          f"on {names}", flush=True)
    mode["production_xla_calibrated"] = cal
    n_q, n_l = len(cal.craft.qconvs()), len(cal.parseq.qlinears())
    per_page = dict.fromkeys(post, 1)
    required = {"latency_beam": {**per_page, "vit_blocks": 1},
                "latency_nar": {**per_page, "vit_blocks": 1},
                "production_xla": {**per_page, "greedy_decode": 1, "int8_conv": n_q,
                                   "int8_linear": n_l}}
    launches = {}
    for name in cfgs:
        results, launches[name] = drive_each_page(cfgs[name], pages, required[name])
        absent = ("vit_blocks",) if name == "production_xla" else ("greedy_decode",)
        for k in absent:
            if launches[name].get(k, 0):
                fail(f"{name}: {k} launched {launches[name][k]} times")
        print(f"{name} launches on {len(pages)} pages: {json.dumps(launches[name])}", flush=True)
        for page, words in results.items():
            print(f"{name} {page}: {len(words)} boxes: " + " ".join(w["text"] for w in words[:8]),
                  flush=True)
    check_synthetic_modes(WEIGHTS)
    summary = check_int8_linear(cal, pages["resume_example"])
    summary["launches"] = launches["production_xla"].get("int8_linear", 0)
    check_beam(mode["latency_beam"], pages["resume_example"])
    per_batch = dict.fromkeys(post, K8_BATCH)
    check_serving({"latency_beam": mode["latency_beam"],
                   "production_xla_calibrated": cal}, pages,
                  {"latency_beam": {**per_batch, "vit_blocks": 1},
                   "production_xla_calibrated": {**per_batch, "greedy_decode": 1,
                                                 "int8_conv": n_q, "int8_linear": n_l}},
                  phase="3g")
    timed = {"latency": lat, **mode}
    warm_rates(timed, pages)
    dense_rates(timed)
    check_cli(reference)
    print(f"phase 3g {time.perf_counter() - t_phase:.1f} s; parity launches "
          f"{json.dumps(parity)}", flush=True)
    return summary



def large_page():
    """Four funsd_0001129658 pages tiled 2 x 2 into one 2000 x 1508 RGB page."""
    import numpy as np

    from tuatara_tpu_torch.utils.image import load_image

    img = load_image(os.path.join(ROOT, "images", f"{K8_BATCH_PAGE}.png"))
    return np.concatenate([np.concatenate([img, img], 1)] * 2, 0)


# ---------------------------------------------------------------------------
# 7. training on the card
# ---------------------------------------------------------------------------

TRAIN_RECORD = os.path.join(ROOT, "tests", "fixtures", "torch_train_fullwidth.npz")
TRAIN_WORDS = os.path.join(ROOT, "tests", "fixtures", "torch_train_words.npz")
TRAIN_DIR = os.path.join(ROOT, "build", "train")
# Leaves whose gradient is zero in exact arithmetic (a conv bias before a
# batch-statistics BatchNorm, an attention's key bias): rounding noise in
# both packages, so Adam's first step moves them either way; left out of
# the update comparison (tests/test_torch_train_step.py).
ZERO_GRAD = r"craft/(vgg/conv\d_\d/conv|up/upconv\d/conv\d|fc/fc\d)/b$|attn/k/b$"
TRAIN_METRICS = ("loss", "loss_craft", "loss_parseq", "craft_pos", "craft_n_pos", "parseq_ce")
# Bounds of the full-width parity (the record holds update norms, not the
# updates). fp32: the metrics of step 1 within 1e-5; step 2 starts from the
# port's own step 1, whose near-zero gradient elements took Adam's
# eps-dominated steps of other sizes than JAX's (test_torch_train_step.py),
# and moves by up to 2.8e-5 (H100 80GB HBM3, 700 W). Each model's update norm within
# 1e-3 at both steps (measured 2.6e-4); each leaf's within 1e-2 (measured
# 1.4e-3 at step 1, 5.4e-3 at step 2, BatchNorm leaves of 64-512
# elements, where a few eps-dominated elements weigh).
FP32_METRIC_RTOL = (1e-5, 1e-4)  # step 1, step 2
FP32_MODEL_UPDATE_RTOL = (1e-3, 1e-3)
FP32_UPDATE_RTOL = 1e-2
# bf16: the metrics within 2e-2 (measured 9.6e-3), each leaf's first
# update norm within 2e-2 (measured 9.1e-3), each model's update norm within
# 1e-2 at step 1 and 3e-2 at step 2 (measured 1.5e-2, CRAFT: the second
# update mixes two bf16 gradients whose small elements differ in sign).
BF16_METRIC_RTOL = (2e-2, 2e-2)
BF16_UPDATE_RTOL = 2e-2  # step 1, each leaf
BF16_MODEL_UPDATE_RTOL = (1e-2, 3e-2)  # each model's leaves together, step 1, step 2
OVERFIT_WORDS, OVERFIT_STEPS, OVERFIT_EVERY = 32, 400, 100
TIMED_STEPS = 10


# Phase 7's CRAFT gradient measure (ROADMAP Queue 3 item 19b): the bf16
# CRAFT loss's gradient before AdamW, from the production weights on the
# record's detection page, leaf by leaf against JAX's
# (`tests/gen_torch_train.py --part craft_grads`), as a relative L2 error
# estimated from a sketch (`grad_sketch`). Leaves with a gradient that is
# zero in exact arithmetic are left out (ZERO_GRAD). The gate bounds the
# worst leaf at 1.5x the worst of the builder's runs: 0.27018 for the
# shipped forms and 0.27105 over every form of
# `scripts/train_sites_torch_port.py` (vgg/conv4_2/bn/bias; two runs each,
# equal; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6, PR 21).
TRAIN_CRAFT_GRADS = os.path.join(ROOT, "tests", "fixtures", "torch_train_craft_grads.npz")
SKETCH_BUCKETS = 1024  # a leaf of more elements is held as this many signed bucket sums
SKETCH_PRIME = 2147483647
CRAFT_GRAD_MAX_REL = 0.41


def grad_sketch(g, path, buckets=SKETCH_BUCKETS):
    """A gradient leaf (any shape, JAX's layout; on the CPU or the card) ->
    its sketch, float64: the leaf itself, flattened, if it has at most
    `buckets` elements; else a count sketch of `buckets` signed sums, element
    i added with sign s(i) into bucket h(i), h and s two cubic polynomials
    of i modulo p = 2^31 - 1 (4-wise independent; the bucket their value
    modulo `buckets`, the sign its parity) whose coefficients come from the
    leaf's path (integer torch ops, the same on either device). The
    sketch is linear, and
    for a leaf x ||sketch(x)||^2 estimates ||x||^2 without bias, with a
    relative standard deviation of at most sqrt(2 / buckets) (4.4% at
    1024), so ||sketch(a) - sketch(b)|| / ||a|| estimates a relative L2
    error within ~2.2% (one standard deviation) of its value."""
    import zlib

    import torch

    x = g.reshape(-1).double()
    n = x.numel()
    if n <= buckets:
        return x
    seed = zlib.crc32(path.encode())
    coef = [(seed * (2 * k + 1) * 40503 + 12345 * k) % (SKETCH_PRIME - 1) + 1 for k in range(8)]
    i = torch.arange(n, dtype=torch.int64, device=x.device)

    def poly(c):
        h = torch.full_like(i, c[0])
        for a in c[1:]:
            h = (h * i + a) % SKETCH_PRIME  # h < 2^31, i < 2^25: no int64 overflow
        return h

    bucket = poly(coef[:4]) % buckets
    sign = 1 - 2 * (poly(coef[4:]) % 2)
    return torch.zeros(buckets, dtype=torch.float64, device=x.device).index_add_(
        0, bucket, x * sign.double())


def craft_grad_errors(grads, rec, buckets=SKETCH_BUCKETS):
    """{leaf: port gradient (JAX layout)} and the record of
    `gen_torch_train.py --part craft_grads` (sketched with `buckets`) ->
    {leaf: estimated relative L2 error of the port's gradient against
    JAX's}, over the record's leaves."""
    import numpy as np
    import torch

    out = {}
    for key in rec:
        if not key.startswith("sketch/"):
            continue
        leaf = key[len("sketch/"):]
        want = torch.from_numpy(np.asarray(rec[key], np.float64))
        got = grad_sketch(grads[leaf], leaf, buckets).cpu()
        out[leaf] = float((got - want).norm()) / float(rec[f"norm/{leaf}"])
    return out


def check_craft_grads(rec, grads_rec, gate=True):
    """Phase 7, the CRAFT gradient measure: `TrainableCraft` from the
    production weights on the card, its bf16 CRAFT loss's gradient on the
    page of `rec` (TRAIN_RECORD), each leaf's estimated relative L2 error
    against JAX's (`grads_rec`, TRAIN_CRAFT_GRADS; `craft_grad_errors`).
    Prints the median, the worst and the worst leaf; fatal above
    CRAFT_GRAD_MAX_REL when `gate`. -> (summary, {leaf: error})."""
    import numpy as np
    import torch

    from tuatara_tpu_torch.models.craft import TrainableCraft
    from tuatara_tpu_torch.train.losses import craft_loss
    from tuatara_tpu_torch.utils import weights as W
    from tuatara_tpu_torch.weights import load_tree, module_leaves, to_jax

    craft_cfg = W.load_configs(WEIGHTS)[0]
    model = load_tree(TrainableCraft(craft_cfg), W.load_weights_dir(WEIGHTS)[0]).cuda()
    pages = torch.from_numpy(np.asarray(rec["pages"])).cuda()
    heat = torch.from_numpy(np.asarray(rec["heat"])).cuda()
    loss, _ = craft_loss(model, pages, heat, compute_dtype=torch.bfloat16)
    loss.backward()
    grads = {p: torch.from_numpy(np.ascontiguousarray(to_jax(t.grad, layout)))
             for p, t, layout in module_leaves(model) if t.grad is not None}
    errs = craft_grad_errors(grads, grads_rec)
    v = np.array(list(errs.values()))
    worst = max(errs, key=errs.get)
    summary = {"leaves": len(errs), "median": float(np.median(v)), "mean": float(v.mean()),
               "worst": errs[worst], "worst_leaf": worst, "bound": CRAFT_GRAD_MAX_REL}
    print(f"train parity bf16 CRAFT gradient before AdamW against JAX's record "
          f"(estimated relative L2 error a leaf, {len(errs)} leaves): median "
          f"{summary['median']:.4e}, mean {summary['mean']:.4e}, worst {errs[worst]:.4e} "
          f"({worst}); bound {CRAFT_GRAD_MAX_REL}", flush=True)
    if gate and errs[worst] > CRAFT_GRAD_MAX_REL:
        fail(f"CRAFT gradient at bf16: {worst} {errs[worst]:.4e} from JAX's "
             f"(> {CRAFT_GRAD_MAX_REL})")
    return summary, errs


def train_batch(rec, device):
    import numpy as np
    import torch

    crops = np.float32(rec["crops_u8"]) / np.float32(255.0)
    return {"pages": torch.from_numpy(rec["pages"]).to(device),
            "heat": torch.from_numpy(rec["heat"]).to(device),
            "crops": torch.from_numpy(crops).to(device),
            "labels": torch.from_numpy(rec["labels"]).to(device),
            "lengths": torch.from_numpy(rec["lengths"]).to(device)}


def production_state(tx=None):
    from tuatara_tpu_torch.train.trainer import init_train_state
    from tuatara_tpu_torch.utils import weights as W

    craft_cfg, parseq_cfg, _ = W.load_configs(WEIGHTS)
    return init_train_state(craft_cfg=craft_cfg, parseq_cfg=parseq_cfg, tx=tx,
                            params=W.load_weights_dir(WEIGHTS))


def leaf_tensors(state):
    """{JAX path: tensor} of both models, running statistics included."""
    from tuatara_tpu_torch.weights import module_leaves

    return {f"{m}/{p}": t for m, model in (("craft", state.craft), ("parseq", state.parseq))
            for p, t, _ in module_leaves(model)}


def check_train_parity(rec, dtype, tag):
    """Two joint steps from the production weights on the record's batch
    with JAX's permutations, held to JAX's record at `tag`. -> (the state
    after them, the values out of bounds)."""
    import re

    import torch

    from tuatara_tpu_torch.train.trainer import train_step

    state, tx = production_state()
    batch = train_batch(rec, "cuda")
    perms = torch.from_numpy(rec["perms"]).long().cuda()
    zero = re.compile(ZERO_GRAD)
    worst = []  # (metrics, leaf update norm, model update norm) a step
    bad = []
    for i in (1, 2):
        worst_m, worst_u, worst_model = 0.0, (0.0, ""), 0.0
        before = {k: t.detach().clone() for k, t in leaf_tensors(state).items()}
        state, m = train_step(state, batch, tx, perms=perms, compute_dtype=dtype)
        for k in TRAIN_METRICS:
            want = float(rec[f"{tag}/m{i}/{k}"])
            rel = abs(float(m[k]) / want - 1)
            worst_m = max(worst_m, rel)
            if rel > (FP32_METRIC_RTOL if tag == "fp32" else BF16_METRIC_RTOL)[i - 1]:
                bad.append(f"step {i} {k} {float(m[k])!r} vs JAX {want!r}")
        with torch.no_grad():
            after = leaf_tensors(state)
            norms = {k: float((after[k].double() - before[k].double()).norm()) for k in after}
        totals = {}
        for k, n in norms.items():
            if zero.search(k):
                continue
            want = float(rec[f"{tag}/dnorm{i}/{k}"])
            model = k.split("/")[0]
            got_sq, want_sq = totals.get(model, (0.0, 0.0))
            totals[model] = (got_sq + n * n, want_sq + want * want)
            # bf16's second step is held per model (below); the running
            # means after the second step absorb the conv biases' first
            # steps, which are left out (ZERO_GRAD).
            if (tag == "bf16" and i == 2) or (i == 2 and k.endswith("/mean")) or want == 0:
                continue
            rel = abs(n - want) / want
            if rel > worst_u[0]:
                worst_u = (rel, k)
            if rel > (FP32_UPDATE_RTOL if tag == "fp32" else BF16_UPDATE_RTOL):
                bad.append(f"step {i} update of {k}: norm {n:.6e} vs JAX {want:.6e}")
        for model, (g, w) in totals.items():
            rel = abs((g / w) ** 0.5 - 1)
            worst_model = max(worst_model, rel)
            if rel > (FP32_MODEL_UPDATE_RTOL if tag == "fp32" else BF16_MODEL_UPDATE_RTOL)[i - 1]:
                bad.append(f"step {i} update norm of {model}: {g ** 0.5:.6e} vs JAX "
                           f"{w ** 0.5:.6e}")
        bn = state.craft.vgg["conv1_1"]["bn"]
        for name in ("mean", "var") if i == 1 else ("var",):
            want = torch.from_numpy(rec[f"{tag}/bn{i}/{name}"]).cuda()
            err = float((getattr(bn, name) - want).norm() / want.norm())
            if err > (FP32_METRIC_RTOL if tag == "fp32" else BF16_METRIC_RTOL)[i - 1]:
                bad.append(f"step {i} vgg/conv1_1/bn/{name}: relative L2 error {err:.3e}")
        worst.append(f"step {i}: metrics {worst_m:.3e}, leaf update norms {worst_u[0]:.3e} "
                     f"({worst_u[1] or 'not held per leaf'}), model update norms "
                     f"{worst_model:.3e}")
    print(f"train parity {tag} (worst relative gaps to JAX's record): {'; '.join(worst)}; "
          f"loss {float(m['loss'])!r} (JAX {float(rec[f'{tag}/m2/loss'])!r})", flush=True)
    for b in bad:
        print(f"train parity {tag}: OUT OF BOUNDS: {b}", flush=True)
    return state, bad


def resume_child(ckpt_dir) -> int:
    """Child process of phase 7's resume check (deterministic algorithms):
    two straight bf16 steps against save after step 1 -> load into a fresh
    state -> step 2; every leaf, moment and metric must be equal."""
    import numpy as np
    import torch

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    sys.path.insert(0, ROOT)
    from tuatara_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from tuatara_tpu_torch.train.trainer import init_train_state, train_step

    with np.load(TRAIN_RECORD) as z:
        rec = {k: z[k] for k in z.files}
    batch = train_batch(rec, "cuda")
    perms = torch.from_numpy(rec["perms"]).long().cuda()
    a, tx = production_state()
    a, _ = train_step(a, batch, tx, perms=perms)
    save_checkpoint(ckpt_dir, a, craft_config=a.craft.cfg, parseq_config=a.parseq.cfg)
    a, ma = train_step(a, batch, tx, perms=perms)
    template, _ = init_train_state(torch.Generator().manual_seed(7), a.craft.cfg,
                                   a.parseq.cfg, tx=tx)
    b = load_checkpoint(ckpt_dir, template)
    b, mb = train_step(b, batch, tx, perms=perms)
    ta, tb = leaf_tensors(a), leaf_tensors(b)
    diff = [k for k in ta if not torch.equal(ta[k], tb[k])]
    diff += [f"mu/{k}" for k in a.opt_state.mu if not torch.equal(a.opt_state.mu[k],
                                                                  b.opt_state.mu[k])]
    diff += [f"nu/{k}" for k in a.opt_state.nu if not torch.equal(a.opt_state.nu[k],
                                                                  b.opt_state.nu[k])]
    diff += [k for k in ma if not torch.equal(ma[k], mb[k])]
    print(f"resume: {len(ta)} leaves, {2 * len(a.opt_state.mu)} moments, {len(ma)} metrics "
          f"compared; {len(diff)} differ {diff[:5]}", flush=True)
    return 1 if diff else 0


def check_resume():
    t0 = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--train-resume",
                          os.path.join(TRAIN_DIR, "resume")], env=env, capture_output=True,
                         text=True, timeout=600)
    sys.stdout.write(out.stdout)
    if out.returncode != 0:
        sys.stdout.write(out.stderr[-4000:])
        fail(f"resume on the card: the child exited {out.returncode}")
    print(f"resume: save after step 1, load, step 2 == two straight steps, bit for bit "
          f"(deterministic algorithms, {time.perf_counter() - t0:.1f} s)", flush=True)


def pool_words():
    import numpy as np

    with np.load(TRAIN_WORDS) as z:
        return {k: z[k] for k in z.files}


def check_overfit():
    """fit_recognizer at full width from scratch on a fixed batch of the
    committed uint8 pool, augmented on the card (data_iter), k_perms 6,
    grad_clip 1.0, weight_decay 0.01, a warmup schedule."""
    import numpy as np

    from tuatara_tpu_torch.tokenizer import Tokenizer
    from tuatara_tpu_torch.train.run import evaluate_recognizer, fit_recognizer
    from tuatara_tpu_torch.utils import weights as W

    _, parseq_cfg, _ = W.load_configs(WEIGHTS)
    pool = pool_words()
    tok = Tokenizer()
    n = OVERFIT_WORDS
    fixed = {"crops": pool["crops_u8"][:n], "labels": pool["labels"][:n],
             "lengths": pool["lengths"][:n]}
    texts = [tok.ids_to_text(ids[1:]) for ids in fixed["labels"]]

    def batches():
        while True:
            yield fixed

    progress = []

    def probe(step, model, opt_state):
        acc, _ = evaluate_recognizer(model, {"crops": fixed["crops"], "texts": texts}, tok)
        progress.append((step, acc))

    t0 = time.perf_counter()
    model, losses = fit_recognizer(
        steps=OVERFIT_STEPS, batch_size=n, lr=lambda c: 1e-3 * min(1.0, (c + 1) / 100),
        cfg=parseq_cfg, tokenizer=tok, k_perms=6, seed=0, log_every=OVERFIT_EVERY,
        grad_clip=1.0, weight_decay=0.01, ckpt_every=OVERFIT_EVERY, ckpt_fn=probe,
        data_iter=batches())
    acc, got = evaluate_recognizer(model, {"crops": fixed["crops"], "texts": texts}, tok)
    seconds = time.perf_counter() - t0
    first_ok = next((s for (s, a), l in zip(progress, losses[1:])
                     if a >= 0.5 and l < 0.2 * losses[0]), None)
    print(f"overfit: fit_recognizer at full width from scratch, {n} words, {OVERFIT_STEPS} "
          f"steps in {seconds:.1f} s: losses {[round(v, 4) for v in losses]}, accuracy by step "
          f"{progress}; gate first met at step {first_ok}; last {acc:.3f}; e.g. "
          f"{list(zip(texts[:6], got[:6]))}", flush=True)
    if not losses[-1] < 0.2 * losses[0]:
        fail(f"overfit: last loss {losses[-1]:.4f} not below 0.2 x the first {losses[0]:.4f}")
    if acc < 0.5:
        fail(f"overfit: accuracy {acc:.3f} < 0.5 on the batch")
    return model


def check_detector_learns():
    from tuatara_tpu_torch.train.run import fit_detector
    from tuatara_tpu_torch.utils import weights as W

    craft_cfg, _, _ = W.load_configs(WEIGHTS)
    t0 = time.perf_counter()
    _, losses = fit_detector(steps=40, batch_size=8, cfg=craft_cfg, page_size=256,
                             words_per_page=8, log_every=5)
    print(f"detector: fit_detector at full width from scratch, 8 pages of 256x256, 40 steps in "
          f"{time.perf_counter() - t0:.1f} s: losses {[round(v, 4) for v in losses]}", flush=True)
    if not losses[-1] < losses[0]:
        fail(f"detector: loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")


def timed(make_step, n=TIMED_STEPS):
    """A training step's rates: `make_step()` builds the model, optimizer
    and batch and returns the step. -> (ms a step over n steps after 3 warm
    ones; device busy ms a step and kernels a step from a torch.profiler
    trace of 3 more, and their idle share; peak memory in GiB above what was allocated before
    `make_step`, so the phases' resident engines are not counted). Also
    the idle share of the traced steps' wall."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from profile_torch_port import busy_us

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step = make_step()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    path = os.path.join(TRAIN_DIR, "step_trace.json")
    os.makedirs(TRAIN_DIR, exist_ok=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / 3
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = sum(e.get("cat") == "kernel" for e in events) / 3
    busy = busy_us(events) / 3e3
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = e.get("name", "?")[:48]
            by_name[name] = by_name.get(name, 0.0) + e.get("dur", 0.0) / 3e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return ms, busy, max(0.0, 1 - busy / traced_ms), kernels, peak, top


def train_rates(card):
    """ms a step, samples/s, device busy and peak memory of the three steps
    at full width, bf16, each in a fresh state."""
    import numpy as np
    import torch

    from tuatara_tpu_torch.models.craft import init_craft
    from tuatara_tpu_torch.models.parseq import init_parseq
    from tuatara_tpu_torch.train.run import detector_step, recognizer_step, to_device
    from tuatara_tpu_torch.train.trainer import AdamW, init_train_state, trainable_params, train_step
    from tuatara_tpu_torch.utils import weights as W
    from tuatara_tpu_torch.utils.data import detection_batch

    craft_cfg, parseq_cfg, _ = W.load_configs(WEIGHTS)
    dev = torch.device("cuda")
    pool = pool_words()
    det = detection_batch(8, np.random.default_rng(0), size=256, words_per_page=8)
    gen = torch.Generator(device=dev).manual_seed(1)

    def crops_batch():
        return (to_device(pool["crops_u8"], dev), to_device(pool["labels"], dev),
                to_device(pool["lengths"], dev))

    def recognizer():
        parseq = init_parseq(parseq_cfg, torch.Generator().manual_seed(0)).to(dev)
        tx = AdamW(lr=1e-4, weight_decay=0.01, clip_norm=1.0)
        params = trainable_params(parseq=parseq)
        st = tx.init(params)
        crops, labels, lengths = crops_batch()
        return lambda: recognizer_step(parseq, tx, params, st, crops, labels, lengths, gen, 6)

    def detector():
        craft = init_craft(craft_cfg, torch.Generator().manual_seed(0)).to(dev)
        tx = AdamW(lr=2e-3)
        params = trainable_params(craft=craft)
        st = tx.init(params)
        pages, heat = to_device(det["pages"], dev), to_device(det["heat"], dev)
        return lambda: detector_step(craft, tx, params, st, pages, heat)

    def joint():
        state, tx = init_train_state(craft_cfg=craft_cfg, parseq_cfg=parseq_cfg)
        crops, labels, lengths = crops_batch()
        batch = {"pages": to_device(det["pages"], dev), "heat": to_device(det["heat"], dev),
                 "crops": (crops.float() / 255.0)[..., None].expand(-1, -1, -1, 3).contiguous(),
                 "labels": labels, "lengths": lengths}
        return lambda: train_step(state, batch, tx, generator=gen)

    out = {}
    for name, make, n in (("fit_recognizer", recognizer, 256), ("fit_detector", detector, 8),
                          ("train_step", joint, 8 + 256)):
        ms, busy, idle, kernels, peak, top = timed(make)
        out[name] = {"ms": ms, "samples_per_s": n * 1e3 / ms, "device_busy_ms": busy,
                     "idle_share": idle, "kernels": kernels, "peak_gib": peak}
        print(f"train rate {name}: {ms:.2f} ms a step, {n * 1e3 / ms:.1f} samples/s ({n} a "
              f"step), device busy {busy:.2f} ms a step and idle share {idle:.3f} (traced), "
              f"{kernels:.0f} kernels a step, peak memory {peak:.2f} GiB, bf16; card {card}; "
              f"device ms a step by kernel: "
              + "; ".join(f"{k} {v:.2f}" for k, v in top), flush=True)
    return out


def words_equal(got, want):
    return ([(w["text"], w["bbox"]) for w in got] == [(w["text"], w["bbox"]) for w in want]
            and all(abs(a["confidence"] - b["confidence"]) <= 1e-6 for a, b in zip(got, want)))


def check_checkpoint_serving(pages, results, lat_results, trained, post):
    """The step-0 checkpoint of the production weights: arrays bit-equal,
    the same words under the default config and latency(); the trained
    checkpoint under latency() on one page launches K1-K3, K6 and K7."""
    import numpy as np

    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.train.checkpoint import save_checkpoint
    from tuatara_tpu_torch.utils import weights as W

    craft_cfg, parseq_cfg, charset = W.load_configs(WEIGHTS)
    step0 = os.path.join(TRAIN_DIR, "step0")
    state, _ = production_state()
    save_checkpoint(step0, state, craft_config=craft_cfg, parseq_config=parseq_cfg,
                    charset=charset)
    del state
    for name in (W.CRAFT_FILE, W.PARSEQ_FILE):
        with np.load(os.path.join(WEIGHTS, name)) as want, np.load(os.path.join(step0, name)) as got:
            if sorted(got.files) != sorted(want.files):
                fail(f"step-0 checkpoint {name}: other keys")
            for k in want.files:
                if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k]):
                    fail(f"step-0 checkpoint {name}: {k} differs")
    for label, config, ref in (("default", tuatara_tpu_torch.OcrConfig(), results),
                               ("latency", tuatara_tpu_torch.OcrConfig.latency(), lat_results)):
        eng = tuatara_tpu_torch.OcrEngine(config, weights_dir=step0)
        for page, img in pages.items():
            if not words_equal(eng.run(img), ref[page]):
                fail(f"step-0 checkpoint under {label}: {page} differs from the production "
                     f"weights' words")
        eng.close()
    print(f"checkpoint: step-0 arrays bit-equal to {os.path.relpath(WEIGHTS, ROOT)}; the same "
          f"words on {len(pages)} pages under the default config and latency()", flush=True)

    ckpt = os.path.join(TRAIN_DIR, "trained")
    save_checkpoint(ckpt, trained, craft_config=craft_cfg, parseq_config=parseq_cfg,
                    charset=charset)
    eng = tuatara_tpu_torch.OcrEngine(tuatara_tpu_torch.OcrConfig.latency(), weights_dir=ckpt)
    page = "resume_example"
    eng.run(pages[page])  # warm: builds nothing new, counts start below
    reset_launches()
    got = eng.run(pages[page])
    launches = dict(LAUNCHES)
    eng.close()
    for name in post + ("vit_blocks", "greedy_decode"):
        if launches.get(name, 0) < 1:
            fail(f"trained checkpoint under latency(): kernel {name} was not launched")
    if not any(w["text"] for w in got):
        fail("trained checkpoint under latency(): no boxes with text")
    print(f"checkpoint: the trained state (phase 7's 2 bf16 steps on a bar page) served under "
          f"latency() on {page}: {len(got)} boxes ({len(lat_results[page])} with the "
          f"production weights), launches {json.dumps(launches)}; "
          + " ".join(w["text"] for w in got[:10]), flush=True)


def check_training(pages, results, lat_results, post, card):
    """Phase 7 (see the module docstring)."""
    import numpy as np
    import torch

    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.kernels import bias_act as BA

    t_phase = time.perf_counter()
    with np.load(TRAIN_RECORD) as z:
        rec = {k: z[k] for k in z.files}
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    _, bad32 = check_train_parity(rec, torch.float32, "fp32")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    gelu_calls = []
    saved_grad = BA.gelu_grad

    def record(g, v):
        gelu_calls.append((g.clone(), v.clone()))
        return saved_grad(g, v)

    BA.gelu_grad = record
    reset_launches()
    try:
        trained, bad16 = check_train_parity(rec, torch.bfloat16, "bf16")
    finally:
        BA.gelu_grad = saved_grad
    launches = {k: LAUNCHES.get(k, 0) for k in (BA.BA, BA.GG)}
    print(f"train parity bf16: launches in the two joint steps {json.dumps(launches)}",
          flush=True)
    if not all(launches.values()):
        fail(f"bias_act or gelu_grad did not run in the bf16 training steps: {launches}")
    gelu_entry = check_gelu_grad(gelu_calls, launches[BA.GG])
    with np.load(TRAIN_CRAFT_GRADS) as z:
        grads, _ = check_craft_grads(rec, {k: z[k] for k in z.files})
    check_resume()
    check_checkpoint_serving(pages, results, lat_results, trained, post)
    del trained
    check_overfit()
    check_detector_learns()
    rates = train_rates(card)
    if bad32 or bad16:  # after the other checks, so one run shows them all
        fail(f"train parity: {len(bad32)} fp32 and {len(bad16)} bf16 values out of bounds")
    print(f"training: phase 7 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {**rates, "craft_grads_bf16": grads}, gelu_entry


# fit_recognizer's GELU backward calls: 256 crops of 128 tokens, fc1 1536
# wide (`train_rates`).
GELU_GRAD_FIT_SHAPE = (256, 128, 1536)
# fp32 operations an element of the GELU gradient in JAX's form (7 products,
# 1 difference; its roundings and table reads not counted), at the card's
# fp32 rate outside the tensor cores.
GELU_GRAD_OPS = 8
FP32_OPS_PER_S = 67e12


def bit_patterns(dtype):
    """All 65,536 values of a 16-bit dtype on the card, in bit order (NaN
    and Inf included)."""
    import torch

    return torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32, device="cuda").to(
        torch.int16).view(dtype)


def finite_values(dtype):
    """Every finite value of a 16-bit dtype on the card (`bit_patterns`
    without NaN and Inf), as rows of 256."""
    import torch

    v = bit_patterns(dtype)
    return v[torch.isfinite(v)].view(-1, 256)


def gelu_grad_draws(n, seed=0):
    """{name: fp32 numpy [n]}: four seeded draws of the GELU gradient's g:
    at fc1's scale (N(0, 0.01)), unit scale, tiny values near 2^-126
    (denormal in bf16 below it) and magnitudes from 2^-40 to 2^10, each of
    either sign."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sign = rng.choice([-1.0, 1.0], n)
    return {"fc1": rng.normal(0, 0.01, n).astype(np.float32),
            "unit": rng.normal(0, 1, n).astype(np.float32),
            "tiny": (sign * 2.0 ** -126 * rng.uniform(0.25, 4, n)).astype(np.float32),
            "mixed": (sign * 2.0 ** rng.uniform(-40, 10, n)).astype(np.float32)}


def check_gelu_grad(calls, launches, exhaustive=True):
    """Phase 7, the GELU backward kernel (`gelu_grad`, csrc/bias_act.cu) on
    every call of the bf16 training steps (fc1's output gradient and
    pre-activation value), on all 65,536 bit patterns of v in bf16 and
    fp16 under the four draws of `gelu_grad_draws`, and at fit_recognizer's
    shape on seeded values at fc1's scale (the bit patterns skipped without
    `exhaustive`): bit-equal to its plain version (`gelu_plain_grad`)
    everywhere, timed beside it (events, and device time
    a call from one trace of the calls), beside `aten.gelu_backward` (the
    exact derivative with other roundings, not the same function), its byte
    bound (g and v read, the gradient written) and its operation bound
    (`GELU_GRAD_OPS`). -> the kernels line's entry."""
    import torch

    from tuatara_tpu_torch.kernels import bias_act as BA

    def check(g, v, what):
        got, want = BA.gelu_grad(g, v), BA.gelu_plain_grad(g, v)
        if not same_bits(got, want):
            bad = int((got.view(torch.int16) != want.view(torch.int16)).sum())
            fail(f"gelu_grad differs from its plain version on {what}: {bad} of {g.numel()} "
                 f"elements")

    def bounds(numel):
        return {"bytes": 3 * numel * 2 / HBM_BYTES_PER_S * 1e3,
                "operations": GELU_GRAD_OPS * numel / FP32_OPS_PER_S * 1e3}

    rows = []
    for g, v in calls:
        check(g, v, f"a training call {tuple(g.shape)}")
        rows.append({"ms": cuda_ms(lambda: BA.gelu_grad(g, v), 20),
                     "plain_ms": cuda_ms(lambda: BA.gelu_plain_grad(g, v), 20),
                     "aten_ms": cuda_ms(lambda: torch.ops.aten.gelu_backward(g, v), 20),
                     **{f"{k}_bound_ms": b for k, b in bounds(g.numel()).items()}})
    n = len(rows)
    mean = {k: sum(r[k] for r in rows) / n for k in rows[0]}
    shapes = sorted({tuple(g.shape) for g, _ in calls})
    dev = traced_device_ms(lambda: [BA.gelu_grad(g, v) for g, v in calls],
                           os.path.join(ROOT, "build", "gelu_grad_trace.json"), n)
    dev = None if dev is None else dev / n
    bound_by = max(("bytes", "operations"), key=lambda k: mean[f"{k}_bound_ms"])
    print(f"kernel gelu_grad: {n} calls of the bf16 training steps bit-equal to the plain "
          f"version, shapes {shapes}: ms={mean['ms']:.5f} device_ms={dev} "
          f"plain_ms={mean['plain_ms']:.4f} "
          f"aten_gelu_backward_ms={mean['aten_ms']:.4f} "
          f"bound_ms bytes={mean['bytes_bound_ms']:.6f} "
          f"operations={mean['operations_bound_ms']:.6f} (means a call)", flush=True)

    cases = 0
    for dtype in (torch.bfloat16, torch.float16) if exhaustive else ():
        v = bit_patterns(dtype)
        for name, draw in gelu_grad_draws(v.numel()).items():
            check(torch.from_numpy(draw).to("cuda").to(dtype), v,
                  f"every {dtype} bit pattern of v, g {name}")
            cases += 1
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = GELU_GRAD_FIT_SHAPE
    v = (torch.randn(shape, device="cuda", generator=gen) * 0.7).to(torch.bfloat16)
    g = (torch.randn(shape, device="cuda", generator=gen) * 0.01).to(torch.bfloat16)
    check(g, v, f"fit_recognizer's {list(shape)}")
    fit = {"shape": list(shape), "ms": cuda_ms(lambda: BA.gelu_grad(g, v), 20),
           "plain_ms": cuda_ms(lambda: BA.gelu_plain_grad(g, v), 3),
           "aten_gelu_backward_ms": cuda_ms(lambda: torch.ops.aten.gelu_backward(g, v), 20)}
    fit_dev = traced_device_ms(lambda: [BA.gelu_grad(g, v) for _ in range(5)],
                               os.path.join(ROOT, "build", "gelu_grad_fit_trace.json"), 5)
    fit["device_ms"] = None if fit_dev is None else fit_dev / 5
    fit.update({f"{k}_bound_ms": b for k, b in bounds(g.numel()).items()})
    fit["bound_by"] = max(("bytes", "operations"), key=lambda k: fit[f"{k}_bound_ms"])
    if fit["device_ms"]:
        fit["share_of_bound"] = fit[f"{fit['bound_by']}_bound_ms"] / fit["device_ms"]
    del g, v
    print(f"kernel gelu_grad: every bit pattern of v in bf16 and fp16 ({cases} draws of g) "
          f"bit-equal to the plain version; fit_recognizer {json.dumps(fit)}", flush=True)
    return {
        "name": BA.GG, "route": "cuda", "source": "tuatara_tpu_torch/csrc/bias_act.cu",
        "replaces": "tuatara_tpu/models/layers.py:444 (the derivative of jax.nn.gelu in the "
                    "bf16 training step, XLA ops: no TPU kernel)",
        "launches": launches, "equal": True, "max_abs_err": 0.0, "cases": n,
        "exhaustive_cases": cases, "ms": mean["ms"], "device_ms": dev,
        "plain_ms": mean["plain_ms"], "bound_ms": mean[f"{bound_by}_bound_ms"],
        "bound_by": bound_by, "byte_bound_ms": mean["bytes_bound_ms"],
        "operation_bound_ms": mean["operations_bound_ms"],
        # aten.gelu_backward rounds otherwise: not the same function.
        "library_ms": None, "aten_gelu_backward_ms": mean["aten_ms"],
        "shapes": [list(x) for x in shapes], "fit_recognizer": fit,
        "timed_on": "mean a call over the bf16 training steps' calls (phase 7)",
    }


# ---------------------------------------------------------------------------
# Phase 8: conversion, mesh, profiling, native
# ---------------------------------------------------------------------------

CONVERT_DIR = os.path.join(ROOT, "build", "convert")
MESH_DIR = os.path.join(ROOT, "build", "mesh")
MESH_WORLD = 2  # ranks sharing the one card over gloo
MESH_TIMEOUT = 600
# The sharded joint step's metrics against the single step at fp32, the
# bound of tests/test_torch_parallel_train.py (JAX's own mesh test holds
# its sharded loss to rtol 2e-4).
MESH_TRAIN_RTOL = 2e-4
MESH_TIMED_STEPS = 5
STAGES = ("tuatara_detect", "tuatara_recognize", "tuatara_fetch", "tuatara_decode")


def check_conversion(pages, lat_results, post):
    """8a: the production weights through upstream-named replicas, traced,
    converted on the card with the probe; leaves bit-equal; served under
    latency() with the default path's kernels. -> convert seconds."""
    import shutil

    import numpy as np

    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.utils import convert as C
    from tuatara_tpu_torch.utils import weights as W

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_surrogates import Normalized, save_traced, upstream_replicas

    shutil.rmtree(CONVERT_DIR, ignore_errors=True)
    craft_cfg, parseq_cfg, _ = W.load_configs(WEIGHTS)
    t0 = time.perf_counter()
    craft, parseq = upstream_replicas(*W.load_weights_dir(WEIGHTS), craft_cfg, parseq_cfg)
    ref = os.path.join(CONVERT_DIR, "reference")
    save_traced(ref, craft, parseq)
    t_trace = time.perf_counter() - t0
    out = os.path.join(CONVERT_DIR, "converted")
    t0 = time.perf_counter()
    verdicts = C.convert_torchscript_weights(ref, out, craft_cfg, parseq_cfg)
    t_convert = time.perf_counter() - t0
    if verdicts != {"craft": "identity", "parseq": "identity"}:
        fail(f"conversion: probe verdicts {verdicts}, want identity for both")
    n_leaves = 0
    for name in (W.CRAFT_FILE, W.PARSEQ_FILE):
        with np.load(os.path.join(WEIGHTS, name)) as want, np.load(os.path.join(out, name)) as got:
            if sorted(got.files) != sorted(want.files):
                fail(f"conversion {name}: other keys")
            for k in want.files:
                if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k]):
                    fail(f"conversion {name}: {k} differs from the production weights")
            n_leaves += len(want.files)
    # Normalizing replicas: CRAFT behind ImageNet's statistics in the
    # engine's variant (a ReLU before the fc stage, ROADMAP Queue 3 item
    # 16), PARSEQ behind 2x-1: both found and baked. Upstream's CRAFT
    # behind ImageNet's statistics: "unknown" (the engine cannot reproduce
    # it within the probe's tolerance).
    trees = W.load_weights_dir(WEIGHTS)
    engine_craft = upstream_replicas(*trees, craft_cfg, parseq_cfg, relu_before_fc=True)[0]
    ref_n = os.path.join(CONVERT_DIR, "reference_normalized")
    save_traced(ref_n, Normalized(engine_craft, C.IMAGENET_MEAN, C.IMAGENET_STD).eval(),
                Normalized(parseq, (0.5,) * 3, (0.5,) * 3).eval())
    v_n = C.convert_torchscript_weights(ref_n, os.path.join(CONVERT_DIR, "normalized"),
                                        craft_cfg, parseq_cfg)
    if v_n != {"craft": "imagenet", "parseq": "pm1"}:
        fail(f"conversion: normalized replicas gave {v_n}, want imagenet and pm1")
    baked = W.load_configs(os.path.join(CONVERT_DIR, "normalized"))
    if tuple(baked[0].input_mean) != C.IMAGENET_MEAN or tuple(baked[1].input_std) != (0.5,) * 3:
        fail("conversion: the detected transforms were not baked into config.json")
    upstream = Normalized(craft, C.IMAGENET_MEAN, C.IMAGENET_STD).eval()
    v_up = C.probe_input_normalization(upstream, trees[0], "craft", craft_cfg)
    if v_up != "unknown":
        fail(f"conversion: upstream CRAFT behind ImageNet's statistics gave {v_up!r}, want "
             f"'unknown' (the engine's CRAFT pools after a ReLU)")
    print(f"conversion: full width traced in {t_trace:.1f} s (CPU), converted with the probe "
          f"on the card in {t_convert:.1f} s; verdicts {verdicts}, {v_n} (normalizing "
          f"replicas, baked), {v_up} (upstream CRAFT normalizing); {n_leaves} leaves "
          f"bit-equal to {os.path.relpath(WEIGHTS, ROOT)}", flush=True)

    eng = tuatara_tpu_torch.OcrEngine(tuatara_tpu_torch.OcrConfig.latency(), weights_dir=out)
    reset_launches()
    got = {n: eng.run(img) for n, img in pages.items()}
    launches = dict(LAUNCHES)
    eng.close()
    need = {**dict.fromkeys(post, len(pages)), "vit_blocks": 1, "greedy_decode": 1}
    for name, least in need.items():
        if launches.get(name, 0) < least:
            fail(f"converted weights under latency(): kernel {name} launched "
                 f"{launches.get(name, 0)} times (at least {least})")
    for page in pages:
        if not words_equal(got[page], lat_results[page]):
            fail(f"converted weights under latency(): {page} differs from the production "
                 f"weights' words")
    print(f"conversion: served under latency(): the production weights' words and bboxes on "
          f"{len(pages)} pages ({sum(len(v) for v in got.values())} words); launches "
          f"{json.dumps(launches)}", flush=True)
    shutil.rmtree(CONVERT_DIR, ignore_errors=True)
    return t_convert


def spawn_ranks(kind, world=MESH_WORLD, env=None):
    """Run `chip_smoke.py --mesh-child kind rank world dir` for every rank
    (gloo over a file rendezvous, all on the card) -> their JSON results."""
    import shutil

    workdir = os.path.join(MESH_DIR, kind)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-child", kind,
                               str(r), str(world), workdir], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        sys.stdout.write("".join(f"  [{kind} rank {r}] {line}\n" for line in o.splitlines()[-12:]))
        if p.returncode != 0:
            fail(f"mesh {kind}: rank {r} exited {p.returncode}")
    res = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def mesh_serve_child(rank, world, workdir):
    """8b's rank: latency() and calibrated production() on a dp mesh over
    the ranks, the dense batch at 16 and 15 pages; launch counts of each
    call."""
    import torch.distributed as dist

    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.parallel import init_distributed, make_mesh
    from tuatara_tpu_torch.utils.image import load_image

    init_distributed(rank, world, f"file://{workdir}/rendezvous", backend="gloo")
    mesh = make_mesh(device="cuda:0")
    pages = {n: load_image(os.path.join(ROOT, "images", f"{n}.png")) for n in PAGES[:2]}
    dense = dense_batches()[0]
    cfg = tuatara_tpu_torch.OcrConfig
    lat = tuatara_tpu_torch.OcrEngine(cfg.latency(), weights_dir=WEIGHTS, mesh=mesh)
    prod = tuatara_tpu_torch.OcrEngine(cfg.production(), weights_dir=WEIGHTS, mesh=mesh)
    n_cal = prod.calibrate([img[None] for img in pages.values()])
    out = {"calibrated": n_cal, "scales": [float(q.sx) for _, q in prod.craft.qconvs()],
           "n_int8": len(prod.craft.qconvs())}
    for name, eng in (("latency", lat), ("production_calibrated", prod)):
        for b in (16, 15):
            eng.run_pages(dense[:b])  # the bucket speculated, as in serving
            reset_launches()
            t0 = time.perf_counter()
            res = eng.run_pages(dense[:b])
            out[f"{name}/{b}"] = {"results": res, "launches": dict(LAUNCHES),
                                  "ms": (time.perf_counter() - t0) * 1e3}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: done", flush=True)
    return 0


def check_mesh_serving(lat, calibrated, post):
    """8b: both dp ranks equal to the single engines, with K1-K3, K6 and K7
    (and every int8 conv) launched on each; NCCL at world size 1."""
    import socket

    import torch
    import torch.distributed as dist

    import tuatara_tpu_torch
    from tuatara_tpu_torch.parallel import init_distributed, make_mesh

    t0 = time.perf_counter()
    ranks = spawn_ranks("serve")
    dense = dense_batches()[0]
    want_scales = [float(q.sx) for _, q in calibrated.craft.qconvs()]
    n_q = len(want_scales)
    for r, res in enumerate(ranks):
        if res["scales"] != want_scales:
            fail(f"mesh serving: rank {r}'s calibrated scales differ from the single engine's")
    for name, single in (("latency", lat), ("production_calibrated", calibrated)):
        for b in (16, 15):
            want = single.run_pages(dense[:b])
            if not sum(len(p) for p in want):
                fail("mesh serving: the single engine found no words")
            need = {**dict.fromkeys(post, -(-b // MESH_WORLD)), "vit_blocks": 1,
                    "greedy_decode": 1}
            if name != "latency":
                need["int8_conv"] = n_q
            for r, res in enumerate(ranks):
                got = res[f"{name}/{b}"]
                if len(got["results"]) != b or not all(
                        words_equal(g, w) for g, w in zip(got["results"], want)):
                    fail(f"mesh serving {name} b={b}: rank {r}'s results differ from the "
                         f"single engine's")
                for k, least in need.items():
                    if got["launches"].get(k, 0) < least:
                        fail(f"mesh serving {name} b={b}: rank {r} launched {k} "
                             f"{got['launches'].get(k, 0)} times (at least {least})")
            print(f"mesh serving {name}, dense batch of {b} (dp={MESH_WORLD}, "
                  f"{-(-b // MESH_WORLD)} pages a rank): both ranks equal the single engine "
                  f"({sum(len(p) for p in want)} words); rank 0 launches "
                  f"{json.dumps(ranks[0][f'{name}/{b}']['launches'])}; warm ms a call "
                  f"{[round(res[f'{name}/{b}']['ms'], 1) for res in ranks]}", flush=True)

    # NCCL at world size 1: a collective on the card, and the mesh engine
    # equal to the plain one.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_distributed(0, 1, f"tcp://localhost:{port}", backend="nccl")
    try:
        x = torch.arange(4.0, device="cuda")
        dist.all_reduce(x)
        if not torch.equal(x, torch.arange(4.0, device="cuda")):
            fail("NCCL all_reduce at world size 1 changed its input")
        mesh = make_mesh()
        eng = tuatara_tpu_torch.OcrEngine(tuatara_tpu_torch.OcrConfig.latency(),
                                          weights_dir=WEIGHTS, mesh=mesh)
        got, want = eng.run_pages(dense[:15]), lat.run_pages(dense[:15])
        if not all(words_equal(g, w) for g, w in zip(got, want)) or len(got) != 15:
            fail("NCCL mesh engine (world size 1) differs from the plain engine")
        eng.close()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    print(f"mesh serving: {backend} at world size 1: all_reduce on the card, mesh engine == "
          f"plain on 15 pages; 8b {time.perf_counter() - t0:.1f} s", flush=True)


def mesh_train_child(rank, world, workdir):
    """8c's rank: the joint step at full width, fp32, TF32 off,
    deterministic algorithms, at dp=2 (the record's page and its mirror)
    and tp=2 (the record's batch), against the single step (rank 0); a
    sharded save at dp=2 loaded onto dp=2, tp=2 and one device; ms a step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tuatara_tpu_torch.parallel import init_distributed, make_mesh
    from tuatara_tpu_torch.train.checkpoint import (load_checkpoint_sharded,
                                                    save_checkpoint_sharded)
    from tuatara_tpu_torch.train.trainer import (full_flat, init_train_state, moments_from_jax,
                                                 param_layouts, shard_batch, shard_train_state,
                                                 train_step)
    from tuatara_tpu_torch.utils import weights as W

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(rank, world, f"file://{workdir}/rendezvous", backend="gloo")
    mesh_dp = make_mesh(device="cuda:0")
    mesh_tp = make_mesh(axes=("dp", "tp"), shape=(1, world), device="cuda:0")
    with np.load(TRAIN_RECORD) as z:
        rec = {k: z[k] for k in z.files}
    batch_tp = train_batch(rec, "cuda")
    batch_dp = {k: v for k, v in batch_tp.items()}
    batch_dp["pages"] = torch.cat([batch_tp["pages"], batch_tp["pages"].flip(2)])
    batch_dp["heat"] = torch.cat([batch_tp["heat"], batch_tp["heat"].flip(2)])
    perms = torch.from_numpy(rec["perms"]).long().cuda()
    f32 = torch.float32

    def step(state, tx, batch):
        b = batch if state.mesh is None else shard_batch(state.mesh, batch)
        _, m = train_step(state, b, tx, perms=perms, compute_dtype=f32)
        return {k: float(v) for k, v in m.items()}

    def state_on(mesh, trees=None, moments=None):
        if trees is None:
            st, tx = production_state()
        else:
            st, tx = init_train_state(craft_cfg=trees[2], parseq_cfg=trees[3],
                                      params=trees[:2])
            st.opt_state = moments_from_jax(moments, st.params(),
                                            param_layouts(craft=st.craft, parseq=st.parseq))
            st.step = 1
        if mesh is not None:
            shard_train_state(mesh, st, tx)
        return st, tx

    out = {}
    for name, mesh, batch in (("dp", mesh_dp, batch_dp), ("tp", mesh_tp, batch_tp)):
        st, tx = state_on(mesh)
        out[name] = [step(st, tx, batch) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_TIMED_STEPS):
            step(st, tx, batch)
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / MESH_TIMED_STEPS
        if name == "tp":
            q = st.parseq.enc[0].attn.q.weight
            out["tp_shard"] = [list(q.shape), list(st.opt_state.mu["parseq/enc/0/attn/q/w"].shape)]
        del st
    if rank == 0:  # the single step on the same batches, alone on the card
        for name, batch in (("dp", batch_dp), ("tp", batch_tp)):
            st, tx = state_on(None)
            out[f"single_{name}"] = [step(st, tx, batch) for _ in range(2)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MESH_TIMED_STEPS):
                step(st, tx, batch)
            torch.cuda.synchronize()
            out[f"single_{name}_ms"] = (time.perf_counter() - t0) * 1e3 / MESH_TIMED_STEPS
            del st
    dist.barrier()

    # A sharded checkpoint saved at dp=2 after one step.
    ckpt = os.path.join(workdir, "ckpt")
    a, tx = state_on(mesh_dp)
    step(a, tx, batch_dp)
    flat1 = full_flat(a)
    save_checkpoint_sharded(ckpt, a)
    step(a, tx, batch_dp)
    straight2 = full_flat(a)
    del a

    def split(flat):
        """A full flat state -> (CRAFT tree, PARSEQ tree, their configs), moments."""
        def tree(prefix):
            return W.unflatten_tree({k[len(prefix):]: v for k, v in flat.items()
                                     if k.startswith(prefix)})

        craft_cfg, parseq_cfg, _ = W.load_configs(WEIGHTS)
        return ((tree("craft/"), tree("parseq/"), craft_cfg, parseq_cfg),
                {k: v for k, v in flat.items() if k.startswith(("mu/", "nu/")) or k == "count"})

    trees, moments = split(flat1)
    ck = {}
    for name, mesh, batch in (("dp", mesh_dp, batch_dp), ("tp", mesh_tp, batch_tp),
                              ("single", None, batch_tp)):
        b, tx = state_on(mesh)
        load_checkpoint_sharded(ckpt, b)
        loaded = full_flat(b)
        diff_loaded = [k for k in flat1 if not np.array_equal(loaded[k], flat1[k])]
        step(b, tx, batch)
        resumed = full_flat(b)
        del b
        d, tx = state_on(mesh, trees, moments)
        step(d, tx, batch)
        direct = full_flat(d)
        del d
        diff = [k for k in direct if not np.array_equal(resumed[k], direct[k])]
        if name == "dp":
            diff += [f"straight:{k}" for k in straight2
                     if not np.array_equal(resumed[k], straight2[k])]
        ck[name] = {"leaves": len(flat1), "loaded_differ": diff_loaded[:5],
                    "n_loaded_differ": len(diff_loaded), "resumed_differ": diff[:5],
                    "n_resumed_differ": len(diff)}
    out["ckpt"] = ck
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: done", flush=True)
    return 0


def check_mesh_training(card):
    """8c: the sharded joint step against the single step; the sharded
    checkpoint across layouts; ms a step."""
    import numpy as np

    t0 = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    ranks = spawn_ranks("train", env=env)
    single = ranks[0]
    with np.load(TRAIN_RECORD) as z:
        jax_m = {i: {k: float(z[f"fp32/m{i}/{k}"]) for k in TRAIN_METRICS} for i in (1, 2)}
    for name in ("dp", "tp"):
        worst, worst_jax = 0.0, 0.0
        for r, res in enumerate(ranks):
            for i in range(2):
                for k in TRAIN_METRICS:
                    got, want = res[name][i][k], single[f"single_{name}"][i][k]
                    rel = abs(got - want) / max(abs(want), 1e-30)
                    worst = max(worst, rel)
                    if rel > MESH_TRAIN_RTOL or (k == "craft_n_pos" and got != want):
                        fail(f"mesh training {name}: rank {r} step {i + 1} {k} {got!r} vs the "
                             f"single step's {want!r}")
                    if name == "tp":
                        worst_jax = max(worst_jax, abs(got / jax_m[i + 1][k] - 1))
        print(f"mesh training {name}=2 (fp32, TF32 off, full width): both ranks' metrics of "
              f"2 steps within {worst:.2e} of the single step (bound {MESH_TRAIN_RTOL})"
              + (f", within {worst_jax:.2e} of JAX's record" if name == "tp" else
                 " (the record's page and its mirror, one a rank)")
              + f"; ms a step {[round(r_[f'{name}_ms'], 1) for r_ in ranks]} on ranks "
              f"sharing the card, single step {single[f'single_{name}_ms']:.1f} ms; "
              f"card {card}", flush=True)
    for r, res in enumerate(ranks):
        q, mu = res["tp_shard"]
        if q != [192, 384] or mu != [192, 384]:
            fail(f"mesh training tp: rank {r} holds q {q} and its moment {mu} (want half of "
                 f"384 output rows)")
        for target, c in res["ckpt"].items():
            if c["n_loaded_differ"] or c["n_resumed_differ"]:
                fail(f"sharded checkpoint onto {target}: rank {r}: {c}")
    print(f"mesh training: sharded checkpoint saved at dp=2 after one step, loaded onto dp=2, "
          f"tp=2 and one device: {ranks[0]['ckpt']['dp']['leaves']} leaves and moments "
          f"bit-equal, and the next step bit-equal to the direct one (dp=2: to the straight "
          f"run); 8c {time.perf_counter() - t0:.1f} s", flush=True)
    return {k: ranks[0][k] for k in ("dp_ms", "tp_ms", "single_dp_ms", "single_tp_ms")}


def check_profiling(lat, pages):
    """8d: a profiling.trace of one latency() page holds the four stage
    names and K6's and K7's kernels."""
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.utils import profiling

    log = os.path.join(MESH_DIR, "trace")
    reset_launches()
    with profiling.trace(log):
        lat.run(pages["resume_example"])
    with open(os.path.join(log, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    missing = [s for s in STAGES if s not in names]
    k6 = sum("gemm_kernel" in k or "attention" in k for k in kernels
             if "(anonymous namespace)::" in k)
    k7 = sum("decode_kernel" in k for k in kernels)
    if missing or not k6 or not k7:
        fail(f"profiling trace: stages missing {missing}, K6 kernels {k6}, K7 kernels {k7}")
    print(f"profiling: trace of one latency() page: {len(events)} events, the four stages, "
          f"{len(kernels)} kernels (K6 {k6}, K7 {k7}; launches {dict(LAUNCHES)})", flush=True)


def check_native(lat, pages):
    """8e: the card's heatmaps of the four pages through the native host
    library, beside K1-K3's boxes: equal counts."""
    from tuatara_tpu_torch import native
    from tuatara_tpu_torch.api import content_mask
    from tuatara_tpu_torch.ops.boxes import extract_boxes

    cfg = lat.config
    rows = []
    for name, img in pages.items():
        det = lat.detect(lat._to_device(img[None]))
        scores = det["scores"][0]
        content = content_mask(img.shape[0], img.shape[1], cfg, scores.device)
        h, w = int(content.any(1).sum()), int(content.any(0).sum())
        port = extract_boxes(scores[:, :, 0], scores[:, :, 1], content, cfg)
        want = sorted(tuple(int(v) for v in b) for b in port["boxes"][port["valid"]].tolist())
        hm = scores[:h, :w].float().cpu().numpy()
        t0 = time.perf_counter()
        boxes, _, _ = native.extract_boxes(hm[..., 0], hm[..., 1], cfg.text_threshold,
                                           cfg.link_threshold, cfg.low_text,
                                           cfg.min_component_area, cfg.niter_mode,
                                           max_boxes=cfg.max_boxes)
        ms = (time.perf_counter() - t0) * 1e3
        got = sorted(tuple(int(v) for v in b) for b in boxes)
        same = len(set(got) & set(want))
        rows.append(f"{name} {len(got)}/{len(want)} ({same} equal, {ms:.1f} ms host)")
        if len(got) != len(want) or int(det["count"][0]) != len(want):
            fail(f"native boxes on {name}: {len(got)} host boxes, {len(want)} from K1-K3")
    print("native: host boxes / K1-K3 boxes on the card's heatmaps: " + "; ".join(rows),
          flush=True)


def check_phase8(pages, lat, lat_results, calibrated, post, card):
    """Phase 8 (see the module docstring). -> its summary."""
    t_phase = time.perf_counter()
    t_convert = check_conversion(pages, lat_results, post)
    check_mesh_serving(lat, calibrated, post)
    rates = check_mesh_training(card)
    check_profiling(lat, pages)
    check_native(lat, pages)
    secs = time.perf_counter() - t_phase
    print(f"phase 8: {secs:.1f} s", flush=True)
    return {"convert_s": t_convert, "train_ms": rates, "seconds": secs}


# ---------------------------------------------------------------------------
# Phase 9: engines with no weights, the C ABI, the compiled binding, the
# example programs
# ---------------------------------------------------------------------------

RANDOM_DIR = os.path.join(ROOT, "build", "random_weights")
RANDOM_SEED = 0
EXAMPLE_TIMEOUT = 300


def random_configs():
    """Phase 9a's engines: {name: (OcrConfig, ParseqConfig or None)}."""
    from tuatara_tpu_torch.config import OcrConfig, ParseqConfig
    from tuatara_tpu_torch.tokenizer import EXTENDED_CHARSET

    return {"default": (OcrConfig(), None), "latency": (OcrConfig.latency(), None),
            "production": (OcrConfig.production(), None),
            "extended_charset": (OcrConfig(charset=EXTENDED_CHARSET),
                                 ParseqConfig(charset_size=95))}


def check_random_engines(pages, post):
    """9a: `OcrEngine(cfg, seed=RANDOM_SEED)` with no weights for each of
    `random_configs`: its state dict bit-equal to the same engine's drawn
    for the CPU; page by page, counts zeroed just before and read just
    after, K1-K3 on every page, K6 and K7 on every page with a box under
    the fused presets (and at least one such page), every int8 conv on
    every page under production(); each page's results equal to an engine
    loaded from the same draws saved with `save_weights_dir`. -> {name:
    boxes a page}."""
    import shutil

    import torch

    import tuatara_tpu_torch
    from tuatara_tpu_torch.api import random_trees
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.utils.weights import save_weights_dir

    summary = {}
    for name, (cfg, parseq_cfg) in random_configs().items():
        t0 = time.perf_counter()
        eng = tuatara_tpu_torch.OcrEngine(cfg, parseq_config=parseq_cfg, seed=RANDOM_SEED)
        t_draw = time.perf_counter() - t0
        cpu = tuatara_tpu_torch.OcrEngine(cfg, parseq_config=parseq_cfg, seed=RANDOM_SEED,
                                          device="cpu")
        for part in ("craft", "parseq"):
            got, want = getattr(eng, part).state_dict(), getattr(cpu, part).state_dict()
            if got.keys() != want.keys() or not all(torch.equal(got[k].cpu(), want[k])
                                                    for k in want):
                fail(f"random {name}: the {part} weights differ from the CPU's draw")
        del cpu
        wdir = os.path.join(RANDOM_DIR, name)
        save_weights_dir(wdir, *random_trees(eng.craft_config, eng.parseq_config, RANDOM_SEED),
                         eng.craft_config, eng.parseq_config, charset=cfg.charset)
        loaded = tuatara_tpu_torch.OcrEngine(cfg, weights_dir=wdir)
        shutil.rmtree(wdir)  # loaded: 171 MB less on the disk
        fused = cfg.encoder_impl == "pallas"
        n_q = len(eng.craft.qconvs()) if eng.craft.quantized else 0
        boxes, total = {}, {}
        for page, img in pages.items():
            reset_launches()
            words = eng.run(img)
            launches = dict(LAUNCHES)
            for kernel, n in launches.items():
                total[kernel] = total.get(kernel, 0) + n
            required = {**dict.fromkeys(post, 1), "int8_conv": n_q}
            if fused and words:
                required.update(vit_blocks=1, greedy_decode=1)
            for kernel, least in required.items():
                if launches.get(kernel, 0) < least:
                    fail(f"random {name} {page}: kernel {kernel} launched "
                         f"{launches.get(kernel, 0)} times (at least {least})")
            if loaded.run(img) != words:
                fail(f"random {name} {page}: differs from the engine loaded from its weights")
            boxes[page] = len(words)
        if fused and not any(boxes.values()):
            fail(f"random {name}: no page gave a box, so K6 and K7 were not held")
        summary[name] = boxes
        print(f"random {name} (seed {RANDOM_SEED}): boxes a page {json.dumps(boxes)}; "
              f"launches on the {len(pages)} pages {json.dumps(total)}; weights equal to the "
              f"CPU's draw; results equal to the saved weights' engine; engine "
              f"{t_draw:.1f} s, all {time.perf_counter() - t0:.1f} s", flush=True)
    return summary


def expect_raises(exc, text, fn, *args):
    try:
        fn(*args)
    except exc as e:
        if text not in str(e):
            fail(f"binding: {exc.__name__} without {text!r}: {e}")
        return
    except Exception as e:  # noqa: BLE001 - any other type breaks the contract
        fail(f"binding: expected {exc.__name__}, got {type(e).__name__}: {e}")
    fail(f"binding: expected {exc.__name__} ({text!r}), nothing raised")


def check_binding(pages):
    """9c: `tuatara_tpu_torch.pytuatara.image_to_data` (the compiled
    `_pytuatara_torch`) equal to the engine's {text, bbox} on the pages;
    the compiled module raises the reference binding's contract."""
    import numpy as np

    import tuatara_tpu_torch
    from tuatara_tpu_torch import capi, pytuatara

    for name, img in pages.items():
        got = pytuatara.image_to_data(img, WEIGHTS, "outputs")
        want = [{"text": w["text"], "bbox": w["bbox"]}
                for w in tuatara_tpu_torch.image_to_data(img, WEIGHTS)]
        if got != want:
            fail(f"binding {name}: {len(got)} items differ from the engine's {len(want)}")
    fn, img = capi.load_pyext().image_to_data, np.zeros((4, 4, 3), np.uint8)
    expect_raises(ValueError, "weights_dir", fn, img, "", "o")
    expect_raises(ValueError, "outputs_dir", fn, img, "w", "")
    expect_raises(ValueError, "3 dimensions", fn, np.zeros((4, 4), np.uint8), "w", "o")
    expect_raises(TypeError, "uint8", fn, np.zeros((4, 4, 3), np.float32), "w", "o")
    expect_raises(FileNotFoundError, "does not exist", fn, img, "/nonexistent_weights_dir", "o")
    expect_raises(TypeError, "", fn, [[1, 2], [3, 4]], "w", "o")
    print(f"binding: _pytuatara_torch equal to the engine on {len(pages)} pages; the validation "
          f"contract holds", flush=True)


def example_page():
    """The page `capi_example.c` builds: white, 96 x 120 x 3, two dark bars."""
    import numpy as np

    page = np.full((96, 120, 3), 255, np.uint8)
    page[20:30, 10:60] = 10
    page[50:58, 30:90] = 10
    return page


def example_lines(words):
    """The lines `capi_example.c` prints for these records (values cast to
    float32 as the C ABI stores them)."""
    import numpy as np

    lines = [f"{len(words)} items"]
    for w in words:
        x0, y0, x1, y1 = (float(np.float32(v)) for v in w["bbox"])
        lines.append("  text=%-12s bbox=[%.0f %.0f %.0f %.0f] conf=%.3g"
                     % (w["text"], x0, y0, x1, y1, float(np.float32(w["confidence"]))))
    return lines


def example_command(name, *args):
    return [sys.executable, "-m", f"tuatara_tpu_torch.examples.{name}", *args]


def printed_records(out):
    """The records an example prints, one dict a line, before its count."""
    import ast

    return [ast.literal_eval(line) for line in out.strip().splitlines()[:-1]]


def check_capi_and_examples(pages, post):
    """9b and 9d: the C ABI in process (ctypes) on the pages equal to
    `image_to_data` (text, bbox and confidence after the same float32 cast,
    K1-K3 launched by each call) and on a gray page equal to the engine; the
    port's C example, a process with no Python host, printing the
    in-process call's lines; the same binary without a card exiting nonzero
    with "no CUDA device"; the examples resume and table on the production
    weights with at least MIN_WORD_SHARE of the engine's words, then serve
    on the dense page, alone. -> {build_s, serve line}."""
    import shutil

    import numpy as np

    import tuatara_tpu_torch
    from tuatara_tpu_torch import capi
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    example = capi.build_example()
    capi.build_pyext()
    build_s = time.perf_counter() - t0
    print(f"capi build (library, example, binding): {build_s:.1f} s", flush=True)

    def stored(words):
        return [{"text": w["text"], "bbox": [float(np.float32(v)) for v in w["bbox"]],
                 "confidence": float(np.float32(w["confidence"]))} for w in words]

    engine = tuatara_tpu_torch.api.get_engine(weights_dir=WEIGHTS)
    gray = pages["funsd_0001129658"][..., 0].copy()
    total = {}
    for name, img in [*pages.items(), ("gray funsd_0001129658", gray)]:
        reset_launches()
        got = capi.image_to_data(img, WEIGHTS)
        launches = dict(LAUNCHES)
        for kernel, n in launches.items():
            total[kernel] = total.get(kernel, 0) + n
        want = engine.run(img)
        if got != stored(want):
            fail(f"capi {name}: {len(got)} items differ from image_to_data's {len(want)}")
        for kernel in post:
            if launches.get(kernel, 0) < 1:
                fail(f"capi {name}: kernel {kernel} was not launched")
    print(f"capi: ctypes in process equal to image_to_data on {len(pages)} pages and a gray "
          f"page, K1-K3 launched on each; launches {json.dumps(total)}", flush=True)

    # Processes of their own, side by side: the C example with and without
    # a card, and the resume and table examples.
    table_dir = os.path.join(ROOT, "build", "table_example")
    shutil.rmtree(table_dir, ignore_errors=True)
    os.makedirs(table_dir)
    os.symlink(WEIGHTS, os.path.join(table_dir, "weights"))
    jobs = {
        "capi_example": ([example, WEIGHTS], capi.embedded_env(), ROOT),
        "capi_example_no_card": ([example, WEIGHTS],
                                 {**capi.embedded_env(), "CUDA_VISIBLE_DEVICES": ""}, ROOT),
        "resume": (example_command("resume", os.path.join(ROOT, "images", "resume_example.png"),
                                   WEIGHTS), None, ROOT),
        "table": (example_command("table", os.path.join(ROOT, "images", "table_english.png")),
                  capi.embedded_env(), table_dir),
    }
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, (cmd, env, cwd) in jobs.items()}
    outs = {}
    try:
        for k, p in procs.items():
            outs[k] = p.communicate(timeout=EXAMPLE_TIMEOUT)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"processes: {', '.join(procs)} side by side in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for k, p in procs.items():
        if (p.returncode == 0) == (k == "capi_example_no_card"):
            fail(f"{k}: exit {p.returncode}: {outs[k][1].strip()[-600:]}")
    want = example_lines(capi.image_to_data(example_page(), WEIGHTS))
    if outs["capi_example"][0].splitlines() != want:
        fail(f"capi_example printed {outs['capi_example'][0]!r}, in process {want!r}")
    print("capi_example (no Python host): exit 0, the in-process call's lines: "
          + " | ".join(want), flush=True)
    if "no CUDA device" not in outs["capi_example_no_card"][1]:
        fail(f"capi_example without a card: {outs['capi_example_no_card'][1].strip()[-300:]}")
    print(f"capi_example without a card: exit {procs['capi_example_no_card'].returncode}, "
          f"{outs['capi_example_no_card'][1].strip().splitlines()[-1]}", flush=True)
    for k, page in (("resume", "resume_example"), ("table", "table_english")):
        got = printed_records(outs[k][0])
        ref = engine.run(pages[page])
        share = word_share(ref, got)
        print(f"example {k}: exit 0, {len(got)} words, {share:.4f} of the in-process engine's "
              f"{len(ref)}", flush=True)
        if share < MIN_WORD_SHARE:
            fail(f"example {k}: {share:.4f} of the engine's words < {MIN_WORD_SHARE}")

    cmd = example_command("serve", os.path.join(ROOT, "images", "funsd_0001129658.png"),
                          "--weights", WEIGHTS, "--batch", "16", "--batches", "2")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT)
    if proc.returncode != 0:
        fail(f"example serve: exit {proc.returncode}: {proc.stderr.strip()[-600:]}")
    rate = next((line for line in proc.stdout.splitlines() if line.startswith("run_stream")), "")
    print(f"example serve (alone): exit 0 in {time.perf_counter() - t0:.1f} s, {rate}",
          flush=True)
    return {"build_s": build_s, "serve": rate}


def check_phase9(pages, post):
    """Phase 9 (see the module docstring). -> its summary."""
    t_phase = time.perf_counter()
    boxes = check_random_engines(pages, post)
    native = check_capi_and_examples(pages, post)
    check_binding(pages)
    secs = time.perf_counter() - t_phase
    print(f"phase 9: {secs:.1f} s", flush=True)
    return {"random_boxes": boxes, **native, "seconds": secs}


def bias_act_calls(engine, pages):
    """Every `bias_act` call of the engine on the pages, recorded while it
    runs: CRAFT's (dim 1) all, with copies of their inputs; PARSEQ's
    (dim -1) the first of each (width, act, bias or not). -> (those, the
    fp32-output mode's calls (`bias_add_f32`: y, bias, residual), the
    first of each (y's shape past its rows, the residual's shape), the
    first page's all apart; the first page's GELU calls (fc1), all)."""
    import torch

    from tuatara_tpu_torch.models import layers

    calls, f32_calls, f32_first, gelu_first, seen = [], [], [], [], set()
    saved, saved_f32 = layers.bias_act, layers.bias_add_f32

    def record(p, bias, act, keep_pre=False, dim=1):
        key = (p.shape[-1], act, bias is None)
        call = (p.clone(), None if bias is None else bias.clone(), act, keep_pre, dim)
        if dim == 1 or key not in seen:
            seen.add(key)
            calls.append(call)
        if first_page and act == "gelu":
            gelu_first.append(call)
        return saved(p, bias, act, keep_pre, dim)

    def record_f32(y, bias, residual=None):
        key = (tuple(y.shape[1:]), None if residual is None else tuple(residual.shape))
        call = (y.clone(), None if bias is None else bias.clone(),
                None if residual is None else residual.clone())
        if key not in seen:
            seen.add(key)
            f32_calls.append(call)
        if first_page:
            f32_first.append(call)
        return saved_f32(y, bias, residual)

    layers.bias_act, layers.bias_add_f32 = record, record_f32
    try:
        for i, img in enumerate(pages.values()):
            first_page = i == 0
            engine.run(img)
    finally:
        layers.bias_act, layers.bias_add_f32 = saved, saved_f32
    torch.cuda.synchronize()
    return calls, f32_calls, f32_first, gelu_first


def same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int16), b.contiguous().view(torch.int16))


def check_bias_act_backward(cases):
    """`bias_act`'s backward on the card (`_BiasAct`: the kernel forward,
    `bias_act_grads` backward) against autograd through the plain
    version: the outputs and the gradients of the product and of an fp32
    bias, bit for bit, with the pre-activation output's gradient where it
    is kept. -> the number of cases."""
    import torch

    from tuatara_tpu_torch.kernels import bias_act as BA

    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 0
    for p0, act, keep_pre, dim in cases:
        b0 = torch.randn(p0.shape[dim], device="cuda", generator=gen)
        grads = [torch.randn(p0.shape, device="cuda", generator=gen).to(p0.dtype)
                 for _ in range(2 if keep_pre else 1)]
        got = []
        for fn in (BA.bias_act, BA.bias_act_plain):
            p = p0.detach().clone().requires_grad_()
            b = b0.detach().clone().requires_grad_()
            out = fn(p, b.to(p.dtype), act, keep_pre, dim)
            out = list(out) if keep_pre else [out]
            got.append(out + list(torch.autograd.grad(out, [p, b], grads)))
        for g, w in zip(*got):
            if not same_bits(g.detach(), w.detach()):
                fail(f"bias_act's backward differs from autograd through its plain version on "
                     f"{tuple(p0.shape)} act={act} keep_pre={keep_pre} (max abs err "
                     f"{float((g.float() - w.float()).abs().max())})")
        n += 1
    return n


def check_bias_act(engine, pages, launches):
    """Phase 10a, the kernel: `bias_act` against its plain version on the
    card, bit for bit, on every call of the default path's four pages:
    CRAFT's ReLU-followed convolutions in the layout they came in and in
    the other one (channels_last / contiguous), each with ReLU and with
    ReLU and the pre-ReLU output; PARSEQ's fc1 widths with their GELU;
    seeded fp16 and bf16 tensors in each layout, 95 channels and an
    unaligned view, GELU with and without a bias; its backward on some of
    these. Times a call over the first page's CRAFT calls: the kernel
    (CUDA events, and traced device time), the plain version, the two
    PyTorch calls it replaces (torch.add, then F.relu) and the byte bound;
    and the host's time a call beside those two calls'. -> the kernels
    line's entry."""
    import torch

    from tuatara_tpu_torch.kernels import bias_act as BA

    calls, f32_calls, f32_first, gelu_first = bias_act_calls(engine, pages)
    craft_calls = [c for c in calls if c[4] == 1]
    n_checked = 0
    # Beyond the path: fp16, a Linear's 95 columns, and a view 2 bytes into
    # its storage (the kernel's unvectorised loads).
    gen = torch.Generator(device="cuda").manual_seed(0)
    backward_cases = []
    for dtype in (torch.bfloat16, torch.float16):
        x = (torch.randn(2, 64, 48, 40, device="cuda", generator=gen) * 4).to(dtype)
        lin = (torch.randn(3, 26, 95, device="cuda", generator=gen) * 4).to(dtype)
        odd = (torch.randn(1001, device="cuda", generator=gen) * 4).to(dtype)[1:].view(10, 100)
        for p, dim in ((x, 1), (x.contiguous(memory_format=torch.channels_last), 1),
                       (lin, -1), (odd, -1)):
            b = torch.randn(p.shape[dim], device="cuda", generator=gen).to(dtype)
            for bias in (b, None):
                calls.append((p, bias, "gelu", True, dim))
            for act in BA.ACTS:
                backward_cases += [(p, act, False, dim), (p, act, True, dim)]
        calls.append((finite_values(dtype), None, "gelu", False, -1))
    for p, b, act, keep_pre, dim in calls:
        layouts = [p]
        if dim == 1:
            other = (p.contiguous() if p.is_contiguous(memory_format=torch.channels_last)
                     and not p.is_contiguous() else
                     p.contiguous(memory_format=torch.channels_last))
            layouts.append(other)
            modes = [(act, False), (act, True)]
        else:
            modes = [(act, keep_pre)]
        for x in layouts:
            for mode, keep in modes:
                got = BA.bias_act(x, b, mode, keep, dim)
                want = BA.bias_act_plain(x, b, mode, keep, dim)
                got, want = (got, want) if keep else ((got,), (want,))
                for g, w in zip(got, want):
                    if g.stride() != x.stride() or not same_bits(g, w):
                        err = float((g.float() - w.float()).abs().max())
                        fail(f"bias_act differs from its plain version on {tuple(x.shape)} "
                             f"strides {x.stride()} act={mode} keep_pre={keep} (max abs err "
                             f"{err})")
                n_checked += 1
    # The backward also at the path's shapes: one CRAFT call, one fc1.
    backward_cases += [(craft_calls[0][0], "relu", True, 1)]
    backward_cases += [(c[0], c[2], False, -1) for c in calls if c[4] == -1][:1]
    n_backward = check_bias_act_backward(backward_cases)
    torch.cuda.synchronize()
    relu = time_relu_mode(craft_calls[:len(craft_calls) // len(pages)])
    gelu = time_gelu_mode(gelu_first)

    f32 = check_bias_add_f32(f32_calls, f32_first, [c[0] for c in craft_calls])
    host = relu["host_us_per_call"]
    host_all = {"relu": host["bias_act"], "relu pair (torch.add, F.relu)":
                host["torch.add+F.relu"], "f32": f32["host_us_per_call"]["bias_add_f32"],
                "f32 pair (r + torch.add(y, b))":
                f32["host_us_per_call"]["rounded form: r + torch.add(y, b)"],
                "gelu": gelu["host_us_per_call"]["bias_act"],
                "gelu pair (torch.add, F.gelu)": gelu["host_us_per_call"]["torch.add+F.gelu"]}
    print(f"kernel bias_act: host us a call, each mode beside the two PyTorch calls it "
          f"replaces: {json.dumps(host_all)}", flush=True)
    n = relu["craft_calls_per_page"]
    print(f"kernel bias_act: {n_checked} cases bit-equal to the plain version, {n_backward} "
          f"backward cases bit-equal to autograd's; CRAFT's {n} calls a page "
          f"({pages and next(iter(pages))}): ms/page={relu['ms_per_page']:.4f} "
          f"device_ms/page={relu['device_ms_per_page']} "
          f"plain_ms/page={relu['plain_ms_per_page']:.4f} "
          f"add+relu_ms/page={relu['add_relu_ms_per_page']:.4f} "
          f"bound_ms/page={relu['bound_ms_per_page']:.5f}", flush=True)
    return {
        "name": BA.BA, "route": "cuda", "source": "tuatara_tpu_torch/csrc/bias_act.cu",
        "replaces": "tuatara_tpu/models/layers.py:94-95 and :392-393 (conv2d's and linear's "
                    "bias add with the ReLU or GELU after it, XLA ops: no TPU kernel)",
        "launches": launches.get(BA.BA, 0), "equal": True, "max_abs_err": 0.0,
        "cases": n_checked, "backward_cases": n_backward, "ms": relu["ms_per_page"] / n,
        "plain_ms": relu["plain_ms_per_page"] / n, "bound_ms": relu["bound_ms_per_page"] / n,
        "bound_by": "bytes",
        # The ReLU and GELU modes have no one PyTorch call (the pair they
        # replace is timed apart); the library time is the fp32-output
        # mode's torch chain, y.float() + b.float(), then + r.
        "library_ms": f32["chain_ms"], "library": "fp32-output mode: torch chain "
                                                  "y.float() + b.float(), then + r",
        "f32_mode": f32, "add_relu_ms": relu["add_relu_ms_per_page"] / n, **relu,
        "host_us_per_call_by_mode": host_all, "gelu_mode": gelu,
        "timed_on": "mean a call over the first page's CRAFT calls (default path)",
    }


def time_relu_mode(calls):
    """Phase 10a, the ReLU mode on CRAFT's calls of the first page (`calls`:
    (p, bias, "relu", keep_pre, 1) as the path made them): CUDA-event ms a
    call beside the plain version, the two PyTorch calls it replaces
    (torch.add, then F.relu) and the byte bound (p read, the output and the
    pre-ReLU copy written); traced device ms a page and at the largest map;
    host us a call at [1, 128, 24, 24] beside the pair. -> a summary for
    the kernels line."""
    import torch
    import torch.nn.functional as F

    from tuatara_tpu_torch.kernels import bias_act as BA

    def nbytes(p, b, keep_pre):
        return p.numel() * p.element_size() * (3 if keep_pre else 2) + b.numel() * 2

    rows = []
    for p, b, act, keep_pre, dim in calls:
        bview = b.reshape(-1, 1, 1)
        ms = cuda_ms(lambda: BA.bias_act(p, b, act, keep_pre, dim), 20)
        pms = cuda_ms(lambda: BA.bias_act_plain(p, b, act, keep_pre, dim), 20)
        lms = cuda_ms(lambda: F.relu(torch.add(p, bview)), 20)
        rows.append((ms, pms, lms, nbytes(p, b, keep_pre) / HBM_BYTES_PER_S * 1e3))
        print(f"kernel bias_act {str(list(p.shape)):22s} act={act} keep_pre={keep_pre} "
              f"channels_last={p.is_contiguous(memory_format=torch.channels_last)} ms={ms:.4f} "
              f"plain_ms={pms:.4f} add+relu_ms={lms:.4f} bound_ms={rows[-1][3]:.6f}",
              flush=True)
    # Host time a call at a small map (launch-bound), the wrapper beside
    # the two calls it replaces.
    y = torch.randn(1, 128, 24, 24, device="cuda").bfloat16()
    yb = torch.randn(128, device="cuda").bfloat16()
    ybv = yb.reshape(-1, 1, 1)
    host = {"bias_act": host_us(lambda: BA.bias_act(y, yb, "relu")),
            "torch.add+F.relu": host_us(lambda: F.relu(torch.add(y, ybv)))}
    print(f"kernel bias_act: host us a call at [1, 128, 24, 24] + ReLU {json.dumps(host)}",
          flush=True)
    trace = os.path.join(ROOT, "build", "bias_act_trace.json")
    dev_page, route = device_ms_or_events(lambda: [BA.bias_act(*c) for c in calls], trace,
                                          len(calls))
    p, b, act, keep, dim = max(calls, key=lambda c: c[0].numel())
    dev, big_route = device_ms_or_events(lambda: BA.bias_act(p, b, act, keep, dim), trace, 1)
    largest = {"shape": list(p.shape), "keep_pre": keep, "device_ms": dev,
               "device_ms_route": big_route,
               "bound_ms": nbytes(p, b, keep) / HBM_BYTES_PER_S * 1e3}
    print(f"kernel bias_act: the largest map {json.dumps(largest)}; a page {dev_page:.4f} ms "
          f"({route})", flush=True)
    return {"craft_calls_per_page": len(rows), "device_ms_per_page": dev_page,
            "device_ms_route": route,
            "ms_per_page": sum(r[0] for r in rows), "plain_ms_per_page": sum(r[1] for r in rows),
            "add_relu_ms_per_page": sum(r[2] for r in rows),
            "bound_ms_per_page": sum(r[3] for r in rows), "host_us_per_call": host,
            "largest": largest}


def time_gelu_mode(calls):
    """Phase 10a, the GELU mode on fc1's calls of the first page (`calls`:
    (p, bias, "gelu", keep_pre, dim) as the path made them): CUDA-event ms
    a call, traced device ms a call, the plain version, torch.add then
    F.gelu (the two PyTorch calls of another GELU), the byte bound (p read,
    the output written) by shape; host us a call at [4, 128, 1536] beside
    torch.add then F.gelu. -> a summary for the kernels line."""
    import torch
    import torch.nn.functional as F

    from tuatara_tpu_torch.kernels import bias_act as BA

    rows = {}
    for p, b, _, _, dim in calls:
        ms = cuda_ms(lambda: BA.bias_act(p, b, "gelu", False, dim), 20)
        pms = cuda_ms(lambda: BA.bias_act_plain(p, b, "gelu", False, dim), 20)
        lms = cuda_ms(lambda: F.gelu(torch.add(p, b)), 20)
        bound = (p.numel() * 2 * p.element_size() + b.numel() * 2) / HBM_BYTES_PER_S * 1e3
        rows.setdefault(tuple(p.shape), []).append((ms, pms, lms, bound))
    for shape, rr in rows.items():
        print(f"kernel bias_act gelu {list(shape)} calls/page={len(rr)} "
              f"ms={sum(r[0] for r in rr) / len(rr):.4f} "
              f"plain_ms={sum(r[1] for r in rr) / len(rr):.4f} "
              f"add+gelu_ms={sum(r[2] for r in rr) / len(rr):.4f} bound_ms={rr[0][3]:.6f}",
              flush=True)
    recs = traced_records_ms(lambda: [BA.bias_act(p, b, "gelu", False, d)
                                      for p, b, _, _, d in calls],
                             os.path.join(ROOT, "build", "bias_act_gelu_trace.json"), len(calls))
    dev = None if recs is None else sum(recs)
    g = torch.Generator(device="cuda").manual_seed(7)
    y = torch.randn(4, 128, 1536, device="cuda", generator=g).bfloat16()
    yb = torch.randn(1536, device="cuda", generator=g).bfloat16()
    host = {"bias_act": host_us(lambda: BA.bias_act(y, yb, "gelu", False, -1)),
            "torch.add+F.gelu": host_us(lambda: F.gelu(torch.add(y, yb)))}
    flat = [r for rr in rows.values() for r in rr]
    n = max(len(flat), 1)
    out = {"calls_first_page": len(flat), "ms": sum(r[0] for r in flat) / n,
           "plain_ms": sum(r[1] for r in flat) / n, "add_gelu_ms": sum(r[2] for r in flat) / n,
           "bound_ms": sum(r[3] for r in flat) / n,
           "device_ms": None if dev is None else dev / n, "host_us_per_call": host,
           "device_ms_by_shape": by_shape([c[0].shape for c in calls], recs),
           "by_shape": {str(list(k)): {"calls": len(v), "ms": sum(r[0] for r in v) / len(v),
                                       "bound_ms": v[0][3]} for k, v in rows.items()}}
    print(f"kernel bias_act gelu: fc1's {len(flat)} calls of the first page: "
          f"ms/call={out['ms']:.4f} device_ms/call={out['device_ms']} "
          f"plain_ms/call={out['plain_ms']:.4f} add+gelu_ms/call={out['add_gelu_ms']:.4f} "
          f"bound_ms/call={out['bound_ms']:.6f} device_ms_by_shape="
          f"{json.dumps(out['device_ms_by_shape'])}; host us a call at [4, 128, 1536] "
          f"{json.dumps(host)}", flush=True)
    return out


def same_f32_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype == torch.float32 and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def check_bias_add_f32(path_calls, first_page, craft_maps=()):
    """Phase 10a, the fp32-output mode (`bias_add_f32`, tt_bias_add_f32):
    against its plain version bit for bit on every distinct call of the
    default path's pages (PARSEQ's residual sites: [.., 384] from products
    384 and 1536 wide, residuals of y's shape, [1, S, D] pos_embed, [1, 1,
    D] position queries), along dim 1 of every CRAFT map of the pages
    (`craft_maps`, the training graph's conv5 and trunk form) in both NCHW
    layouts, and on seeded bf16 and fp16 cases (every residual shape and
    none, 95 columns, an unaligned y; along dim 1, 95 channels, planes
    that are not a multiple of 8 elements, an unaligned map); its backward
    (`_BiasAddF32`, along both dims) against autograd
    through the plain version; timed a call over the first page's calls
    beside its plain version, the torch chain it replaces (y.float() +
    b.float(), then + r) and its byte bound (y and r read, the fp32 sum
    written), and traced (device time a page); its host time a call beside
    the chain's and the rounded form's two launches (r + torch.add(y, b)). -> a
    summary for the kernels line."""
    import torch

    from tuatara_tpu_torch.kernels import bias_act as BA

    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(*shape, dtype=torch.float32):
        return (torch.randn(*shape, device="cuda", generator=gen) * 3).to(dtype)

    cases = [(y, b, r, -1) for y, b, r in path_calls]
    for dtype in (torch.bfloat16, torch.float16):
        for c in (384, 95):
            y = rand(4, 26, c, dtype=dtype)
            b = rand(c, dtype=dtype)
            for r in (None, rand(4, 26, c), rand(1, 26, c), rand(1, 1, c), rand(c),
                      rand(1, 26, c).expand(4, 26, c)):
                cases.append((y, b, r, -1))
        odd = rand(26 * 384 + 1, dtype=dtype)[1:].view(26, 384)
        cases.append((odd, rand(384, dtype=dtype), rand(26, 384), -1))
        for shape in ((2, 95, 10, 12), (2, 6, 5, 7), (2, 64, 16, 24)):
            x = rand(*shape, dtype=dtype)
            b = rand(shape[1], dtype=dtype)
            cases += [(x, b, None, 1),
                      (x.contiguous(memory_format=torch.channels_last), b, None, 1)]
        odd = rand(2 * 6 * 8 * 8 + 1, dtype=dtype)[1:].view(2, 6, 8, 8)
        cases.append((odd, rand(6, dtype=dtype), None, 1))
    n_path_f32 = len(path_calls)

    def check(y, b, r, dim):
        got, want = BA.bias_add_f32(y, b, r, dim), BA.bias_add_f32_plain(y, b, r, dim)
        if got.stride() != want.stride() or not same_f32_bits(got, want):
            fail(f"bias_add_f32 differs from its plain version on {tuple(y.shape)} strides "
                 f"{y.stride()} {y.dtype} dim {dim} residual "
                 f"{None if r is None else tuple(r.shape)} (max abs err "
                 f"{float((got - want).abs().max())})")

    for case in cases:
        check(*case)
    for p in craft_maps:
        b = rand(p.shape[1], dtype=p.dtype)
        check(p, b, None, 1)
        check(p.contiguous() if p.is_contiguous(memory_format=torch.channels_last)
              and not p.is_contiguous() else p.contiguous(memory_format=torch.channels_last),
              b, None, 1)
    n_dim1 = sum(c[3] == 1 for c in cases) + 2 * len(craft_maps)
    n_cases = len(cases) + 2 * len(craft_maps)
    seeded = cases[n_path_f32:n_path_f32 + 20]  # bf16's
    n_backward = 0
    dim1 = [c for c in seeded if c[3] == 1]
    for y0, b0, r0, dim in seeded[:6] + seeded[12:13] + dim1 + cases[:2]:
        got = []
        b0 = b0.detach().float()
        g = rand(*y0.shape)
        for fn in (BA.bias_add_f32, BA.bias_add_f32_plain):
            y = y0.detach().clone().requires_grad_()
            b32 = b0.clone().requires_grad_()
            r = None if r0 is None else r0.detach().clone().requires_grad_()
            out = fn(y, b32.to(y.dtype), r, dim)
            wrt = [y, b32] + ([r] if r is not None else [])
            got.append([out] + list(torch.autograd.grad(out, wrt, g)))
        for a, w in zip(*got):
            if not (same_f32_bits(a, w) if a.dtype == torch.float32 else same_bits(a, w)):
                fail(f"bias_add_f32's backward differs from autograd through its plain version "
                     f"on {tuple(y0.shape)} residual {None if r0 is None else tuple(r0.shape)}")
        n_backward += 1
    torch.cuda.synchronize()
    out = {"cases": n_cases, "cases_dim1": n_dim1, "backward_cases": n_backward,
           **time_f32_mode(first_page)}
    print(f"kernel bias_act f32: {n_cases} cases bit-equal to the plain version ({n_dim1} "
          f"along dim 1 of NCHW maps), {n_backward} "
          f"backward cases bit-equal to autograd's; the first page's "
          f"{out['calls_first_page']} calls: "
          f"ms/call={out['ms']:.4f} plain_ms/call={out['plain_ms']:.4f} "
          f"chain_ms/call={out['chain_ms']:.4f} bound_ms/call={out['bound_ms']:.6f} "
          f"ms/page={out['ms_per_page']:.4f} device_ms/page={out['device_ms_per_page']} "
          f"chain_ms/page={out['chain_ms_per_page']:.4f} device_ms_by_y_shape="
          f"{json.dumps(out['device_ms_by_y_shape'])}; host us a call at [32, 128, 384] + "
          f"[1, 128, 384] {json.dumps(out['host_us_per_call'])}", flush=True)
    return out


def time_f32_mode(first_page):
    """Phase 10a, the fp32-output mode on the first page's calls
    (`first_page`: (y, bias, residual) as the path made them): CUDA-event
    ms a call beside its plain version, the torch chain it replaces
    (y.float() + b.float(), then + r) and its byte bound (y and r read
    once, the fp32 sum written), by shape; traced device time a page and
    by y's shape; host us a call beside the chain's and the rounded form's
    two launches (r + torch.add(y, b)). -> a summary for the kernels line."""
    import torch

    from tuatara_tpu_torch.kernels import bias_act as BA

    gen = torch.Generator(device="cuda").manual_seed(6)

    def rand(*shape, dtype=torch.float32):
        return (torch.randn(*shape, device="cuda", generator=gen) * 3).to(dtype)

    rows = []
    for y, b, r in first_page:
        ms = cuda_ms(lambda: BA.bias_add_f32(y, b, r), 20)
        pms = cuda_ms(lambda: BA.bias_add_f32_plain(y, b, r), 20)
        cms = cuda_ms(lambda: (y.float() + b.float()) + r, 20)
        nbytes = y.numel() * (2 + 4) + BA.residual_period(r, y.shape).numel() * 4 + b.numel() * 2
        rows.append((ms, pms, cms, nbytes / HBM_BYTES_PER_S * 1e3, tuple(y.shape),
                     tuple(r.shape)))
    shapes = {}
    for row in rows:
        shapes.setdefault((row[4], row[5]), []).append(row)
    for (ys, rs), rr in shapes.items():
        print(f"kernel bias_act f32 y={list(ys)} residual={list(rs)} calls/page={len(rr)} "
              f"ms={sum(x[0] for x in rr) / len(rr):.4f} "
              f"plain_ms={sum(x[1] for x in rr) / len(rr):.4f} "
              f"chain_ms={sum(x[2] for x in rr) / len(rr):.4f} bound_ms={rr[0][3]:.6f}",
              flush=True)
    # Host time a call at the encoder's patch_embed + pos_embed shape.
    y, b, r = rand(32, 128, 384, dtype=torch.bfloat16), rand(384, dtype=torch.bfloat16), rand(
        1, 128, 384)
    host = {"bias_add_f32": host_us(lambda: BA.bias_add_f32(y, b, r)),
            "torch chain": host_us(lambda: (y.float() + b.float()) + r),
            "rounded form: r + torch.add(y, b)": host_us(lambda: r + torch.add(y, b))}
    # Device time a page: one trace of the first page's calls.
    recs = traced_records_ms(lambda: [BA.bias_add_f32(y, b, r) for y, b, r in first_page],
                             os.path.join(ROOT, "build", "bias_add_f32_trace.json"),
                             len(first_page))
    route = "trace"
    if recs is not None:
        dev_page = sum(recs)
    else:  # every trace lost records: the same calls by CUDA events
        dev_page, route = cuda_ms(lambda: [BA.bias_add_f32(y, b, r) for y, b, r in first_page],
                                  5), "events"
    print(f"kernel bias_act f32: the first page's {len(first_page)} calls {dev_page:.4f} ms of "
          f"device time ({route})", flush=True)
    n = max(len(rows), 1)
    return {"calls_first_page": len(rows), "device_ms_per_page": dev_page,
            "device_ms_route": route,
            "device_ms_by_y_shape": by_shape([c[0].shape for c in first_page], recs),
            "ms": sum(x[0] for x in rows) / n, "plain_ms": sum(x[1] for x in rows) / n,
            "chain_ms": sum(x[2] for x in rows) / n, "bound_ms": sum(x[3] for x in rows) / n,
            "ms_per_page": sum(x[0] for x in rows), "chain_ms_per_page": sum(x[2] for x in rows),
            "bound_ms_per_page": sum(x[3] for x in rows), "host_us_per_call": host}


def check_bias_act_launches(pages):
    """Phase 10a, the launches: the default and latency() pages, counts
    zeroed just before and read just after. `bias_act` must run once for
    each call of a float Conv of CRAFT that a ReLU follows (the trunk's,
    each decoder level's conv2, the head's first four), once for each
    call of a float Linear of PARSEQ with a GELU (fc1) and once for each
    call with a residual, which the Linear takes in fp32 (its fp32-output
    mode: the residual Linears and patch_embed, beside K6 and K7 too), and
    nowhere else.
    -> {preset: launches a page, CRAFT's and PARSEQ's}."""
    import tuatara_tpu_torch
    from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
    from tuatara_tpu_torch.kernels.bias_act import BA
    from tuatara_tpu_torch.models.layers import Conv, Linear

    out = {}
    for name, config in (("default", tuatara_tpu_torch.OcrConfig()),
                         ("latency", tuatara_tpu_torch.OcrConfig.latency())):
        engine = tuatara_tpu_torch.api.get_engine(config, WEIGHTS)
        seen = {"craft": 0, "at": 0, "relu": 0, "gelu": 0, "residual": 0}

        def pre(_m, _a):
            seen["at"] = LAUNCHES[BA]

        def post(_m, _a, _o):
            seen["craft"] += LAUNCHES[BA] - seen["at"]

        def layer(m, _a, kwargs, _o):
            seen["relu"] += bool(kwargs.get("relu"))
            seen["gelu"] += kwargs.get("act") == "gelu"
            seen["residual"] += kwargs.get("residual") is not None

        hooks = [engine.craft.register_forward_pre_hook(pre),
                 engine.craft.register_forward_hook(post)]
        hooks += [m.register_forward_hook(layer, with_kwargs=True)
                  for model in (engine.craft, engine.parseq) for m in model.modules()
                  if isinstance(m, (Conv, Linear))]
        try:
            reset_launches()
            for img in pages.values():
                tuatara_tpu_torch.image_to_data(img, WEIGHTS, config=config)
            got = LAUNCHES[BA]
        finally:
            for h in hooks:
                h.remove()
        n = len(pages)
        print(f"bias_act launches, {name}: {got} on {n} pages ({got / n:.1f} a page): CRAFT "
              f"{seen['craft']} ({seen['relu']} ReLU-followed float conv calls, "
              f"{seen['relu'] / n:.1f} a page), PARSEQ {got - seen['craft']} ({seen['gelu']} "
              f"float Linear calls with a GELU, {seen['gelu'] / n:.1f} a page; "
              f"{seen['residual']} with a residual, {seen['residual'] / n:.1f} a page)",
              flush=True)
        want = seen["relu"] + seen["gelu"] + seen["residual"]
        if seen["craft"] != seen["relu"] or got != want or (name == "default"
                                                              and not seen["residual"]):
            fail(f"bias_act launched {got} times under {name} ({seen['craft']} in CRAFT), "
                 f"expected {want} (one a ReLU-followed conv call, {seen['relu']}, one a Linear "
                 f"call with a GELU, {seen['gelu']}, one a Linear call with a residual, "
                 f"{seen['residual']})")
        out[name] = {"per_page": got / n, "craft_per_page": seen["craft"] / n,
                     "parseq_per_page": (got - seen["craft"]) / n,
                     "residual_per_page": seen["residual"] / n}
    return out


def upsample_reference(x, h, w):
    """JAX's bf16 bilinear resize computed in fp32 on the card: one axis at
    a time (the cheaper contraction first, H on a tie), each axis summed in
    fp32 and rounded to x's dtype."""
    import torch.nn.functional as F

    hi, wi = x.shape[-2:]
    sizes = [(h, wi), (h, w)] if wi * h * (hi + w) <= hi * w * (wi + h) else [(hi, w), (h, w)]
    for size in sizes:
        x = F.interpolate(x.float(), size=size, mode="bilinear",
                          align_corners=False).to(x.dtype)
    return x


def check_rounding(engine, img):
    """Phase 10b: every float Conv and Linear of one default page (and each
    float decoder level, whose 1x1 conv1 runs as two convs summed, the
    trunk side before its upsample), its output on the card against
    "(the same bf16 product) rounded, + bias, rounded" (then ReLU or GELU
    as the layer applies it), or for a Linear called with a residual
    "r + (fp32(the same product) + fp32(bias))", never rounded, computed
    on the card with PyTorch's own ops from the inputs the layer was
    given. -> {kind: equal share}, fatal
    below BF16_MIN_ROUNDED overall."""
    import torch
    import torch.nn.functional as F

    from tuatara_tpu_torch.kernels.bias_act import gelu_plain
    from tuatara_tpu_torch.models.layers import Conv, Linear, PaddedLinear

    records = {"conv": [], "linear": [], "level": []}

    def hook(m, args, kwargs, out):
        records["conv" if isinstance(m, Conv) else "linear"].append((m, args[0], kwargs, out))

    craft = engine.craft
    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for model in (craft, engine.parseq) for m in model.modules()
             if isinstance(m, (Conv, Linear))]
    double_conv = craft._double_conv

    def level(block, y, skip):
        out = double_conv(block, y, skip)
        records["level"].append((block, y, skip, out))
        return out

    craft._double_conv = level
    try:
        engine.run(img)
    finally:
        del craft._double_conv
        for h in hooks:
            h.remove()

    def rounded(p, b):
        """p + b along p's channels (dim 1 of an NCHW tensor, the last of
        a Linear's), in fp32, rounded to p's dtype."""
        b = b.float().reshape(-1, 1, 1) if p.dim() == 4 else b.float()
        return (p.float() + b).to(p.dtype)

    equal, total, worst = {}, {}, 1.0

    def tally(kind, got, want):
        nonlocal worst
        bits = torch.int32 if got.dtype == torch.float32 else torch.int16
        if got.dtype != want.dtype:
            fail(f"bf16 rounding on the card: a {kind} output is {got.dtype}, expected "
                 f"{want.dtype}")
        eq = int((got.contiguous().view(bits) == want.contiguous().view(bits)).sum())
        equal[kind] = equal.get(kind, 0) + eq
        total[kind] = total.get(kind, 0) + got.numel()
        worst = min(worst, eq / max(got.numel(), 1))

    with torch.no_grad():
        for m, x, kw, out in records["conv"]:
            w = m.weight
            v = rounded(F.conv2d(x.to(w.dtype), w, None, padding=m.padding,
                                 dilation=m.dilation), m.bias)
            if kw.get("keep_pre"):
                tally("conv", out[0], F.relu(v))
                tally("conv", out[1], v)
            else:
                tally("conv", out, F.relu(v) if kw.get("relu") else v)
        for m, x, kw, out in records["linear"]:
            w, n = m.weight, m.weight.shape[0]
            wp = F.pad(w, (0, 0, 0, -n % 8)) if isinstance(m, PaddedLinear) else w
            p = F.linear(x.to(w.dtype), wp)[..., :n]
            r = kw.get("residual")
            if r is not None:
                # The fp32-output sites: r + (fp32(product) + fp32(bias)), never rounded.
                tally("residual", out, r + (p.float() + m.bias.float()))
                continue
            v = rounded(p, m.bias)
            if r is not None:
                tally("linear", out, r + v)
                continue
            tally("linear", out, gelu_plain(v) if kw.get("act") == "gelu" else v)
        for block, y, skip, out in records["level"]:
            blk = craft.up[block]
            c1, c2 = blk["conv1"], blk["conv2"]
            w, ca = c1.weight, y.shape[1]
            ya = rounded(F.conv2d(y.to(w.dtype), w[:, :ca]), c1.bias)
            if ya.shape[-2:] != skip.shape[-2:]:
                ya = upsample_reference(ya, *skip.shape[-2:])
            z = F.relu(ya + F.conv2d(skip.to(w.dtype), w[:, ca:]))
            v = rounded(F.conv2d(z, c2.weight, None, padding=c2.padding), c2.bias)
            tally("level", out, F.relu(v))
    shares = {k: equal[k] / total[k] for k in total}
    overall = sum(equal.values()) / sum(total.values())
    print(f"rounding on the card (10b): {len(records['conv'])} convs, "
          f"{len(records['linear'])} Linear calls ({total.get('residual', 0)} values of "
          f"fp32-output residual sites), {len(records['level'])} decoder levels of "
          f"one default page: bit-equal shares {json.dumps(shares)}, overall {overall:.6f}, "
          f"least of a layer {worst:.6f} (gate {BF16_MIN_ROUNDED})", flush=True)
    if not total.get("residual"):
        fail("bf16 rounding on the card: no Linear call with a residual on the default page")
    if overall < BF16_MIN_ROUNDED:
        fail(f"bf16 rounding on the card: {overall:.6f} of the values equal "
             f"(product rounded) + bias, rounded (< {BF16_MIN_ROUNDED})")
    return {**shares, "overall": overall, "least_layer": worst}


def check_int8_rounding(prod, page, img):
    """Phase 10b, int8: one production() page's int8 CRAFT at bf16, each
    QConv's dynamic scale xs and int8 input on the card against the port's
    plain route on the CPU fed the same inputs. The card's run records the
    canvas and each layer's (xq, xs) and int32 sums; a CPU copy of the
    model then runs the canvas (conv1_1 by SC's plain version), each layer
    computing its own (xq, xs) from what reached it (the dequant, ReLU,
    pools, upsamples, the decoder's sum, the abs-max, the division, the
    rounding) and going on with the card's (xq, xs) and sums (exact, phase
    4e). Fatal on any difference. -> a summary."""
    import copy

    import torch

    from tuatara_tpu_torch.kernels.int8 import int8_conv
    from tuatara_tpu_torch.models.layers import QConv

    t0 = time.perf_counter()
    names = {id(m): n for n, m in prod.craft.qconvs()}
    card, canvas, orig = [], [], QConv.sums

    def record(self, x):
        xq, xs = self.quantize_input(x)
        acc = int8_conv(xq, self.wmat, self.wq.shape[0], self.dilation)
        card.append((names[id(self)], xq.cpu(), xs.cpu(), acc.cpu()))
        return acc, self.sw / xs

    hook = prod.craft.register_forward_pre_hook(lambda m, args: canvas.append(args[0].cpu()))
    QConv.sums = record
    try:
        with torch.no_grad():
            prod.detect(torch.from_numpy(img[None]).cuda())
    finally:
        QConv.sums = orig
        hook.remove()
    cpu_craft = copy.deepcopy(prod.craft).cpu()
    cpu_names = {id(m): n for n, m in cpu_craft.qconvs()}
    rows = []

    def replay(self, x):
        name, xq, xs, acc = card[len(rows)]
        own_q, own_s = self.quantize_input(x)
        rows.append({"layer": cpu_names[id(self)], "card_layer": name,
                     "xs_equal": float(own_s) == float(xs), "xq_differ": int((own_q != xq).sum()),
                     "xs_cpu": float(own_s), "xs_card": float(xs)})
        return acc, self.sw / xs

    QConv.sums = replay
    try:
        with torch.no_grad():
            cpu_craft(canvas[0])
    finally:
        QConv.sums = orig
    bad = [r for r in rows if r["layer"] != r["card_layer"] or not r["xs_equal"] or r["xq_differ"]]
    secs = time.perf_counter() - t0
    print(f"rounding on the card (10b), int8 CRAFT of production() on {page} "
          f"{list(canvas[0].shape)}: {len(rows) - len(bad)} of {len(card)} layers with xs and "
          f"int8 input equal to the CPU's plain route on the same inputs; {secs:.1f} s",
          flush=True)
    for r in bad:
        print(f"rounding on the card (10b), int8: PARTS {json.dumps(r)}", flush=True)
    if len(rows) != len(card) or bad:
        fail(f"int8 CRAFT on the card parts from the CPU's plain route at "
             f"{bad[0]['layer'] if bad else 'the layer count'}")
    return {"page": page, "layers": len(rows), "equal": len(rows) - len(bad), "seconds": secs}


def check_bf16_agreement(pages, floor=True):
    """Phase 10c: the default, latency() and production() engines (bf16) on
    the four pages against JAX's bf16 records of the same algorithm
    (FIXTURE_BF16, BF16_RECORD): the share of JAX's records with the same
    text and bbox. Fatal below BF16_FLOOR unless `floor` is off (to read
    the parent commit's share with this function). Then, printed only,
    latency() against JAX's `latency()` off a TPU ("latency": XLA's eager
    encoder and scan decode). -> {preset: share}, the last under
    "latency_vs_xla"."""
    import tuatara_tpu_torch

    with open(FIXTURE_BF16) as f:
        ref = json.load(f)["variants"]
    shares = {}
    runs = [(name, name, record, True) for name, record in BF16_RECORD.items()]
    runs.append(("latency_vs_xla", "latency", "latency", False))
    for key, preset, record, gated in runs:
        config = getattr(tuatara_tpu_torch.OcrConfig, preset)() if preset != "default" \
            else tuatara_tpu_torch.OcrConfig()
        hit = total = 0
        per_page = {}
        for page, img in pages.items():
            want = ref[record]["pages"][page]["words"]
            got = tuatara_tpu_torch.image_to_data(img, WEIGHTS, config=config)
            share = word_share(want, got)
            per_page[page] = round(share, 4)
            hit += round(share * len(want))
            total += len(want)
        shares[key] = hit / total
        limit = f"floor {BF16_FLOOR[key]:.4f}" if gated else "not gated"
        print(f"bf16 agreement with JAX (10c), {preset} against the {record!r} record: "
              f"{shares[key]:.4f} ({hit} of {total} JAX records, text and bbox) on the card; "
              f"per page {json.dumps(per_page)}; {limit}", flush=True)
        if gated and floor and hit < BF16_FLOOR[key] * total - 1e-9:
            fail(f"bf16 agreement with JAX under {preset} ({record!r} record): "
                 f"{shares[key]:.4f} < {BF16_FLOOR[key]}")
    return shares


def check_phase10(engine, prod, pages, launches):
    """Phase 10 (see the module docstring). -> (the kernels line's bias_act
    entry, the phase's summary)."""
    t_phase = time.perf_counter()
    entry = check_bias_act(engine, pages, launches)
    per_page = check_bias_act_launches(pages)
    rounding = check_rounding(engine, next(iter(pages.values())))
    rounding["int8"] = check_int8_rounding(prod, INT8_ROUNDING_PAGE, pages[INT8_ROUNDING_PAGE])
    agreement = check_bf16_agreement(pages)
    secs = time.perf_counter() - t_phase
    print(f"phase 10: {secs:.1f} s", flush=True)
    return entry, {"bias_act_launches": per_page, "rounding": rounding,
                   "jax_bf16_share": agreement, "seconds": secs}


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
    tuatara_tpu_torch.api.ENGINE_CACHE_MAX = 12

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
    results, launches = drive(default, pages, post + ("bias_act",))
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    for name, words in results.items():
        print(f"bf16 {name}: {len(words)} boxes: "
              + " ".join(w["text"] for w in words[:10]), flush=True)

    # 3b. the latency() preset: fused recognizer kernels
    latency = tuatara_tpu_torch.OcrConfig.latency()
    lat = tuatara_tpu_torch.api.get_engine(latency, WEIGHTS)
    lat_results, lat_launches = drive(latency, pages,
                                      post + ("vit_blocks", "greedy_decode", "bias_act"))
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
        production, pages, {**dict.fromkeys(post + ("vit_blocks", "greedy_decode", "stem_conv"),
                                            1), "int8_conv": n_q})
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

    # 3g. beam and NAR decode, the int8 recognizer encoder, the command line
    int8_linear_summary = check_modes(lat, pages, geo_pages, post, results["resume_example"])

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
    kernels.append(check_stem(prod, pages, prod_launches))

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

    # 7. training at full width: parity with JAX's record, resume, the
    # checkpoint served, learning, step rates
    training, gelu_entry = check_training(pages, results, lat_results, post, card)
    kernels.append(gelu_entry)

    # 8. conversion, mesh, profiling, native
    phase8 = check_phase8(pages, lat, lat_results, calibrated, post, card)

    # 9. engines with no weights, the C ABI, the binding, the examples
    phase9 = check_phase9(pages, post)

    # 10. bf16 rounded where JAX rounds: bias_act, the rounding, JAX's records
    bias_entry, phase10 = check_phase10(engine, prod, pages, launches)
    kernels.append(bias_entry)

    print(json.dumps({"int8_conv": int8_summary}), flush=True)
    print(json.dumps({"int8_linear": int8_linear_summary}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"phase8": phase8}), flush=True)
    print(json.dumps({"phase9": phase9}), flush=True)
    print(json.dumps({"phase10": phase10}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--train-resume":  # phase 7's child
        sys.exit(resume_child(sys.argv[2]))
    if len(sys.argv) == 6 and sys.argv[1] == "--mesh-child":  # phase 8's ranks
        sys.path.insert(0, ROOT)
        child = {"serve": mesh_serve_child, "train": mesh_train_child}[sys.argv[2]]
        sys.exit(child(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
