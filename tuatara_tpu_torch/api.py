"""Engine + public API: image in -> word boxes + transcripts out.

Port of `tuatara_tpu/api.py` with greedy AR decode and one cloze
refinement: `image_to_data(image)` -> `OcrEngine.run_pages`. A batch of
same-sized pages goes through

1. canvas prep and the CRAFT forward (conv1_2 + ReLU + pool1 as the CUDA
   kernel K8 where `models.craft.FUSED_STAGE1` lets it), batched under
   int8 and a page at a time in float, so that no page's result depends
   on the pages beside it. With `tiled_detection`, a page whose magnified
   long side exceeds the canvas is not downscaled: its overlapping
   canvas-sized tiles go through CRAFT as one batch (that page's alone)
   and their heatmaps are max-blended back (`ops/tiling.py`);
2. per page: `extract_boxes` (the CUDA kernels K1-K3 on the card, or K4,
   K2 and K5 when text_threshold < low_text; with `box_mode="rotated"`
   also a rotated rectangle per box, with the hull kernel H1), scaling
   to image coordinates, crop windows (or the rotated corners), and
   compaction of the valid boxes to the front (stable, so component
   raster order is kept). A tiled page takes axis boxes in either mode,
   as in JAX;
3. one recognition slab over all pages' live boxes, padded to the
   `rec_buckets` ladder, its rows ordered by box aspect ratio (a pure
   permutation, undone before decoding); rotated boxes are cropped by a
   perspective warp of their corners;
4. PARSEQ (`Parseq.recognize`, JAX `_recognize_body`) under
   `decode_mode` "greedy" (AR decode + cloze refinement), "nar" (one
   non-autoregressive pass + refinement) or "beam" (`beam_size` beams, no
   refinement), the sequence confidence (greedy and NAR: the product of
   per-step max probability up to and including the first EOS; beam: the
   exp of the best beam's log-probability), and the tokenizer on the host.
   With `encoder_impl` / `decode_impl` "pallas" at bf16 (the `latency()`
   preset) the encoder blocks and the greedy decode run as the fused CUDA
   kernels K6 and K7, their weight bundles stacked once at construction
   (K7 decodes greedily only, so beam and NAR take the plain decode, as
   JAX's `decode_impl` affects greedy alone).

With `quantized_serving` (the `production()` preset) CRAFT serves int8
(`Craft.quantize`, after the weights load, as the JAX engine quantizes its
detector): its convolutions but conv1_1 and the head's 1x1s are int8 x int8
-> int32 GEMMs (`kernels/int8.py`). With an `encoder_impl` other than
"pallas" (e.g. `OcrConfig(quantized_serving=True)`) the recognizer's
encoder serves int8 too (`Parseq.quantize`: the patch embed and every
block's linear layers; then K6 is off). Activation scales are dynamic until
`OcrEngine.calibrate(pages)` freezes static ones, or a `calibration.npz`
beside the weights (`save_calibration`) supplies them at construction.
`run_lines` / `run_blocks` group a page's words into lines and blocks
(`ops/grouping.py`).

`run_pages` is `_finalize(_dispatch(images))`, as in the JAX engine:
`_dispatch` issues detection and, when the batch geometry has served a
bucket before, the crop + recognition slab at that bucket (speculative
recognition), with no host read; `_finalize` fetches the counts, boxes and
recognition results in one copy and runs a correctly sized recognition pass
only when the speculation fell short. `run_stream` pipelines batches over
that split (uploads on a side stream from a producer thread, `depth`
dispatches in flight), `run_mixed` groups pages of mixed sizes, and
`engine.stats` accumulates the serving counters.

With `mesh=` (a `parallel.make_mesh` mesh with a 'dp' axis, JAX's
`OcrEngine(mesh=)`) the engine is SPMD over the mesh's ranks: every rank
calls `run_pages` / `run_stream` / `calibrate` with the same whole batch and
returns the whole result list, as JAX's single controller sees it. The
batch pads to a dp multiple with copies of its last page, whose results are
dropped.
Each rank detects its contiguous shard of pages (the labeler runs to that
shard's own convergence, as under JAX's shard_map); under int8 CRAFT with
dynamic scales each layer's activation abs-max is taken over the whole
batch (an all-reduce MAX over dp), as in JAX's partitioned conv trunk. The
small detection outputs are all-gathered, every rank builds the same slab
order and bucket (so speculation picks one bucket everywhere), crops its
contiguous rows of the slab from the whole batch it holds, recognizes them,
and the ids and confidences are all-gathered. Recognition is per shard, as
JAX's shard_map of `_recognize_body`: a dynamic int8 encoder's scales span
a rank's rows, not the slab (its calibration spans the slab). Without a
mesh none of this runs.

The stages are marked for `torch.profiler` traces under JAX's names
(`tuatara_detect`, `tuatara_recognize`, `tuatara_fetch`,
`tuatara_decode`; `utils/profiling.py`); the marks read nothing back from
the device.

Models load once per engine and stay on the device; with no `weights_dir`
they are drawn at random from `seed`, as JAX draws them (`random_trees`).
The engine runs on the card unless the caller passes `device="cpu"` (under
a mesh: the mesh's device).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from tuatara_tpu_torch.config import DEFAULT_CONFIG, CraftConfig, OcrConfig, ParseqConfig
from tuatara_tpu_torch.kernels.int8 import check_shapes as check_int8_shapes
from tuatara_tpu_torch.models import layers as L
from tuatara_tpu_torch.models.craft import Craft, init_craft
from tuatara_tpu_torch.models.layers import set_compute_dtype
from tuatara_tpu_torch.models.parseq import Parseq, init_parseq
from tuatara_tpu_torch.ops.boxes import extract_boxes, scale_boxes, tesseract_bbox
from tuatara_tpu_torch.ops.grouping import group_blocks, group_lines
from tuatara_tpu_torch.ops.minarearect import fma
from tuatara_tpu_torch.ops.resize import INV_255, canvas_prep, canvas_shape, pad32, resample
from tuatara_tpu_torch.ops.tiling import extract_tiles, stitch_heatmaps
from tuatara_tpu_torch.ops.warp import (crop_rects, extract_crops_batched,
                                        extract_crops_perspective_batched)
from tuatara_tpu_torch.tokenizer import Tokenizer
from tuatara_tpu_torch.utils import weights as W
from tuatara_tpu_torch.weights import craft_state_dict, module_tree, parseq_state_dict

logger = logging.getLogger("tuatara_tpu_torch")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_device(device: Optional[str]) -> torch.device:
    """None -> the first CUDA card; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the engine runs on the GPU by default; pass "
                "device='cpu' to run it on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def random_trees(craft_config: CraftConfig, parseq_config: ParseqConfig, seed: int = 0
                 ) -> Tuple[Any, Any]:
    """(CRAFT tree, PARSEQ tree) drawn at random from `seed` in JAX's layout
    (`models.craft.init_craft`, then `models.parseq.init_parseq`, on one CPU
    generator): what an engine with no weights_dir serves, and what
    `utils.weights.save_weights_dir` writes as a weights directory."""
    gen = torch.Generator().manual_seed(seed)
    craft = module_tree(init_craft(craft_config, gen))
    return craft, module_tree(init_parseq(parseq_config, gen))


def content_mask(h: int, w: int, cfg: OcrConfig, device) -> torch.Tensor:
    """[hm_h, hm_w] bool: the heatmap pixels inside the page's /32-padded
    content extent (the canvas beyond it is padding, masked out of boxes)."""
    canvas_h, canvas_w, ch, cw, _ = canvas_shape(h, w, cfg)
    r = cfg.ratio_net
    rows = torch.arange(canvas_h // r, device=device) < ch // r
    cols = torch.arange(canvas_w // r, device=device) < cw // r
    return rows[:, None] & cols[None, :]


class OcrEngine:
    """Persistent two-stage OCR engine (CRAFT detect + PARSEQ recognize)."""

    def __init__(self, config: OcrConfig = DEFAULT_CONFIG,
                 craft_config: Optional[CraftConfig] = None,
                 parseq_config: Optional[ParseqConfig] = None,
                 weights_dir: Optional[str] = None, seed: int = 0,
                 device: Optional[str] = None, mesh=None):
        """With no `weights_dir` the models are drawn at random from `seed`
        (JAX's `OcrEngine(seed=)`): on a CPU generator, so one seed gives
        the same weights on every device and mesh rank."""
        if mesh is not None and "dp" not in mesh.axis_names:
            raise ValueError(f"the engine shards pages over a 'dp' axis; the mesh has "
                             f"{mesh.axis_names}")
        self.mesh = mesh
        self.device = resolve_device(device if device is not None or mesh is None
                                     else str(mesh.device))
        self.config = config
        if config.decode_mode not in ("greedy", "beam", "nar"):
            raise ValueError(f"unknown decode_mode {config.decode_mode!r} "
                             f"('greedy', 'beam' or 'nar')")
        # Tiled pages take axis boxes whatever box_mode says (JAX's _crop_fn).
        self._axis_config = dataclasses.replace(config, box_mode="axis")
        for field in ("encoder_impl", "decode_impl"):
            if getattr(config, field) not in (None, "xla", "pallas"):
                raise NotImplementedError(
                    f"OcrConfig.{field}={getattr(config, field)!r} is not ported "
                    f"(None, 'xla' or 'pallas')")
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {config.compute_dtype!r}")
        self.dtype = _DTYPES[config.compute_dtype]

        stored_craft = stored_parseq = stored_charset = None
        if weights_dir:
            stored_craft, stored_parseq, stored_charset = W.load_configs(weights_dir)
        self.craft_config = craft_config or stored_craft or CraftConfig()
        self.parseq_config = parseq_config or stored_parseq or ParseqConfig(
            max_label_length=config.max_label_length)
        # Serving-level lowering overrides, applied to the resolved
        # ParseqConfig as the JAX engine does.
        impl = {k: getattr(config, k) for k in ("encoder_impl", "decode_impl")
                if getattr(config, k) is not None}
        if impl:
            self.parseq_config = dataclasses.replace(self.parseq_config, **impl)

        # Decode table: explicit charset > explicit reference_charset > the
        # charset stored with the weights > the standard table.
        charset = config.charset
        if charset is None and not config.reference_charset:
            charset = stored_charset
        if charset is not None:
            self.tokenizer = Tokenizer(charset=charset)
        else:
            self.tokenizer = Tokenizer(reference_charset=config.reference_charset)
        n_tokens = self.parseq_config.num_tokens
        bug_compat = charset is None and config.reference_charset
        ok = (self.tokenizer.vocab_size >= n_tokens) if bug_compat \
            else (self.tokenizer.vocab_size == n_tokens)
        if not ok:
            raise ValueError(
                f"tokenizer/recognizer mismatch: the recognizer head emits "
                f"{n_tokens} classes (ParseqConfig.charset_size="
                f"{self.parseq_config.charset_size}) but the resolved decode "
                f"table has {self.tokenizer.vocab_size} entries "
                f"({len(self.tokenizer.charset)} chars). Pass "
                f"OcrConfig(charset=...) matching the training charset")
        if tuple(self.parseq_config.img_size) != (config.rec_height, config.rec_width):
            raise ValueError(
                f"crop/recognizer geometry mismatch: OcrConfig rec_height/"
                f"rec_width = ({config.rec_height}, {config.rec_width}) but "
                f"the resolved ParseqConfig.img_size is "
                f"{tuple(self.parseq_config.img_size)}. Set OcrConfig("
                f"rec_width=...) to the recognizer's trained crop width")

        if weights_dir:
            craft_tree, parseq_tree = W.load_weights_dir(weights_dir)
        else:
            craft_tree, parseq_tree = random_trees(self.craft_config, self.parseq_config, seed)
            logger.warning("no weights_dir given: engine initialized with RANDOM weights "
                           "(transcripts will be meaningless; throughput is unaffected)")
        self.craft = Craft(self.craft_config)
        # int8 CRAFT folds its BatchNorms bit for bit as JAX does: its
        # weight scales and dynamic activation scales hang on those bits.
        self.craft.load_state_dict(craft_state_dict(craft_tree, self.craft_config.bn_eps,
                                                    xla_fold=config.quantized_serving))
        self.parseq = Parseq(self.parseq_config)
        self.parseq.load_state_dict(parseq_state_dict(parseq_tree))
        if config.quantized_serving:
            # From the fp32 weights, before the cast. The bf16 K6 encoder is
            # faster than an int8 one, so under encoder_impl="pallas" the
            # recognizer stays float, as in JAX.
            self.craft.quantize()
            if self.parseq_config.encoder_impl != "pallas":
                self.parseq.quantize()
            if self.device.type == "cuda":
                for _, q in self.craft.qconvs() + self.parseq.qlinears():
                    check_int8_shapes(q.cin, q.cout)
        self.parseq.prestack(self.dtype, self.device, config.decode_mode)
        for m in (self.craft, self.parseq):
            m.eval().requires_grad_(False)
            set_compute_dtype(m, self.dtype)
            m.to(self.device)
        self.weights_dir = weights_dir
        calib = os.path.join(weights_dir, W.CALIB_FILE) if weights_dir else ""
        if config.quantized_serving and os.path.isfile(calib):
            craft_sx, parseq_sx = W.load_calibration(calib)
            W.apply_static_scales(self.craft, craft_sx)
            if self.parseq.quantized:
                W.apply_static_scales(self.parseq, parseq_sx)
            # Else the recognizer's scales (saved under a quantized encoder)
            # do not apply: the encoder serves float here, as in JAX.
        self.last_timings: Dict[str, Any] = {}
        # Cumulative serving counters since construction or reset_stats().
        self.stats: Dict[str, float] = self._fresh_stats()
        # Batch geometry (b, h, w, c) -> the bucket last served for it: the
        # slab size `_dispatch` recognizes at before the box count is known.
        self._spec: Dict[Tuple[int, int, int, int], int] = {}
        self._closed = False

    # ------------------------------------------------------------------

    def run(self, image: np.ndarray, outputs_dir: Optional[str] = None) -> List[Dict]:
        """OCR one image [H, W, 3] uint8 RGB (or [H, W] gray) ->
        [{"text", "bbox": [x0, y0, x1, y1], "confidence"}]. `outputs_dir`
        is accepted for signature parity and ignored, as in the reference."""
        return self.run_pages(np.asarray(image)[None])[0]

    @staticmethod
    def _batch_geometry(images) -> Tuple[Any, int, int, int, int]:
        """[B,H,W,3] / [B,H,W,1] / [B,H,W] / [H,W,3] / [H,W] -> (images
        [B, H, W, C], b, h, w, channels), as the JAX package reads them. A
        torch.Tensor stays a tensor on its device (a view, no copy); any
        other input becomes a numpy array."""
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        if images.ndim == 2:
            images = images[None]
        if images.ndim == 3 and images.shape[-1] in (1, 3):
            images = images[None]
        if images.ndim == 3:
            images = images[..., None]
        if images.ndim != 4 or images.shape[-1] not in (1, 3):
            raise ValueError(
                f"expected an image batch [B, H, W, 3|1] (or [B, H, W] / "
                f"[H, W] grayscale, [H, W, 3] RGB), got {images.shape}")
        b, h, w, c = images.shape
        return images, b, h, w, c

    @staticmethod
    def _check_dtype(images) -> None:
        """Pixels must be uint8 0-255: a float image in [0, 1] would be
        divided by 255 again in canvas prep and give near-blank heatmaps."""
        ok = (images.dtype == torch.uint8 if isinstance(images, torch.Tensor)
              else images.dtype == np.uint8)
        if not ok:
            raise TypeError(
                f"image dtype must be uint8 (0-255), got {images.dtype}; scale and cast "
                f"float images with (img * 255).clip(0, 255).astype('uint8')")

    @staticmethod
    def _fresh_stats() -> Dict[str, float]:
        return {"pages": 0, "batches": 0, "boxes": 0,
                "detect_s": 0.0, "recognize_s": 0.0, "decode_s": 0.0,
                "spec_hits": 0, "spec_misses": 0, "spec_wasted": 0}

    def reset_stats(self) -> None:
        """Zero the cumulative serving counters (`engine.stats`)."""
        self.stats = self._fresh_stats()

    def _account(self, b: int) -> None:
        t, s = self.last_timings, self.stats
        s["pages"] += b
        s["batches"] += 1
        s["boxes"] += t["boxes"]
        for k in ("detect_s", "recognize_s", "decode_s"):
            s[k] += t[k]
        if t["speculative"]:
            # A speculative slab of a batch with no boxes was thrown away;
            # otherwise a fallback pass makes it a miss.
            if t["boxes"] == 0:
                s["spec_wasted"] += 1
            else:
                s["spec_misses" if t["spec_fallback"] else "spec_hits"] += 1

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                "OcrEngine is closed (close() was called or the engine was evicted "
                "from the get_engine cache); construct a new one")

    def _tiled(self, h: int, w: int) -> bool:
        """Whether a page of this size takes tiled detection."""
        cfg = self.config
        return cfg.tiled_detection and cfg.mag_ratio * max(h, w) > cfg.canvas_size

    def _rotated(self, h: int, w: int) -> bool:
        """Whether a page of this size gets rotated boxes ([K, 4, 2] rects)."""
        return self.config.box_mode == "rotated" and not self._tiled(h, w)

    def _bucket(self, count: int) -> int:
        for b in self.config.rec_buckets:
            if count <= b and b <= self.config.max_boxes:
                return b
        return self.config.max_boxes

    # ---- the dp mesh ----

    @property
    def dp_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size("dp")

    def _dp_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every dp rank's `t` [n, ...] concatenated in rank order."""
        from tuatara_tpu_torch.parallel.mesh import all_gather_cat

        return all_gather_cat(t, self.mesh.group("dp"))

    def _dp_max(self, stats: Dict[Any, float], layers) -> Dict[Any, float]:
        """Calibration stats {layer: abs-max} -> their max over the dp ranks
        (every rank saw the same layers)."""
        group = None if self.mesh is None else self.mesh.group("dp")
        if group is None or not stats:
            return stats
        keys = [q for q in layers if q in stats]
        vals = torch.tensor([stats[q] for q in keys], dtype=torch.float64, device=self.device)
        dist.all_reduce(vals, op=dist.ReduceOp.MAX, group=group)
        return dict(zip(keys, vals.tolist()))

    def _pad_pages(self, images, b: int):
        """Pad a page batch to a multiple of the dp size with copies of its
        last page: a copy raises no batch abs-max, so a dynamic int8 scale
        over the padded batch is the one over the pages sent."""
        extra = -b % self.dp_size
        if extra == 0:
            return images, b
        if isinstance(images, torch.Tensor):
            return torch.cat([images, images[-1:].expand(extra, *images.shape[1:])]), b + extra
        return np.concatenate([images, np.repeat(images[-1:], extra, axis=0)]), b + extra

    @torch.inference_mode()
    def detect(self, images: torch.Tensor, b_real: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
        """Device pages [B, H, W, C] uint8 -> per-slot bbox [B, K, 4], crop
        rects [B, K, 4] (rotated corners [B, K, 4, 2] where `_rotated`),
        valid [B, K] (valid first, raster order kept), count [B], and the
        heatmaps [B, h, w, 2].

        Under a mesh B is a multiple of the dp size (the whole batch on
        every rank), of which the first `b_real` (None: all) are pages and
        the rest padding (`_pad_pages`' copies of the last page): each rank
        detects its contiguous pages, and the outputs but the heatmaps
        (this rank's pages only) are gathered. Padding pages come back with
        no valid box, and being copies they leave every dynamic int8 scale
        as it is, so every page's result is the single engine's (JAX pads
        with blank pages, which can raise the abs-max: ROADMAP Queue 3)."""
        self._check_open()
        if self.mesh is None:
            return self._detect_pages(images)
        b, dp, r = images.shape[0], self.dp_size, self.mesh.rank("dp")
        if b % dp:
            raise ValueError(f"batch {b} does not divide over dp = {dp}")
        n = b // dp
        b_real = b if b_real is None else b_real
        det = self._detect_pages(images[r * n:(r + 1) * n])
        out = {k: self._dp_gather(det[k]) for k in ("bbox", "rects", "valid", "count")}
        if b_real < b:
            out["valid"][b_real:] = False
            out["count"][b_real:] = 0
        out["scores"] = det["scores"]
        return out

    def _detect_pages(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """`detect` on this rank's pages (a mesh's dynamic int8 scales span
        the pages of every rank)."""
        cfg = self.config
        b, h, w, c = images.shape
        if self._tiled(h, w):
            return self._detect_tiled(images)
        rotated = self._rotated(h, w)
        ratio = canvas_shape(h, w, cfg)[4]
        canvases = torch.stack([canvas_prep(images[i], cfg) for i in range(b)])
        if self.craft.quantized:
            # int8 sums are exact: a calibrated page's heatmap is the same
            # in any batch (dynamic scales span the batch, as in JAX).
            if self.mesh is None:
                scores, _ = self.craft(canvases)
            else:
                with L.amax_group(self.mesh.group("dp")):
                    scores, _ = self.craft(canvases)
        else:
            # cuDNN picks a float convolution's kernel by the batch size,
            # so a page's heatmap would depend on the pages beside it
            # (chip_smoke.py phase 3e measures it): one page at a time.
            scores = torch.cat([self.craft(canvases[i:i + 1])[0] for i in range(b)])
        content = content_mask(h, w, cfg, images.device)
        out = collections.defaultdict(list)
        for i in range(b):
            det = extract_boxes(scores[i, :, :, 0], scores[i, :, :, 1], content, cfg)
            if rotated:
                # bbox: the AABB of the rotated corners (tuatara.cpp:256-274);
                # the corners themselves go to the perspective crop.
                corners = scale_boxes(det["corners"], ratio, cfg)
                bbox = tesseract_bbox(torch.cat([corners.amin(1), corners.amax(1)], -1))
                self._add_page(out, det, bbox, corners)
            else:
                scaled = scale_boxes(det["boxes"], ratio, cfg)
                self._add_page(out, det, tesseract_bbox(scaled), crop_rects(scaled, h, w))
        res = {k: torch.stack(v) for k, v in out.items()}
        res["scores"] = scores
        return res

    @staticmethod
    def _add_page(out, det, bbox, rects) -> None:
        """Append one page's slots to `out`, valid slots first (stable)."""
        order = torch.argsort((~det["valid"]).to(torch.int8), stable=True)
        out["bbox"].append(bbox[order])
        out["rects"].append(rects[order])
        out["valid"].append(det["valid"][order])
        out["count"].append(det["count"])

    def _tiled_geometry(self, h: int, w: int, device) -> Tuple[int, int, int, int,
                                                               torch.Tensor]:
        """A tiled page's (th, tw) at magnification, its size padded to /32
        and to at least a tile (ph, pw), and the content mask of its
        stitched heatmap [ph / r, pw / r] (JAX `_build_tiled_detect`)."""
        cfg = self.config
        r, tile = cfg.ratio_net, cfg.canvas_size
        th, tw = int(h * cfg.mag_ratio), int(w * cfg.mag_ratio)
        ch, cw = pad32(th, cfg.size_multiple), pad32(tw, cfg.size_multiple)
        ph, pw = max(ch, tile), max(cw, tile)
        content = ((torch.arange(ph // r, device=device) < ch // r)[:, None]
                   & (torch.arange(pw // r, device=device) < cw // r)[None, :])
        return th, tw, ph, pw, content

    def _detect_tiled(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """`detect` for a page larger than the canvas (JAX
        `_build_tiled_detect`): the page at magnification, not shrunk to
        the canvas, cut into canvas-sized tiles with `tile_overlap`, one CRAFT
        batch per page (int8's dynamic scales then span that page's tiles,
        as under JAX's per-page vmap, and no page depends on another), the
        heatmaps max-blended, axis boxes at ratio = mag_ratio."""
        cfg = self.config
        b, h, w, c = images.shape
        r, tile = cfg.ratio_net, cfg.canvas_size
        th, tw, ph, pw, content = self._tiled_geometry(h, w, images.device)
        out = collections.defaultdict(list)
        stitched = []
        for i in range(b):
            x = resample(images[i], th, tw)
            x = torch.nn.functional.pad(x, (0, 0, 0, pw - tw, 0, ph - th))  # input dtype
            x = x.float() * INV_255
            if c == 1:  # gray: to three channels after the pad, no flip
                x = x.expand(ph, pw, 3)
            elif cfg.channel_mode == "python":
                x = x.flip(-1)
            tiles, coords = extract_tiles(x, tile, cfg.tile_overlap, r)
            scores, _ = self.craft(tiles.contiguous())
            heat = stitch_heatmaps(scores, coords, ph // r, pw // r, r)
            det = extract_boxes(heat[:, :, 0], heat[:, :, 1], content, self._axis_config)
            scaled = scale_boxes(det["boxes"], cfg.mag_ratio, cfg)
            self._add_page(out, det, tesseract_bbox(scaled), crop_rects(scaled, h, w))
            stitched.append(heat)
        res = {k: torch.stack(v) for k, v in out.items()}
        res["scores"] = torch.stack(stitched)
        return res

    def _crop_slab(self, images: torch.Tensor, rects: torch.Tensor, valid: torch.Tensor,
                   bucket: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The crops of the live boxes, padded to `bucket` rows (JAX
        `_crop_fn`) -> (crops [bucket, rec_h, rec_w, 3] in [0, 1], inv: the
        slab row of each live crop in (page, slot) raster order, or None
        when the slab is in that order already). Under a dp mesh, the crops
        of this rank's ceil(bucket / dp) rows only."""
        cfg = self.config
        b, k = valid.shape
        flat_valid = valid.reshape(-1)
        raster = torch.argsort((~flat_valid).to(torch.int8), stable=True)[:bucket]
        rotated = rects.dim() == 4
        if cfg.rec_sort_by_width:
            if rotated:
                # Long side over short side. XLA's CPU backend sums the
                # squares as fma(dy, dy, dx * dx): the sort sees its keys.
                q = rects.reshape(b * k, 4, 2)
                d1, d2 = q[:, 1] - q[:, 0], q[:, 2] - q[:, 1]
                e1 = fma(d1[:, 1], d1[:, 1], d1[:, 0] * d1[:, 0])
                e2 = fma(d2[:, 1], d2[:, 1], d2[:, 0] * d2[:, 0])
                aspect = torch.maximum(e1, e2) / torch.clamp(torch.minimum(e1, e2), min=1.0)
            else:
                r = rects.reshape(b * k, 4)
                aspect = (r[:, 2] - r[:, 0]) / torch.clamp(r[:, 3] - r[:, 1], min=1.0)
            key = torch.where(flat_valid, aspect, torch.full_like(aspect, float("inf")))
            order = torch.argsort(key, stable=True)[:bucket]
            rank = torch.zeros(b * k, dtype=torch.long, device=valid.device)
            rank[order] = torch.arange(bucket, device=valid.device)
            inv = rank[raster]
        else:
            order = raster
            inv = None
        if self.dp_size > 1:
            # This rank's contiguous rows of the slab (JAX's P("dp") layout);
            # the last rank's rows past the bucket repeat its last row.
            n = -(-bucket // self.dp_size)
            rows = torch.arange(self.mesh.rank("dp") * n, (self.mesh.rank("dp") + 1) * n,
                                device=order.device)
            order = order[rows.clamp(max=bucket - 1)]
        if rotated:
            crops = extract_crops_perspective_batched(
                images, order // k, rects.reshape(b * k, 4, 2)[order], cfg.rec_height,
                cfg.rec_width)
        else:
            crops = extract_crops_batched(images, order // k, rects.reshape(b * k, 4)[order],
                                          cfg.rec_height, cfg.rec_width)
        if crops.shape[-1] == 1:
            crops = crops.expand(-1, -1, -1, 3)
        if cfg.channel_mode == "cpp":
            crops = crops.flip(-1)
        return crops, inv

    @torch.inference_mode()
    def recognize_slab(self, images: torch.Tensor, rects: torch.Tensor,
                       valid: torch.Tensor, bucket: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Crops of the live boxes (padded to `bucket` rows) through PARSEQ
        under the configured decode mode. -> (ids [bucket, T], conf
        [bucket]) in (page, slot) raster order of the live boxes."""
        self._check_open()
        crops, inv = self._crop_slab(images, rects, valid, bucket)
        ids, conf = self.parseq.recognize(crops, self.config.decode_mode,
                                          self.config.beam_size)
        if self.dp_size > 1:
            ids, conf = self._dp_gather(ids)[:bucket], self._dp_gather(conf)[:bucket]
        if inv is not None:
            ids, conf = ids[inv], conf[inv]
        return ids, conf

    @torch.inference_mode()
    def calibrate(self, pages, margin: float = 1.1) -> int:
        """Freeze static int8 activation scales from sample pages (JAX
        `OcrEngine.calibrate`). `pages`: one batch or a list of batches, as
        `run_pages` takes them. Each batch runs through the int8 detector
        and, when the recognizer's encoder is int8 too, is detected (at the
        current scales), cropped at the largest bucket its boxes could
        fill, and encoded. Each quantized layer's input abs-max over the
        pages gives sx = 127 / (amax * margin); inputs beyond it saturate.
        Re-calibration replaces the scales. -> layers set.

        Under a dp mesh each batch pads to a dp multiple (`_pad_pages`), each
        rank runs its pages and its slab rows with dynamic scales over the
        whole batch and slab, as JAX's calibration forwards do, and the
        abs-maxes are reduced over dp. The padding copies raise no
        abs-max, and the slab's bucket is taken from the pages sent, so the
        scales are the single engine's."""
        self._check_open()
        cfg = self.config
        if not cfg.quantized_serving:
            raise ValueError("calibrate() requires OcrConfig(quantized_serving=True)")
        batches = pages if isinstance(pages, (list, tuple)) else [pages]
        craft_stats, rec_stats = [], []
        qconvs = [q for _, q in self.craft.qconvs()]
        qlinears = [q for _, q in self.parseq.qlinears()]
        group = None if self.mesh is None else self.mesh.group("dp")
        for batch in batches:
            images, b_real, _, _, _ = self._batch_geometry(batch)
            images, b = self._pad_pages(images, b_real)
            images_d = self._to_device(images)
            n, r = b // self.dp_size, 0 if self.mesh is None else self.mesh.rank("dp")
            canvases = torch.stack([canvas_prep(images_d[i], cfg)
                                    for i in range(r * n, (r + 1) * n)])
            with L.calibration() as seen, L.amax_group(group):
                self.craft(canvases)
            craft_stats.append(self._dp_max(dict(seen), qconvs))
            if self.parseq.quantized:
                det = self.detect(images_d, b_real)
                bucket = self._bucket(min(max(cfg.rec_buckets), b_real * cfg.max_boxes))
                crops, _ = self._crop_slab(images_d, det["rects"], det["valid"], bucket)
                with L.calibration() as seen, L.amax_group(group):
                    self.parseq.encode(crops)
                rec_stats.append(self._dp_max(dict(seen), qlinears))
        return (L.make_static_quant(L.merge_calib_stats(craft_stats), margin)
                + L.make_static_quant(L.merge_calib_stats(rec_stats), margin))

    def save_calibration(self, path: Optional[str] = None) -> str:
        """Write the calibrated scales to `path` (default: `calibration.npz`
        in the weights directory, which a later quantized engine loads at
        construction). -> the path. Raises if nothing is calibrated."""
        if path is None:
            if not self.weights_dir:
                raise ValueError("engine has no weights_dir; pass an explicit path")
            path = os.path.join(self.weights_dir, W.CALIB_FILE)
        if W.save_calibration(path, self.craft, self.parseq) == 0:
            raise ValueError("no calibrated scales to save: run engine.calibrate(pages) "
                             "first (requires quantized_serving=True)")
        return path

    def _to_device(self, images) -> torch.Tensor:
        if isinstance(images, torch.Tensor):
            return images.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(images)).to(self.device)

    def run_pages(self, images) -> List[List[Dict]]:
        """OCR a batch of same-sized pages [B, H, W, 3] uint8 RGB (or gray
        [B, H, W] / [B, H, W, 1]) -> one result list per page. A uint8
        torch.Tensor on the engine's device is used in place, with no host
        round trip (pair with `run_stream` to overlap uploads and result
        fetches with compute)."""
        self._check_open()
        return self._finalize(self._dispatch(images))

    def _dispatch(self, images) -> Dict[str, Any]:
        """Issue the device work of one page batch with no host read:
        detection, and when this geometry has served a bucket before, the
        crop + recognition slab at that bucket. -> the state `_finalize`
        takes."""
        images, b, h, w, c = self._batch_geometry(images)
        self._check_dtype(images)
        if 0 in images.shape:
            raise ValueError("empty image")
        b_real = b
        if self.mesh is not None:
            images, b = self._pad_pages(images, b)
        images_d = self._to_device(images)
        t0 = time.perf_counter()
        with record_function("tuatara_detect"):
            det = self.detect(images_d, b_real)
        # Keyed by the pages the caller sent: a mesh's padding changes no
        # slab, and a padded group does not share a smaller one's bucket.
        geometry = (b_real, h, w, c)
        spec = self._spec.get(geometry)
        rec = None
        if spec is not None:
            with record_function("tuatara_recognize"):
                rec = self._run_recognition(det, spec, images_d)
        return {"det": det, "rec": rec, "spec": spec, "images_d": images_d,
                "geometry": geometry, "t0": t0}

    def _run_recognition(self, det: Dict[str, torch.Tensor], bucket: int,
                         images_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.recognize_slab(images_d, det["rects"], det["valid"], bucket)

    def _fetch(self, tensors: List[torch.Tensor]) -> List[np.ndarray]:
        """Device tensors -> host arrays in one wait: on the card,
        non-blocking copies into pinned host tensors, then one event."""
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for dst, src in zip(host, tensors):
            dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return [t.numpy() for t in host]

    def _finalize(self, st: Dict[str, Any]) -> List[List[Dict]]:
        """Fetch and decode one dispatched batch (see `_dispatch`): a
        correctly sized recognition pass runs when there was no speculative
        slab or it held fewer rows than the batch's live boxes."""
        det, rec, spec, geometry = st["det"], st["rec"], st["spec"], st["geometry"]
        b = geometry[0]  # the pages sent, before a mesh's padding
        K = self.config.max_boxes
        with record_function("tuatara_fetch"):
            if rec is None:
                counts, bboxes = self._fetch([det["count"], det["bbox"]])
            else:
                counts, bboxes, ids, conf = self._fetch([det["count"], det["bbox"], *rec])
        t1 = time.perf_counter()
        spans = [int(n) for n in counts[:b]]  # a mesh's padding pages dropped
        total = sum(spans)
        results: List[List[Dict]] = [[] for _ in range(b)]
        if total == 0:
            self._spec.pop(geometry, None)
            self.last_timings = {"detect_s": t1 - st["t0"], "recognize_s": 0.0,
                                 "decode_s": 0.0, "speculative": rec is not None,
                                 "spec_fallback": False, "boxes": 0}
            self._account(b)
            return results
        # Totals past max_boxes round up to a multiple of rec_slab_multiple
        # (default max_boxes), clamped to the b * K rows the gather has.
        gran = self.config.rec_slab_multiple or K
        bucket = (self._bucket(total) if total <= K
                  else gran * ((total + gran - 1) // gran))
        bucket = min(max(bucket, self.config.rec_buckets[0]), b * K)
        fallback = spec is None or spec < total
        if fallback:
            with record_function("tuatara_recognize"):
                ids, conf = self._fetch(list(self._run_recognition(det, bucket,
                                                                   st["images_d"])))
        self._spec[geometry] = bucket
        t2 = time.perf_counter()
        with record_function("tuatara_decode"):
            texts = self.tokenizer.decode_ids(ids[:total])
            off = 0
            for i in range(b):
                for j in range(spans[i]):
                    results[i].append({
                        "text": texts[off + j],
                        "bbox": [float(v) for v in bboxes[i, j]],
                        "confidence": float(conf[off + j]),
                    })
                off += spans[i]
        # With a speculative slab, detect_s spans dispatch to the combined
        # fetch (detection and recognition both), and recognize_s only a
        # fallback pass.
        self.last_timings = {"detect_s": t1 - st["t0"], "recognize_s": t2 - t1,
                             "decode_s": time.perf_counter() - t2,
                             "speculative": rec is not None,
                             "spec_fallback": fallback and rec is not None, "boxes": total}
        self._account(b)
        return results

    def run_mixed(self, images, max_batch: int = 16, depth: int = 2) -> List[List[Dict]]:
        """OCR a list of pages of mixed sizes: pages are grouped by exact
        shape, run as batches of up to `max_batch` with `depth` dispatches
        in flight, and returned in the original order (equal to `run` on
        each page)."""
        self._check_open()
        groups: Dict[Tuple[int, ...], List[int]] = {}
        parsed = []
        for i, im in enumerate(images):
            im = im if isinstance(im, torch.Tensor) else np.asarray(im)
            parsed.append(im)
            groups.setdefault(tuple(im.shape), []).append(i)
        results: List[Optional[List[Dict]]] = [None] * len(parsed)
        pending: "collections.deque" = collections.deque()

        def finish():
            chunk, st = pending.popleft()
            for i, res in zip(chunk, self._finalize(st)):
                results[i] = res

        for idxs in groups.values():
            for start in range(0, len(idxs), max_batch):
                chunk = idxs[start:start + max_batch]
                stack = torch.stack if isinstance(parsed[chunk[0]], torch.Tensor) else np.stack
                pending.append((chunk, self._dispatch(stack([parsed[i] for i in chunk]))))
                if len(pending) > depth:
                    finish()
        while pending:
            finish()
        return results  # type: ignore[return-value]

    def run_stream(self, batches, prefetch: int = 2, depth: int = 1) -> List[List[List[Dict]]]:
        """OCR an iterable of same-shaped page batches, the serving loop.

        A producer thread uploads up to `prefetch` batches ahead: on the
        card it pins each one and copies it on a side stream, recording an
        event the compute stream waits on. The caller's thread launches all
        compute, keeping `depth` dispatched batches in flight, so a batch's
        result fetch waits behind the next batch's compute. -> per-batch
        results, in order. An error in `batches` is raised here."""
        self._check_open()
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
        slots: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        stop = threading.Event()
        end = object()

        def upload(batch):
            """-> (device batch, its copy's event or None, the pinned
            source, kept referenced until the batch is finalized)."""
            if isinstance(batch, torch.Tensor) and batch.device.type == self.device.type:
                return batch.to(self.device), None, None
            host = batch if isinstance(batch, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(batch))
            if not cuda:
                return host, None, None
            host = host.pin_memory()
            with torch.cuda.stream(copy_stream):
                dev = host.to(self.device, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(copy_stream)
            return dev, copied, host

        def producer():
            try:
                for batch in batches:
                    if stop.is_set():
                        return
                    slots.put(upload(batch))
            except BaseException as e:  # raised in the caller, not lost
                slots.put(e)
                return
            slots.put(end)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        out: List[List[List[Dict]]] = []
        pending: "collections.deque" = collections.deque()
        try:
            while True:
                item = slots.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                dev, copied, pinned = item
                if copied is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(copied)
                    dev.record_stream(compute)  # allocated on the copy stream
                st = self._dispatch(dev)
                st["pinned"] = pinned
                pending.append(st)
                if len(pending) > depth:
                    out.append(self._finalize(pending.popleft()))
            while pending:
                out.append(self._finalize(pending.popleft()))
        finally:
            stop.set()
            while thread.is_alive():  # unblock a producer waiting on a full queue
                try:
                    slots.get(timeout=0.01)
                except queue.Empty:
                    pass
            thread.join()
        return out

    def run_lines(self, image: np.ndarray, **group_kwargs) -> List[Dict]:
        """OCR one image -> lines in reading order, [{text, bbox, confidence,
        words}] (`ops/grouping.group_lines`; JAX `OcrEngine.run_lines`)."""
        return group_lines(self.run(image), **group_kwargs)

    def run_blocks(self, image: np.ndarray, **group_kwargs) -> List[Dict]:
        """OCR one image -> blocks of lines, [{text, bbox, confidence,
        lines}] (`ops/grouping.group_blocks` over `run_lines`)."""
        return group_blocks(self.run_lines(image), **group_kwargs)

    @torch.inference_mode()
    def warmup(self, h: int, w: int, batch: int = 1, channels: int = 3) -> None:
        """Prepare the serving path for a page shape: on the card, build the
        CUDA kernels; run a blank batch through `run_pages` (it detects no
        boxes) and the crop + recognition slab at the smallest bucket."""
        self._check_open()
        if self.device.type == "cuda":
            from tuatara_tpu_torch.kernels._build import build_all

            build_all()
        blank = np.zeros((batch, h, w, channels), np.uint8)
        self.run_pages(blank)
        K = self.config.max_boxes
        # Rotated corners or axis windows, as this page size gets them.
        shape = (batch, K, 4, 2) if self._rotated(h, w) else (batch, K, 4)
        rects = torch.zeros(shape, device=self.device)
        valid = torch.zeros(batch, K, dtype=torch.bool, device=self.device)
        self._fetch(list(self.recognize_slab(self._to_device(blank), rects, valid,
                                             self._bucket(1))))

    def close(self) -> None:
        """Drop the engine's models and device tensors. Every later call
        raises RuntimeError. Idempotent."""
        self.craft = None
        self.parseq = None
        self._spec.clear()
        self._closed = True


_engines: "collections.OrderedDict[Any, OcrEngine]" = collections.OrderedDict()
ENGINE_CACHE_MAX = 4


def get_engine(config: OcrConfig = DEFAULT_CONFIG, weights_dir: Optional[str] = None,
               device: Optional[str] = None) -> OcrEngine:
    """Process-wide engine cache keyed by (config, weights_dir, device). Past
    ENGINE_CACHE_MAX engines the least recently used one is evicted and
    closed, even if a caller still holds it: later calls on it raise."""
    key = (config, weights_dir or "", str(resolve_device(device)))
    eng = _engines.get(key)
    if eng is None:
        eng = OcrEngine(config, weights_dir=weights_dir, device=device)
        _engines[key] = eng
        while len(_engines) > ENGINE_CACHE_MAX:
            _engines.popitem(last=False)[1].close()
    else:
        _engines.move_to_end(key)
    return eng


def clear_engines() -> None:
    """Close and drop every cached engine."""
    while _engines:
        _engines.popitem(last=False)[1].close()


def image_to_data(image: np.ndarray, weights_dir: Optional[str] = None,
                  outputs_dir: Optional[str] = None, config: OcrConfig = DEFAULT_CONFIG,
                  device: Optional[str] = None) -> List[Dict]:
    """Text and boxes of one image: 3-D uint8 RGB array in, list of
    {text, bbox, confidence} out (the reference's `pytuatara.image_to_data`
    contract). Engines are cached per (config, weights_dir, device)."""
    image = np.asarray(image)
    if image.ndim != 3:
        raise ValueError("Input array should have 3 dimensions")
    return get_engine(config, weights_dir, device).run(image, outputs_dir)
