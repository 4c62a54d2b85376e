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
4. PARSEQ, the sequence confidence (product of per-step max probability up
   to and including the first EOS), and the tokenizer on the host. With
   `encoder_impl` / `decode_impl` "pallas" at bf16 (the `latency()` preset)
   the encoder blocks and the greedy decode run as the fused CUDA kernels
   K6 and K7, their weight bundles stacked once at construction.

With `quantized_serving` (the `production()` preset) CRAFT serves int8
(`Craft.quantize`, after the weights load, as the JAX engine quantizes its
detector): its convolutions but conv1_1 and the head's 1x1s are int8 x int8
-> int32 GEMMs (`kernels/int8.py`). Activation scales are dynamic until
`OcrEngine.calibrate(pages)` freezes static ones, or a `calibration.npz`
beside the weights (`save_calibration`) supplies them at construction.

`run_pages` is `_finalize(_dispatch(images))`, as in the JAX engine:
`_dispatch` issues detection and, when the batch geometry has served a
bucket before, the crop + recognition slab at that bucket (speculative
recognition), with no host read; `_finalize` fetches the counts, boxes and
recognition results in one copy and runs a correctly sized recognition pass
only when the speculation fell short. `run_stream` pipelines batches over
that split (uploads on a side stream from a producer thread, `depth`
dispatches in flight), `run_mixed` groups pages of mixed sizes, and
`engine.stats` accumulates the serving counters.

Models load once per engine and stay on the device. The engine runs on the
card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tuatara_tpu_torch.config import DEFAULT_CONFIG, CraftConfig, OcrConfig, ParseqConfig
from tuatara_tpu_torch.kernels.int8 import check_shapes as check_int8_shapes
from tuatara_tpu_torch.models import layers as L
from tuatara_tpu_torch.models.craft import Craft
from tuatara_tpu_torch.models.layers import set_compute_dtype
from tuatara_tpu_torch.models.parseq import Parseq, confidence
from tuatara_tpu_torch.ops.boxes import extract_boxes, scale_boxes, tesseract_bbox
from tuatara_tpu_torch.ops.minarearect import fma
from tuatara_tpu_torch.ops.resize import canvas_prep, canvas_shape, pad32, resample
from tuatara_tpu_torch.ops.tiling import extract_tiles, stitch_heatmaps
from tuatara_tpu_torch.ops.warp import (crop_rects, extract_crops_batched,
                                        extract_crops_perspective_batched)
from tuatara_tpu_torch.tokenizer import Tokenizer
from tuatara_tpu_torch.utils import weights as W
from tuatara_tpu_torch.weights import craft_state_dict, parseq_state_dict

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
                 weights_dir: Optional[str] = None, device: Optional[str] = None):
        self.device = resolve_device(device)
        self.config = config
        if config.decode_mode != "greedy":
            raise NotImplementedError(
                f"OcrConfig.decode_mode={config.decode_mode!r} is not ported yet "
                f"(only 'greedy'; see ROADMAP.md)")
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
        if config.quantized_serving and self.parseq_config.encoder_impl != "pallas":
            # JAX quantizes the recognizer encoder too under this pairing.
            raise NotImplementedError(
                "quantized_serving with encoder_impl != 'pallas' serves an int8 "
                "recognizer encoder, which is not ported yet (ROADMAP.md Queue 1); "
                "use OcrConfig.production() or encoder_impl='pallas'")

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

        if not weights_dir:
            raise ValueError("weights_dir is required: the port has no random "
                             "initialisation (e.g. evals/production_weights)")
        craft_tree, parseq_tree = W.load_weights_dir(weights_dir)
        self.craft = Craft(self.craft_config)
        self.craft.load_state_dict(craft_state_dict(craft_tree, self.craft_config.bn_eps))
        self.parseq = Parseq(self.parseq_config)
        self.parseq.load_state_dict(parseq_state_dict(parseq_tree))
        self.parseq.prestack(self.dtype, self.device)  # fp32 weights, before the cast
        if config.quantized_serving:
            self.craft.quantize()  # from the fp32 folded weights, before the cast
            if self.device.type == "cuda":
                for _, q in self.craft.qconvs():
                    check_int8_shapes(q.cin, q.cout)
        for m in (self.craft, self.parseq):
            m.eval().requires_grad_(False)
            set_compute_dtype(m, self.dtype)
            m.to(self.device)
        self.weights_dir = weights_dir
        calib = os.path.join(weights_dir, W.CALIB_FILE)
        if config.quantized_serving and os.path.isfile(calib):
            # The recognizer's scales (saved under a quantized encoder) do
            # not apply: the encoder serves bf16 here, as in JAX.
            W.apply_static_scales(self.craft, W.load_calibration(calib)[0])
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

    @torch.inference_mode()
    def detect(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Device pages [B, H, W, C] uint8 -> per-slot bbox [B, K, 4], crop
        rects [B, K, 4] (rotated corners [B, K, 4, 2] where `_rotated`),
        valid [B, K] (valid first, raster order kept), count [B], and the
        heatmaps [B, h, w, 2]."""
        self._check_open()
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
            x = x.float() / 255.0
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

    @torch.inference_mode()
    def recognize_slab(self, images: torch.Tensor, rects: torch.Tensor,
                       valid: torch.Tensor, bucket: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Crops of the live boxes (padded to `bucket` rows) through PARSEQ.
        -> (ids [bucket, T], conf [bucket]) in (page, slot) raster order of
        the live boxes."""
        self._check_open()
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
        ids, conf = confidence(self.parseq(crops))
        if inv is not None:
            ids, conf = ids[inv], conf[inv]
        return ids, conf

    @torch.inference_mode()
    def calibrate(self, pages, margin: float = 1.1) -> int:
        """Freeze static int8 activation scales from sample pages (JAX
        `OcrEngine.calibrate`, detector layers only: the encoder is not
        quantized here). `pages`: one batch or a list of batches, as
        `run_pages` takes them. Each quantized layer's input abs-max over
        the pages gives sx = 127 / (amax * margin); inputs beyond it
        saturate. Re-calibration replaces the scales. -> layers set."""
        self._check_open()
        if not self.config.quantized_serving:
            raise ValueError("calibrate() requires OcrConfig(quantized_serving=True)")
        batches = pages if isinstance(pages, (list, tuple)) else [pages]
        stats = []
        for batch in batches:
            images, b, _, _, _ = self._batch_geometry(batch)
            images_d = self._to_device(images)
            canvases = torch.stack([canvas_prep(images_d[i], self.config) for i in range(b)])
            with L.calibration() as seen:
                self.craft(canvases)
            stats.append(dict(seen))
        return L.make_static_quant(L.merge_calib_stats(stats), margin)

    def save_calibration(self, path: Optional[str] = None) -> str:
        """Write the calibrated scales to `path` (default: `calibration.npz`
        in the weights directory, which a later quantized engine loads at
        construction). -> the path. Raises if nothing is calibrated."""
        if path is None:
            path = os.path.join(self.weights_dir, W.CALIB_FILE)
        if W.save_calibration(path, self.craft) == 0:
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
        images_d = self._to_device(images)
        t0 = time.perf_counter()
        det = self.detect(images_d)
        geometry = (b, h, w, c)
        spec = self._spec.get(geometry)
        rec = None if spec is None else self._run_recognition(det, spec, images_d)
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
        b = geometry[0]
        K = self.config.max_boxes
        if rec is None:
            counts, bboxes = self._fetch([det["count"], det["bbox"]])
        else:
            counts, bboxes, ids, conf = self._fetch([det["count"], det["bbox"], *rec])
        t1 = time.perf_counter()
        spans = [int(n) for n in counts]
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
            ids, conf = self._fetch(list(self._run_recognition(det, bucket, st["images_d"])))
        self._spec[geometry] = bucket
        t2 = time.perf_counter()
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
