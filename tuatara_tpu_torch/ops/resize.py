"""Detection canvas: aspect-preserving resize + zero pad.

Port of `tuatara_tpu/ops/resize.py` and `api._canvas_prep`. Geometry follows
the reference's `resize_aspect_ratio` (tuatara.cpp:206-234): the long side
scales to `mag_ratio * max(h, w)` capped at `canvas_size`, target dims are
truncated to int, and the content is padded to a multiple of 32; the canvas
then rounds up to `canvas_bucket`. The resample is bilinear with half-pixel
centres and, when it shrinks the page, antialiased (a triangle filter
widened by the scale), as `jax.image.resize` does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tuatara_tpu_torch.config import OcrConfig


def resize_geometry(h: int, w: int, cfg: OcrConfig) -> Tuple[int, int, float]:
    """(target_h, target_w, ratio) per tuatara.cpp:211-220."""
    target_size = cfg.mag_ratio * max(h, w)
    if target_size > cfg.canvas_size:
        target_size = float(cfg.canvas_size)
    ratio = target_size / max(h, w)
    return int(h * ratio), int(w * ratio), ratio


def pad32(n: int, multiple: int = 32) -> int:
    return n if n % multiple == 0 else n + (multiple - n % multiple)


def canvas_shape(h: int, w: int, cfg: OcrConfig) -> Tuple[int, int, int, int, float]:
    """-> (canvas_h, canvas_w, content_h, content_w, ratio)."""
    th, tw, ratio = resize_geometry(h, w, cfg)
    ch, cw = pad32(th, cfg.size_multiple), pad32(tw, cfg.size_multiple)
    c = cfg.canvas_size
    if ch > c or cw > c:
        raise ValueError(f"content {ch}x{cw} exceeds canvas {c}")
    b = cfg.canvas_bucket
    if b:
        canvas_h = min(pad32(ch, b), c)
        canvas_w = min(pad32(cw, b), c)
    else:
        canvas_h = canvas_w = c
    return canvas_h, canvas_w, ch, cw, ratio


def resample(image: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """[H, W, C] -> fp32 [th, tw, C], or the page itself when the size
    does not change (as JAX skips the identity resize)."""
    h, w = image.shape[:2]
    if (th, tw) == (h, w):
        return image
    x = F.interpolate(image.float().permute(2, 0, 1)[None], size=(th, tw),
                      mode="bilinear", align_corners=False, antialias=True)
    return x[0].permute(1, 2, 0)


def detect_canvas(image: torch.Tensor, cfg: OcrConfig
                  ) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """uint8/float [H, W, C] -> (fp32 canvas [1, CH, CW, C] in [0, 1], ratio,
    (content_h, content_w))."""
    h, w, c = image.shape
    canvas_h, canvas_w, ch, cw, ratio = canvas_shape(h, w, cfg)
    th, tw, _ = resize_geometry(h, w, cfg)
    x = resample(image, th, tw)
    x = F.pad(x.float(), (0, 0, 0, canvas_w - tw, 0, canvas_h - th))
    return (x / 255.0)[None], ratio, (ch, cw)


def canvas_prep(image: torch.Tensor, cfg: OcrConfig) -> torch.Tensor:
    """One page [H, W, C] -> detector canvas [CH, CW, C] (port of
    `api._canvas_prep`). With channel_mode "python" an RGB page is flipped
    to BGR (the reference swaps channels before CRAFT, tuatara.cpp:349); a
    gray page [H, W, 1] stays single-channel."""
    canvas, _, _ = detect_canvas(image, cfg)
    if image.shape[-1] != 1 and cfg.channel_mode == "python":
        canvas = canvas.flip(-1)
    return canvas[0]
