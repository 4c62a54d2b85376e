"""Recognition crops: crop + resize as one bilinear sample.

Port of `tuatara_tpu/ops/warp.py` (`crop_rects`, `_sample_coords`,
`extract_crops_batched`, and for rotated boxes `_quad_sample_points` and
`extract_crops_perspective_batched`). The reference crops each box's bounding rect
(tuatara.cpp:409-418) and resizes it to 128x32 (tuatara.cpp:438-448); here
both are one sample per output pixel, cv::resize INTER_LINEAR's half-pixel
convention, src = x0 + (j + 0.5) * w_box / out_w - 0.5, clamped to the crop
window (the window itself clamped to the image), then /255 (as XLA compiles
it, a product with fp32(1/255): `ops.resize.INV_255`).

Bilinear weights are computed as max(0, 1 - |src - tap|) for the two taps,
the form the JAX package's column product uses.
"""

from __future__ import annotations

import torch

from tuatara_tpu_torch.ops.minarearect import fma
from tuatara_tpu_torch.ops.resize import INV_255


def crop_rects(scaled_boxes: torch.Tensor, img_h: int, img_w: int) -> torch.Tensor:
    """Float boxes (x0, y0, x1, y1) -> crop windows, boundingRect style
    (floor(min), exclusive ceil(max) + 1), clamped to the image."""
    x0 = torch.clamp(torch.floor(scaled_boxes[:, 0]), 0, img_w - 1)
    y0 = torch.clamp(torch.floor(scaled_boxes[:, 1]), 0, img_h - 1)
    x1 = torch.minimum(torch.maximum(torch.ceil(scaled_boxes[:, 2]) + 1, x0 + 1),
                       torch.full_like(x0, img_w))
    y1 = torch.minimum(torch.maximum(torch.ceil(scaled_boxes[:, 3]) + 1, y0 + 1),
                       torch.full_like(y0, img_h))
    return torch.stack([x0, y0, x1, y1], dim=-1)


def _sample_coords(rects: torch.Tensor, out_h: int, out_w: int):
    """Half-pixel source coordinates per crop, clamped to the crop window:
    sx [K, out_w], sy [K, out_h]."""
    x0, y0, x1, y1 = rects[:, 0], rects[:, 1], rects[:, 2], rects[:, 3]
    jj = (torch.arange(out_w, dtype=torch.float32, device=rects.device) + 0.5) / out_w
    ii = (torch.arange(out_h, dtype=torch.float32, device=rects.device) + 0.5) / out_h
    sx = x0[:, None] + jj[None, :] * (x1 - x0)[:, None] - 0.5
    sy = y0[:, None] + ii[None, :] * (y1 - y0)[:, None] - 0.5
    sx = torch.minimum(torch.maximum(sx, x0[:, None]), (x1 - 1.0)[:, None])
    sy = torch.minimum(torch.maximum(sy, y0[:, None]), (y1 - 1.0)[:, None])
    return sx, sy


def extract_crops_batched(images: torch.Tensor, page: torch.Tensor, rects: torch.Tensor,
                          out_h: int = 32, out_w: int = 128) -> torch.Tensor:
    """images [B, H, W, C] (uint8 or float, 0..255), source page per crop
    [K], rects [K, 4] -> crops [K, out_h, out_w, C] fp32 in [0, 1]."""
    B, H, W, C = images.shape
    sx, sy = _sample_coords(rects, out_h, out_w)

    fy = (sy - torch.floor(sy))[..., None, None]                  # [K, oh, 1, 1]
    y0 = torch.floor(sy).long().clamp(0, H - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    flat = images.reshape(B * H, W, C)
    base = page.long()[:, None] * H
    top = flat[base + y0].float()                                 # [K, oh, W, C]
    bot = flat[base + y1].float()
    rows = top * (1.0 - fy) + bot * fy

    xa = torch.floor(sx)
    xb = xa + 1.0
    wa = torch.clamp(1.0 - torch.abs(sx - xa), min=0.0)           # [K, ow]
    wb = torch.clamp(1.0 - torch.abs(sx - xb), min=0.0)
    ia = xa.long().clamp(0, W - 1)
    ib_valid = xb < W
    ib = xb.long().clamp(0, W - 1)
    wb = torch.where(ib_valid, wb, torch.zeros_like(wb))
    k, oh = rows.shape[:2]
    ga = torch.gather(rows, 2, ia[:, None, :, None].expand(k, oh, out_w, C))
    gb = torch.gather(rows, 2, ib[:, None, :, None].expand(k, oh, out_w, C))
    out = ga * wa[:, None, :, None] + gb * wb[:, None, :, None]
    return out * INV_255


def _lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a * (1 - t) + b * t with the first product fused into the sum, as
    XLA's CPU backend computes one lerp. In the nested lerps of a quad its
    choice was not pinned down; this form keeps crops within ~1e-7 of
    JAX's (rounding both products: ~1e-5)."""
    return fma(a, 1 - t, b * t)


def _quad_sample_points(corners: torch.Tensor, out_h: int, out_w: int):
    """Source coordinates of every output pixel of a quad's crop: corners
    [K, 4, 2] (tl, tr, br, bl) -> (sx, sy) [K, out_h, out_w]. Bilinear in
    the quad's edges, which for a parallelogram (every rotated rectangle)
    is the projective warp itself."""
    dev = corners.device
    u = ((torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w)[None, None, :,
                                                                              None]
    v = ((torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h)[None, :, None,
                                                                              None]
    tl, tr, br, bl = (corners[:, i][:, None, None, :] for i in range(4))
    pts = _lerp(_lerp(tl, tr, u), _lerp(bl, br, u), v)          # [K, out_h, out_w, 2]
    return pts[..., 0], pts[..., 1]


def extract_crops_perspective_batched(images: torch.Tensor, page: torch.Tensor,
                                      corners: torch.Tensor, out_h: int = 32,
                                      out_w: int = 128) -> torch.Tensor:
    """Rectified crops of rotated boxes, sampled straight from the page
    batch: images [B, H, W, C] (uint8 or float, 0..255), source page per
    crop [K], corners [K, 4, 2] -> crops [K, out_h, out_w, C] fp32 in
    [0, 1]. Each output pixel gathers its four bilinear taps from the
    flat batch at the crop's page offset, in the source dtype; no page is
    copied per crop."""
    B, H, W, C = images.shape
    K = corners.shape[0]
    sx, sy = _quad_sample_points(corners, out_h, out_w)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]
    x0 = x0.long().clamp(0, W - 1)
    y0 = y0.long().clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    flat = images.reshape(B * H * W, C)
    base = page.long()[:, None, None] * H

    def at(yy, xx):
        return flat[((base + yy) * W + xx).reshape(-1)].reshape(K, out_h, out_w, C).float()

    top = _lerp(at(y0, x0), at(y0, x1), wx)
    bot = _lerp(at(y1, x0), at(y1, x1), wx)
    return _lerp(top, bot, wy) * INV_255
