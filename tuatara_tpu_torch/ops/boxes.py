"""CRAFT heatmaps -> text boxes (axis-aligned mode).

Port of `tuatara_tpu/ops/boxes.py extract_boxes`, itself a rebuild of the
reference's `get_detected_boxes` (tuatara.cpp:119-204):

1. min-max normalize the region/affinity maps over the content extent,
   binarize (strictly greater, cv::THRESH_BINARY) at `low_text` /
   `link_threshold`, and take their union inside the content mask;
2. label 4-connected components. When `text_threshold >= low_text` (the
   default) every "hot" pixel (tn >= text_threshold) is also a keep pixel,
   and the smallest index of each component's hot pixels rides the
   labeling — kernel K1. Otherwise the labels come alone — kernel K4;
3. area filter — kernel K2 for 1 <= min_component_area <= 16 (JAX's gate),
   else the plain area count; then the K smallest roots of the components
   that pass it and hold a hot pixel (and, on the K4 branch, a keep pixel);
4. per-root row/column counts for the full and the reduced (link-only
   pixels removed) pixel sets — kernel K3; on the K4 branch also each
   component's peak tn — kernel K5 — and components whose peak is below
   `text_threshold` are dropped;
5. extents of the reduced set grown by the reference's dilation radius,
   clamped to the content — the square dilation applied in box space.

On CUDA tensors steps 2-4 run the CUDA kernels, on CPU tensors their plain
versions; everything else is the same PyTorch code on both.
"""

from __future__ import annotations

from typing import Dict

import torch

from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.kernels.cc import (MIN_AREA_RANGE, area_ok, label_components,
                                          label_components_aux)
from tuatara_tpu_torch.kernels.stats import component_stats, component_stats_nopeak
from tuatara_tpu_torch.ops import connected_components as plain
from tuatara_tpu_torch.ops.connected_components import BIG, component_roots_filtered

_INF = 1e30


def _normalize(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mn = torch.where(mask, x, torch.full_like(x, _INF)).min()
    mx = torch.where(mask, x, torch.full_like(x, -_INF)).max()
    return (x - mn) / torch.clamp(mx - mn, min=1e-12)


def _niter(area: torch.Tensor, w: torch.Tensor, h: torch.Tensor, mode: str) -> torch.Tensor:
    """Dilation radius (tuatara.cpp:166). "reference" keeps the C++ integer
    division inside the sqrt; "upstream" is the CRAFT repo's float math."""
    minwh = torch.minimum(w, h)
    if mode == "reference":
        q = torch.div(area * minwh, torch.clamp(w * h, min=1), rounding_mode="floor")
        return torch.sqrt((q * 2).float()).to(torch.int32)
    q = area.float() * minwh / torch.clamp(w * h, min=1)
    return (torch.sqrt(q) * 2).to(torch.int32)


def _extent(present: torch.Tensor, size: int):
    """(first, last) set index per column of a [size, K] boolean profile
    (size and -1 for an empty column)."""
    pos = torch.arange(size, dtype=torch.int32, device=present.device)[:, None]
    first = torch.where(present, pos, torch.full_like(pos, size)).amin(0)
    last = torch.where(present, pos, torch.full_like(pos, -1)).amax(0)
    return first, last


def _area_ok(labels: torch.Tensor, min_area: int) -> torch.Tensor:
    """K2 where its window applies (1 <= min_area <= 16, JAX's gate), else
    the plain area count, as JAX's XLA path."""
    lo, hi = MIN_AREA_RANGE
    if lo <= min_area <= hi:
        return area_ok(labels, min_area)
    return plain.area_ok(labels, min_area)


def binarize(textmap: torch.Tensor, linkmap: torch.Tensor, content_mask: torch.Tensor,
             cfg: OcrConfig):
    """-> (comb, keep, hot) [H, W] bool and tn [H, W] fp32: the component
    mask (region or link above threshold, inside the content), the reduced
    set (not link-only, tuatara.cpp:160), the hot pixels (normalized region
    score >= text_threshold, the reference's per-component minMaxLoc test)
    and that normalized region score."""
    tn = _normalize(textmap, content_mask)
    ln = _normalize(linkmap, content_mask)
    text_bin = (tn > cfg.low_text) & content_mask
    link_bin = (ln > cfg.link_threshold) & content_mask
    comb = text_bin | link_bin
    keep = ~(link_bin & ~text_bin)
    hot = (tn >= cfg.text_threshold) & content_mask
    return comb, keep, hot, tn


def extract_boxes(textmap: torch.Tensor, linkmap: torch.Tensor,
                  content_mask: torch.Tensor, cfg: OcrConfig) -> Dict[str, torch.Tensor]:
    """Heatmaps [H, W] fp32 + content mask [H, W] bool -> K = max_boxes
    slots: boxes [K, 4] fp32 (x0, y0, x1, y1 inclusive heatmap pixels,
    dilated), valid [K] bool, count (scalar), num_components (scalar).
    Invalid slots hold zero boxes."""
    if cfg.box_mode != "axis":
        raise NotImplementedError("box_mode='rotated' is not ported yet")
    H, W = textmap.shape
    K = cfg.max_boxes
    comb, keep, hot, tn = (m.contiguous() for m in binarize(textmap, linkmap, content_mask, cfg))

    if cfg.text_threshold >= cfg.low_text:
        # hot implies keep: hot presence rides the labeling (K1), and every
        # selected root already holds a pixel >= text_threshold, so the
        # peak is not needed (K3).
        labels, hot_min = label_components_aux(comb, hot)
        ok_map = _area_ok(labels, cfg.min_component_area)
        roots, ncomp = component_roots_filtered(labels, K, hot_min, ok_map)
        row_cnt, col_cnt, rrow_cnt, rcol_cnt = component_stats_nopeak(labels, keep, roots)
        peak = None
    else:
        labels = label_components(comb)
        ok_map = _area_ok(labels, cfg.min_component_area)
        roots, ncomp = component_roots_filtered(labels, K, None, ok_map, hot=hot, keep=keep)
        row_cnt, col_cnt, rrow_cnt, rcol_cnt, peak = component_stats(
            labels, tn, keep, roots)

    area = row_cnt.sum(0)
    rcount = rrow_cnt.sum(0)
    t, b = _extent(row_cnt > 0, H)
    l, r = _extent(col_cnt > 0, W)
    rt, rb = _extent(rrow_cnt > 0, H)
    rl, rr = _extent(rcol_cnt > 0, W)

    niter = _niter(area.to(torch.int32), r - l + 1, b - t + 1, cfg.niter_mode)
    # OpenCV dilate with a (1+niter)^2 kernel and centre anchor grows a set by
    # niter//2 left/top and (niter+1)//2 right/bottom.
    grow_lt = torch.div(niter, 2, rounding_mode="floor")
    grow_rb = torch.div(niter + 1, 2, rounding_mode="floor")

    ar_w = torch.arange(W, dtype=torch.int32, device=textmap.device)
    ar_h = torch.arange(H, dtype=torch.int32, device=textmap.device)
    cw = torch.where(content_mask.any(0), ar_w, torch.full_like(ar_w, -1)).max() + 1
    ch = torch.where(content_mask.any(1), ar_h, torch.full_like(ar_h, -1)).max() + 1

    x0 = torch.clamp(rl - grow_lt, min=0)
    y0 = torch.clamp(rt - grow_lt, min=0)
    x1 = torch.minimum(rr + grow_rb, cw - 1)
    y1 = torch.minimum(rb + grow_rb, ch - 1)

    valid = (area >= cfg.min_component_area) & (rcount > 0) & (roots < BIG)
    if peak is not None:
        valid &= peak >= cfg.text_threshold
    boxes = torch.stack([x0, y0, x1, y1], dim=-1).float()
    boxes = torch.where(valid[:, None], boxes, torch.zeros_like(boxes))
    return {
        "boxes": boxes,
        "valid": valid,
        "count": valid.sum(),
        "num_components": ncomp,
    }


def scale_boxes(boxes: torch.Tensor, ratio: float, cfg: OcrConfig) -> torch.Tensor:
    """Heatmap coords -> original-image coords (tuatara.cpp:236-253)."""
    return boxes * (cfg.ratio_net / ratio)


def tesseract_bbox(scaled_boxes: torch.Tensor) -> torch.Tensor:
    """Public bbox: floor(x + 0.5), std::round for the non-negative
    coordinates here (tuatara.cpp:256-274)."""
    return torch.floor(scaled_boxes + 0.5)
