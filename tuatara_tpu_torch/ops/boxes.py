"""CRAFT heatmaps -> text boxes, axis-aligned or rotated.

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
   clamped to the content — the square dilation applied in box space;
6. with `box_mode="rotated"`, a rotated rectangle per component: by default
   the exact minimum-area rectangle of the dilated, clipped reduced set
   (`ops/minarearect.py`, with the hull kernel H1), falling back per
   component to the PCA fit, or the PCA fit alone (`rotated_fit="pca"`).
   Membership is each pixel's slot among the selected roots, from the same
   labels and roots that feed K3/K5.

On CUDA tensors steps 2-4 and the hull run the CUDA kernels, on CPU
tensors their plain versions; everything else is the same PyTorch code on
both.
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
from tuatara_tpu_torch.ops.minarearect import (component_slots, fma,
                                               min_area_rect_from_profiles, row_profiles,
                                               SPARE_CELLS, spare_cells)

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
    dilated), corners [K, 4, 2] fp32 (the rotated rectangle in "rotated"
    mode, the box's corners in "axis" mode), valid [K] bool, count
    (scalar), num_components (scalar). Invalid slots keep what their
    component (or its absence) gives, as in JAX: the recognition slab
    crops them as its padding rows, and under dynamic int8 scales those
    rows take part in the abs-max."""
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
    if cfg.box_mode == "rotated":
        slots = component_slots(labels, roots)
        slots = torch.where(keep, slots, torch.full_like(slots, K))  # the reduced set
        corners = _pca_corners(slots, K, grow_lt, grow_rb, boxes)
        if cfg.rotated_fit == "exact":
            exact, exact_ok = min_area_rect_from_profiles(
                *row_profiles(slots, K), grow_lt, grow_rb, cw, ch)
            corners = torch.where(exact_ok[:, None, None], exact, corners)
    else:
        corners = _aabb_corners(boxes)
    return {
        "boxes": boxes,
        "corners": corners,
        "valid": valid,
        "count": valid.sum(),
        "num_components": ncomp,
    }


def _aabb_corners(boxes: torch.Tensor) -> torch.Tensor:
    """[K, 4] (x0, y0, x1, y1) -> [K, 4, 2]: tl, tr, br, bl."""
    x0, y0, x1, y1 = boxes.unbind(1)
    return torch.stack([x0, y0, x1, y0, x1, y1, x0, y1], dim=1).view(-1, 4, 2)


def _pca_corners(slots: torch.Tensor, K: int, grow_lt: torch.Tensor, grow_rb: torch.Tensor,
                 aabb: torch.Tensor) -> torch.Tensor:
    """PCA-oriented rectangle per slot (JAX `ops/boxes._pca_corners`, an
    approximate minAreaRect): the principal axis of the reduced pixels'
    second moments, their projection extents on it, inflated by the
    dilation radius; the AABB where a corner is not finite.

    slots [H, W] int64 (K = no slot). JAX sums the moments in fp32 over an
    [H, W, K] one-hot; here the integer moments are summed exactly in
    int64 by slot (run to run the same on the card, unlike float atomics)
    and then divided in fp32 as JAX does, so a corner differs from JAX's
    only by the rounding of JAX's own sums. Products fused into sums take
    `fma`, as XLA's CPU backend computes them."""
    H, W = slots.shape
    dev = slots.device
    cell = spare_cells(slots, slots < K, K).reshape(-1)
    ys = torch.arange(H, device=dev).repeat_interleave(W)
    xs = torch.arange(W, device=dev).repeat(H)
    mom = torch.stack([torch.ones_like(xs), xs, ys, xs * xs, ys * ys, xs * ys], dim=1)
    sums = torch.zeros((K + SPARE_CELLS, 6), dtype=torch.int64, device=dev).index_add_(
        0, cell, mom)
    sums = sums[:K].float()
    n = torch.clamp(sums[:, 0], min=1.0)
    sx = sums[:, 1] / n
    sy = sums[:, 2] / n
    sxx = fma(-sx, sx, sums[:, 3] / n)
    syy = fma(-sy, sy, sums[:, 4] / n)
    sxy = fma(-sx, sy, sums[:, 5] / n)
    theta = 0.5 * torch.atan2(2 * sxy, sxx - syy)
    c, s = torch.cos(theta), torch.sin(theta)

    # Every pixel projects on its slot's axes (a spare cell's on slot 0's).
    at = torch.where(cell < K, cell, torch.zeros_like(cell))
    fx, fy = xs.float(), ys.float()
    pc, ps = c[at], s[at]
    u = fma(fx, pc, fy * ps)
    v = fma(fy, pc, -(fx * ps))
    full = torch.full((K + SPARE_CELLS,), 1e30, device=dev)
    umin = full.clone().scatter_reduce_(0, cell, u, "amin")[:K]
    umax = (-full).scatter_reduce_(0, cell, u, "amax")[:K]
    vmin = full.clone().scatter_reduce_(0, cell, v, "amin")[:K]
    vmax = (-full).scatter_reduce_(0, cell, v, "amax")[:K]
    # Square dilation inflates projections by at most r * (|c| + |s|).
    spread = torch.abs(c) + torch.abs(s)
    lo, hi = grow_lt.float(), grow_rb.float()
    umin, umax = fma(-lo, spread, umin), fma(hi, spread, umax)
    vmin, vmax = fma(-lo, spread, vmin), fma(hi, spread, vmax)

    def corner(uu, vv):
        return torch.stack([fma(uu, c, -(vv * s)), fma(uu, s, vv * c)], dim=-1)

    corners = torch.stack([corner(umin, vmin), corner(umax, vmin), corner(umax, vmax),
                           corner(umin, vmax)], dim=1)
    bad = ~torch.isfinite(corners).all(2).all(1)
    return torch.where(bad[:, None, None], _aabb_corners(aabb), corners)


def scale_boxes(boxes: torch.Tensor, ratio: float, cfg: OcrConfig) -> torch.Tensor:
    """Heatmap coords -> original-image coords (tuatara.cpp:236-253)."""
    return boxes * (cfg.ratio_net / ratio)


def tesseract_bbox(scaled_boxes: torch.Tensor) -> torch.Tensor:
    """Public bbox: floor(x + 0.5), std::round for the non-negative
    coordinates here (tuatara.cpp:256-274)."""
    return torch.floor(scaled_boxes + 0.5)
