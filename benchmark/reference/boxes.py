"""Score maps -> word boxes, in NumPy and SciPy, written from the
reference's `get_detected_boxes` (tuatara.cpp:119-204, CRAFT's
`getDetBoxes_core`) with the program's stated settings:

1. min-max normalise the region and affinity maps over the page's content
   (the /32-padded page inside the canvas); region pixels above
   `low_text` or affinity pixels above `link_threshold` form the mask;
2. 4-connected components of the mask, in the raster order of their first
   pixel; a component is kept when it has at least `min_component_area`
   pixels, some pixel with a region score >= `text_threshold`, and a
   pixel that is not affinity-only; at most `max_boxes` are kept;
3. the box: the extent of the component's non-affinity-only pixels, grown
   by the dilation radius int(sqrt(area * min(w, h) // (w * h) * 2)) of the
   whole component's extent (OpenCV's dilate with a (1 + r)^2 kernel: r // 2
   left and up, (r + 1) // 2 right and down), clamped to the content;
4. to page coordinates: x * ratio_net / ratio, rounded as floor(x + 0.5)
   for the reported box, floor / ceil + 1 for the crop window.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy import ndimage

FOUR = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


def canvas_geometry(h: int, w: int, cfg: Dict) -> Dict:
    """A page's detection canvas (tuatara.cpp:206-234): the long side
    scaled to mag_ratio * max(h, w), capped at canvas_size, dims truncated
    to int, padded to a multiple of 32; the canvas rounded up to
    canvas_bucket."""
    target = cfg["mag_ratio"] * max(h, w)
    if target > cfg["canvas_size"]:
        target = float(cfg["canvas_size"])
    ratio = target / max(h, w)
    th, tw = int(h * ratio), int(w * ratio)

    def up(n, m):
        return -(-n // m) * m

    ch, cw = up(th, 32), up(tw, 32)
    b = cfg["canvas_bucket"]
    return {"ratio": ratio, "resized": (th, tw), "content": (ch, cw),
            "canvas": (min(up(ch, b), cfg["canvas_size"]), min(up(cw, b), cfg["canvas_size"]))}


def heatmap_boxes(region: np.ndarray, affinity: np.ndarray, content: tuple,
                  cfg: Dict) -> np.ndarray:
    """fp32 maps [h, w] and the content size in canvas pixels -> int boxes
    [n, 4] (x0, y0, x1, y1), inclusive heatmap pixels, in raster order."""
    r = cfg["ratio_net"]
    ch, cw = content[0] // r, content[1] // r
    mask = np.zeros(region.shape, bool)
    mask[:ch, :cw] = True

    def norm(x):
        x = x.astype(np.float32)
        lo, hi = x[mask].min(), x[mask].max()
        return (x - lo) / np.float32(max(hi - lo, 1e-12))

    tn, ln = norm(region), norm(affinity)
    text = (tn > cfg["low_text"]) & mask
    link = (ln > cfg["link_threshold"]) & mask
    comb = text | link
    keep = ~(link & ~text)
    hot = (tn >= cfg["text_threshold"]) & mask
    labels, n = ndimage.label(comb, structure=FOUR)
    if n == 0:
        return np.zeros((0, 4), np.int64)
    idx = np.arange(1, n + 1)
    area = ndimage.sum_labels(np.ones_like(labels), labels, idx).astype(np.int64)
    has_hot = ndimage.maximum(hot, labels, idx).astype(bool)
    first = ndimage.minimum(np.arange(labels.size).reshape(labels.shape), labels, idx)
    objs = ndimage.find_objects(labels)
    out = []
    for k in np.argsort(first, kind="stable"):
        if area[k] < cfg["min_component_area"] or not has_hot[k]:
            continue
        sl = objs[k]
        comp = labels[sl] == k + 1
        red = comp & keep[sl]
        if not red.any():
            continue
        t, b = sl[0].start, sl[0].stop - 1
        lft, rgt = sl[1].start, sl[1].stop - 1
        w, h = rgt - lft + 1, b - t + 1
        niter = int(np.sqrt(np.float32(area[k] * min(w, h) // max(w * h, 1) * 2)))
        ys, xs = np.nonzero(red)
        x0 = max(lft + xs.min() - niter // 2, 0)
        y0 = max(t + ys.min() - niter // 2, 0)
        x1 = min(lft + xs.max() + (niter + 1) // 2, cw - 1)
        y1 = min(t + ys.max() + (niter + 1) // 2, ch - 1)
        out.append((x0, y0, x1, y1))
        if len(out) == cfg["max_boxes"]:
            break
    return np.asarray(out, np.int64).reshape(-1, 4)


def scale(boxes: np.ndarray, ratio: float, cfg: Dict) -> np.ndarray:
    """Heatmap boxes -> page coordinates, fp32."""
    return boxes.astype(np.float32) * np.float32(cfg["ratio_net"] / ratio)


def report_box(scaled: np.ndarray) -> np.ndarray:
    """The reported bbox: floor(x + 0.5)."""
    return np.floor(scaled + np.float32(0.5)).astype(np.int64)


def from_report_box(bbox: np.ndarray, ratio: float, cfg: Dict) -> np.ndarray:
    """The heatmap box that a reported bbox came from: floor(x * s + 0.5)
    is one to one on integers for s = ratio_net / ratio >= 1, so the
    nearest integer to bbox / s whose image is bbox."""
    s = np.float32(cfg["ratio_net"] / ratio)
    bbox = np.asarray(bbox, np.int64)
    guess = np.rint(bbox / float(s)).astype(np.int64)
    out = guess.copy()
    for d in (0, -1, 1):
        cand = guess + d
        hit = report_box(scale(cand, ratio, cfg)) == bbox
        out = np.where(hit, cand, out)
    return out


def crop_windows(scaled: np.ndarray, h: int, w: int) -> np.ndarray:
    """Crop windows [n, 4] (x0, y0, x1, y1 exclusive), fp32, from scaled
    boxes: floor of the low corner, ceil of the high one + 1, in the page."""
    x0 = np.clip(np.floor(scaled[:, 0]), 0, w - 1)
    y0 = np.clip(np.floor(scaled[:, 1]), 0, h - 1)
    x1 = np.minimum(np.maximum(np.ceil(scaled[:, 2]) + 1, x0 + 1), w)
    y1 = np.minimum(np.maximum(np.ceil(scaled[:, 3]) + 1, y0 + 1), h)
    return np.stack([x0, y0, x1, y1], 1).astype(np.float32)
