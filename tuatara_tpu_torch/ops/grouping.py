"""Word-box grouping into line-level hierarchy.

The port's own copy of `tuatara_tpu/ops/grouping.py` (host code over the
result dicts; the same lines and blocks for the same words).

Implements the reference's open TODO (tuatara.cpp:411-414: "group
horizontally adjacent boxes" for more recognition context) as a post-pass
over recognized word results. This is deliberate HOST logic: after detection
there are at most `max_boxes` items, so grouping is microseconds of Python —
device work would only add dispatch latency.

Algorithm: single pass in (y, x) order. A word joins an existing line when
its vertical interval overlaps the line's by at least
`min_vertical_overlap` of the smaller height (text on one baseline overlaps
heavily; different lines barely at all). Within a line, words sort by x and
split into segments wherever the horizontal gap exceeds
`max_gap_ratio * line height` — that keeps table cells and multi-column
layouts from fusing across whitespace (the failure mode a naive
sort-by-(y,x) reading order, run_ocr.py:12, exhibits on tables).
"""

from __future__ import annotations

import math
from typing import Dict, List


def group_lines(
    results: List[Dict],
    min_vertical_overlap: float = 0.4,
    max_gap_ratio: float = 2.0,
) -> List[Dict]:
    """Group word results [{text, bbox, confidence}] into lines.

    Returns [{text, bbox, confidence, words}] sorted in reading order:
    `text` is the x-ordered words joined by spaces, `bbox` the union AABB,
    `confidence` the geometric mean of the member words' confidences (a
    per-character-ish quality score that doesn't shrink with line length the
    way a product would), `words` the member word dicts in x order.
    """
    # A line's vertical interval is the running MEAN of its members'
    # intervals, not their union: one tall outlier box (dropped cap, logo,
    # vertically-merged detection) must not stretch the line to swallow the
    # next physical line (union extents chain-merge; means stay put).
    lines: List[Dict] = []
    for r in sorted(results, key=lambda r: (r["bbox"][1], r["bbox"][0])):
        x0, y0, x1, y1 = r["bbox"]
        h = max(y1 - y0, 1.0)
        best, best_ov = None, min_vertical_overlap
        for ln in lines:
            ly0, ly1 = ln["sy0"] / ln["n"], ln["sy1"] / ln["n"]
            ov = min(y1, ly1) - max(y0, ly0)
            denom = max(min(h, ly1 - ly0), 1.0)
            if ov / denom >= best_ov:
                best, best_ov = ln, ov / denom
        if best is None:
            lines.append({"sy0": y0, "sy1": y1, "n": 1, "words": [r]})
        else:
            best["words"].append(r)
            best["sy0"] += y0
            best["sy1"] += y1
            best["n"] += 1

    out: List[Dict] = []
    for ln in lines:
        words = sorted(ln["words"], key=lambda r: r["bbox"][0])
        # Gap-splitting scale: median member height (robust to outliers).
        heights = sorted(w_["bbox"][3] - w_["bbox"][1] for w_ in words)
        height = max(heights[len(heights) // 2], 1.0)
        segments: List[List[Dict]] = [[words[0]]]
        for prev, cur in zip(words, words[1:]):
            if cur["bbox"][0] - prev["bbox"][2] > max_gap_ratio * height:
                segments.append([cur])
            else:
                segments[-1].append(cur)
        for seg in segments:
            bbox = [
                min(w["bbox"][0] for w in seg),
                min(w["bbox"][1] for w in seg),
                max(w["bbox"][2] for w in seg),
                max(w["bbox"][3] for w in seg),
            ]
            confs = [max(w.get("confidence", 1.0), 1e-30) for w in seg]
            conf = math.exp(sum(math.log(c) for c in confs) / len(confs))
            out.append({
                "text": " ".join(w["text"] for w in seg),
                "bbox": bbox,
                "confidence": conf,
                "words": seg,
            })
    out.sort(key=lambda l: (l["bbox"][1], l["bbox"][0]))
    return out


def group_blocks(
    lines: List[Dict],
    max_line_gap_ratio: float = 0.8,
    min_horizontal_overlap: float = 0.3,
) -> List[Dict]:
    """Group line results (from `group_lines`) into paragraph/block level.

    Two lines join the same block when they are vertically adjacent (gap
    between them at most `max_line_gap_ratio` of the shorter line's height —
    paragraph leading is typically 0.2-0.5x; a blank line or heading break
    is >1x) AND their horizontal extents overlap by at least
    `min_horizontal_overlap` of the narrower of (new line, the block's LAST
    line). Both gates compare against the last member line, never the
    block's union bbox: a union chain-merges, so one full-width heading
    would bridge side-by-side columns into a single interleaved block —
    the same failure mode `group_lines` avoids by using running means
    instead of union extents. Single-link agglomeration in reading order.

    Returns [{text, bbox, confidence, lines}] in reading order: `text` is
    the member lines joined by newlines, `bbox` the union AABB,
    `confidence` the geometric mean of line confidences, `lines` the member
    line dicts (each still carrying its `words`).
    """
    blocks: List[Dict] = []
    for ln in sorted(lines, key=lambda l: (l["bbox"][1], l["bbox"][0])):
        x0, y0, x1, y1 = ln["bbox"]
        h = max(y1 - y0, 1.0)
        best = None
        for blk in blocks:
            last = blk["lines"][-1]["bbox"]
            lh = max(last[3] - last[1], 1.0)
            gap = y0 - last[3]
            if gap > max_line_gap_ratio * min(h, lh):
                continue
            hov = min(x1, last[2]) - max(x0, last[0])
            denom = max(min(x1 - x0, last[2] - last[0]), 1.0)
            if hov / denom < min_horizontal_overlap:
                continue
            if best is None or last[3] > best["lines"][-1]["bbox"][3]:
                best = blk
        if best is None:
            blocks.append({"bbox": list(ln["bbox"]), "lines": [ln]})
        else:
            best["lines"].append(ln)
            b = best["bbox"]
            best["bbox"] = [min(b[0], x0), min(b[1], y0),
                            max(b[2], x1), max(b[3], y1)]

    out: List[Dict] = []
    for blk in blocks:
        confs = [max(l.get("confidence", 1.0), 1e-30) for l in blk["lines"]]
        conf = math.exp(sum(math.log(c) for c in confs) / len(confs))
        out.append({
            "text": "\n".join(l["text"] for l in blk["lines"]),
            "bbox": blk["bbox"],
            "confidence": conf,
            "lines": blk["lines"],
        })
    out.sort(key=lambda b: (b["bbox"][1], b["bbox"][0]))
    return out
