"""Word-level scoring of engine output (own copy of the part of
`tuatara_tpu/utils/metrics.py` the port's checks use).

* `match_boxes`: greedy one-to-one IoU matching, highest IoU first, ties by
  (pred, truth) index; pairs below the threshold never match.
* `word_accuracy`: exact-match rate of the transcripts of the IoU-matched
  (prediction, truth) pairs, pooled over pages (`evaluate_engine`'s
  `word_acc`).
* `transcript_agreement`: the share of reference words matched by a
  distinct word with the same text and a bbox IoU >= the threshold.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def box_iou(a: Sequence[float], b: Sequence[float]) -> float:
    """IoU of two [x0, y0, x1, y1] boxes."""
    iw = max(min(a[2], b[2]) - max(a[0], b[0]), 0.0)
    ih = max(min(a[3], b[3]) - max(a[1], b[1]), 0.0)
    inter = iw * ih
    if inter <= 0.0:
        return 0.0
    area_a = max(a[2] - a[0], 0.0) * max(a[3] - a[1], 0.0)
    area_b = max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0)
    union = area_a + area_b - inter
    return inter / union if union > 0.0 else 0.0


def match_boxes(pred: Sequence[Sequence[float]], truth: Sequence[Sequence[float]],
                iou_threshold: float = 0.5) -> List[Tuple[int, int, float]]:
    """(pred_idx, truth_idx, iou) triples, highest IoU first, each box used
    at most once."""
    cands = sorted((-box_iou(p, t), i, j) for i, p in enumerate(pred)
                   for j, t in enumerate(truth) if box_iou(p, t) >= iou_threshold)
    used_p, used_t, out = set(), set(), []
    for neg_iou, i, j in cands:
        if i in used_p or j in used_t:
            continue
        used_p.add(i)
        used_t.add(j)
        out.append((i, j, -neg_iou))
    return out


def word_accuracy(pages: Sequence[List[Dict]], truths: Sequence[List[Dict]],
                  iou_threshold: float = 0.5) -> float:
    """Exact transcript matches over all IoU-matched pairs of all pages
    (0.0 when nothing matched)."""
    pairs = []
    for results, truth in zip(pages, truths):
        pairs += [(results[i]["text"], truth[j]["text"]) for i, j, _ in match_boxes(
            [r["bbox"] for r in results], [t["bbox"] for t in truth], iou_threshold)]
    return sum(p == t for p, t in pairs) / len(pairs) if pairs else 0.0


def transcript_agreement(ref: List[Dict], got: List[Dict],
                         iou_threshold: float = 0.5) -> Tuple[int, int]:
    """-> (reference words matched by a distinct word of `got` with the same
    text and bbox IoU >= the threshold, reference words)."""
    matched = 0
    for text in {w["text"] for w in ref}:
        r = [w["bbox"] for w in ref if w["text"] == text]
        g = [w["bbox"] for w in got if w["text"] == text]
        matched += len(match_boxes(g, r, iou_threshold))
    return matched, len(ref)
