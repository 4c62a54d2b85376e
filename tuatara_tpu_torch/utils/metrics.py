"""Scoring of engine output: the port's own copy of
`tuatara_tpu/utils/metrics.py`, host-side Python over result dicts.

* `edit_distance`, `char_error_rate`, `pair_accuracy` (JAX's
  `word_accuracy` over (predicted, truth) pairs): recognition quality.
* `match_boxes`: greedy one-to-one IoU matching, highest IoU first, ties by
  (pred, truth) index; pairs below the threshold never match.
* `detection_prf`: precision, recall and F1 of boxes at an IoU threshold.
* `evaluate_page` / `evaluate_engine`: detection PRF plus CER and word
  accuracy over the IoU-matched pairs, for a page or (micro-averaged) a
  labelled set run through `OcrEngine.run_mixed`.
* `word_accuracy`: exact-match rate of the transcripts of the IoU-matched
  pairs, pooled over pages (`evaluate_engine`'s `word_acc`).
* `transcript_agreement`: the share of reference words matched by a
  distinct word with the same text and a bbox IoU >= the threshold.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (unit insert/delete/substitute costs)."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    if len(a) < len(b):  # the shorter string sets the row length
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def char_error_rate(pairs: Sequence[Tuple[str, str]]) -> float:
    """Total edit distance over total truth characters of (predicted,
    truth) pairs (edits / max(chars, 1); can exceed 1)."""
    edits = sum(edit_distance(p, t) for p, t in pairs)
    chars = sum(len(t) for _, t in pairs)
    return edits / max(chars, 1)


def pair_accuracy(pairs: Sequence[Tuple[str, str]]) -> float:
    """Exact-match rate over (predicted, truth) pairs; 0.0 for none."""
    if not pairs:
        return 0.0
    return sum(p == t for p, t in pairs) / len(pairs)


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
    return pair_accuracy([pair for results, truth in zip(pages, truths)
                          for pair in _matched_pairs(results, truth, iou_threshold, True)])


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


def detection_prf(pred: Sequence[Sequence[float]], truth: Sequence[Sequence[float]],
                  iou_threshold: float = 0.5) -> Dict[str, float]:
    """{precision, recall, f1, tp, fp, fn} of greedy IoU matching; nothing
    predicted on a page with no truth is perfect."""
    tp = len(match_boxes(pred, truth, iou_threshold))
    fp = len(pred) - tp
    fn = len(truth) - tp
    precision = tp / len(pred) if pred else (1.0 if not truth else 0.0)
    recall = tp / len(truth) if truth else (1.0 if not pred else 0.0)
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return {"precision": precision, "recall": recall, "f1": f1, "tp": tp, "fp": fp, "fn": fn}


def _matched_pairs(results: List[Dict], truth: List[Dict], iou_threshold: float,
                   case_sensitive: bool) -> List[Tuple[str, str]]:
    pairs = [(results[i]["text"], truth[j]["text"]) for i, j, _ in match_boxes(
        [r["bbox"] for r in results], [t["bbox"] for t in truth], iou_threshold)]
    return pairs if case_sensitive else [(p.lower(), t.lower()) for p, t in pairs]


def evaluate_page(results: List[Dict], truth: List[Dict], iou_threshold: float = 0.5,
                  case_sensitive: bool = True) -> Dict[str, float]:
    """One page's output [{text, bbox, ...}] against truth [{text, bbox}]:
    `detection_prf` plus cer, word_acc and matched over the IoU-matched
    pairs."""
    det = detection_prf([r["bbox"] for r in results], [t["bbox"] for t in truth],
                        iou_threshold)
    pairs = _matched_pairs(results, truth, iou_threshold, case_sensitive)
    det["cer"] = char_error_rate(pairs)
    det["word_acc"] = pair_accuracy(pairs)
    det["matched"] = len(pairs)
    return det


def evaluate_engine(engine, images: Sequence, truths: Sequence[List[Dict]],
                    iou_threshold: float = 0.5, case_sensitive: bool = True
                    ) -> Dict[str, float]:
    """An engine over a labelled set (pages of any sizes, through
    `run_mixed`), micro-averaged: {precision, recall, f1, cer, word_acc,
    pages, matched, tp, fp, fn}."""
    if len(images) != len(truths):
        raise ValueError(f"{len(images)} images but {len(truths)} truth lists")
    tp = fp = fn = 0
    pairs: List[Tuple[str, str]] = []
    for results, truth in zip(engine.run_mixed(list(images)), truths):
        det = detection_prf([r["bbox"] for r in results], [t["bbox"] for t in truth],
                            iou_threshold)
        tp, fp, fn = tp + det["tp"], fp + det["fp"], fn + det["fn"]
        pairs += _matched_pairs(results, truth, iou_threshold, case_sensitive)
    precision = tp / (tp + fp) if tp + fp else (1.0 if fn == 0 else 0.0)
    recall = tp / (tp + fn) if tp + fn else (1.0 if fp == 0 else 0.0)
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return {"precision": precision, "recall": recall, "f1": f1,
            "cer": char_error_rate(pairs), "word_acc": pair_accuracy(pairs),
            "pages": len(images), "matched": len(pairs), "tp": tp, "fp": fp, "fn": fn}
