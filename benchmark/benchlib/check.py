"""Whether what the timed path served is correct.

Once the window has closed, a sample of the pages it completed, drawn from
the seed (the page with the most words always in it), goes through the
plain reference (`benchmark/reference/`). Where the configuration states
int8 convs, the reference runs them in int8 over the batch the program ran
the page in (the stream's pool batch, or the page alone), so that their
activation scales span the same pages. The numbers, each compared with its
limit where `benchmark/limits/<cell>.json` gives one:

  score_err  the worst page's relative L2 error of CRAFT's score maps (both
             channels, the page's content) as the window computed them,
             against the reference's: the canvas and CRAFT; a sampled page
             whose maps the window did not keep reads +inf
  box_miss   1 - 2 * matched / (served boxes + reference boxes) over the
             sample, a served box matched to the unmatched reference box
             of the largest IoU, if that is at least 0.5: the box extraction
  read_miss  the share of the served words that the reference, reading the
             served box (its crop and PARSeq's greedy decode and one cloze
             pass), reads with confidence >= 0.5, whose served text differs
             from the reference's: the crops and PARSeq, apart from the
             boxes, which box_miss holds
  conf_err   the mean gap between the served confidence and the
             reference's over those words that read the same

A page the program failed on serves no box. Words the reference reads
with less confidence are near ties of its own decode, which any rounding
can flip, and are not held. The lower-precision controls (`readings.py`)
are read the same way, each with its own reading in the program's place.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import math

import numpy as np
import torch


NUMBERS = ("score_err", "box_miss", "read_miss", "conf_err")
SURE = 0.5  # the least confidence of a reference reading that is held


def sample(completed: Sequence[Tuple[int, List[Dict]]], n: int, seed: int
           ) -> List[Tuple[int, List[Dict]]]:
    """Up to n distinct pool pages among the completed (pool index, result)
    pairs, drawn from the seed; the one with the most words first. A pool
    page served more than once keeps its first result: the rest must equal
    it (`repeats_agree`)."""
    first: Dict[int, List[Dict]] = {}
    for idx, res in completed:
        first.setdefault(idx, res)
    keys = sorted(first)
    if not keys:
        return []
    longest = max(keys, key=lambda k: len(first[k]))
    rest = [k for k in keys if k != longest]
    rng = np.random.default_rng(seed)
    picked = [longest] + [rest[i] for i in rng.permutation(len(rest))[:max(n - 1, 0)]]
    return [(k, first[k]) for k in picked]


def repeats_agree(completed: Sequence[Tuple[int, List[Dict]]]) -> int:
    """How many results of a pool page differ from its first result (the
    same page in the same batch place must read the same)."""
    first: Dict[int, List[Dict]] = {}
    bad = 0
    for idx, res in completed:
        if idx in first:
            a, b = first[idx], res
            bad += len(a) != len(b) or any(
                x["text"] != y["text"] or x["bbox"] != y["bbox"] for x, y in zip(a, b))
        else:
            first[idx] = res
    return bad


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU [len(a), len(b)] of inclusive integer boxes (x0, y0, x1, y1)."""
    a, b = a[:, None, :].astype(np.float64), b[None, :, :].astype(np.float64)
    iw = np.clip(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]) + 1, 0, None)
    ih = np.clip(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]) + 1, 0, None)
    inter = iw * ih

    def area(x):
        return (x[..., 2] - x[..., 0] + 1) * (x[..., 3] - x[..., 1] + 1)

    return inter / (area(a) + area(b) - inter)


def matched(served: np.ndarray, ref: np.ndarray, least: float = 0.5) -> Dict[int, int]:
    """Served boxes matched one to one, in order, each to the unmatched
    reference box of the largest IoU, if that is at least `least`. ->
    {reference index: served index}."""
    pairs: Dict[int, int] = {}
    if not len(served) or not len(ref):
        return pairs
    m = iou(served, ref)
    free = np.ones(len(ref), bool)
    for i, row in enumerate(m):
        row = np.where(free, row, -1.0)
        j = int(row.argmax())
        if row[j] >= least:
            free[j] = False
            pairs[j] = i
    return pairs


def score_err(ref, page: np.ndarray, got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 error of score maps [h, w, 2] over the page's content."""
    ch, cw = ref.geometry(page)["content"]
    r = ref.det["ratio_net"]
    a = got[:ch // r, :cw // r].to(want.device).double()
    b = want[:ch // r, :cw // r].double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def reference_maps(ref, pool: Sequence[np.ndarray], picked: Sequence[int], per_batch: int
                   ) -> List[torch.Tensor]:
    """The reference's score maps of the pool pages `picked`, each computed
    over the batch the program ran it in (pool pages b * per_batch to
    (b + 1) * per_batch) where a quantized conv's scale spans the batch,
    else a page at a time."""
    if not ref.craft.batch_wide:
        per_batch = 1
    want = set(picked)
    maps: Dict[int, torch.Tensor] = {}
    for b in sorted({i // per_batch for i in picked}):
        lo = b * per_batch
        got = ref.scores_batch(list(pool[lo:lo + per_batch]))
        maps.update({lo + j: m for j, m in enumerate(got) if lo + j in want})
    return [maps[i] for i in picked]


def numbers(ref, pages: Sequence[np.ndarray], served: Sequence[List[Dict]],
            scores: Sequence, wants: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The numbers of `served` (one result list a page, None for a page that
    failed) and of the score maps the program computed for those pages
    (None where the window kept none) against the reference `ref` and its
    maps `wants` of the same pages (`reference_maps`)."""
    n_served = n_ref = hits = sure = read = 0
    err = gap = 0.0
    for page, res, got, want in zip(pages, served, scores, wants):
        err = max(err, math.inf if got is None else score_err(ref, page, got, want))
        mine = ref.boxes(page, want)
        n_ref += len(mine)
        res = res or []
        n_served += len(res)
        bboxes = np.asarray([r["bbox"] for r in res], np.float64).reshape(-1, 4)
        bboxes = bboxes.round().astype(np.int64)
        hits += len(matched(bboxes, mine))
        for r, w in zip(res, ref.read_boxes(page, bboxes)):
            if w["confidence"] >= SURE:
                sure += 1
                if r["text"] == w["text"]:
                    read += 1
                    gap += abs(r["confidence"] - w["confidence"])
    total = n_served + n_ref
    return {"score_err": err,
            "box_miss": 1.0 - 2.0 * hits / total if total else 0.0,
            "read_miss": 1.0 - read / sure if sure else 0.0,
            "conf_err": gap / read if read else 0.0}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Tuple]]:
    """-> (every number within its limit, [(name, value, limit)])."""
    rows = [(k, values[k], limits[k]) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
