"""The benchmark's one page generator: document pages from a mix file and a seed.

A mix file (`benchmark/traffic/<mix>.json`) holds parameters only. The
generator cuts the source pages in `images/` into strips of text: runs of
rows that hold ink, bounded by blank rows, each cut to the columns that
hold ink. A table's ruled grid has ink in every row, so it comes out as
one strip, a block taken whole. Strips are pasted onto white RGB uint8
pages by `np.minimum`, which can only darken and never wraps.

Every seed gets the same work in another order. The layout of each page
(its size, which strips it holds from top to bottom, and the gaps between
them) comes from the mix's fixed `layout_seed`: the strips are dealt from
a deck that holds each strip once and is reshuffled when it runs out, the
page sizes in equal shares, and a sparse page's strip count cycles through
the mix's counts. `--seed` then sets where each strip sits across its
page and the offset at which a strip wider than the page is cut. The
pool's order is the layout's too: the program's speculative slab
(`engine.stats`) depends on the order of box counts, and a seed that
reordered the pool would change the work.

Keys of a mix file:
  entry            "run_stream" (batches to `OcrEngine.run_stream`) or
                   "image_to_data" (one page a call)
  sources          image names under images/
  page_sizes       [[h, w], ...]; dealt in equal shares over the pool
  pool_pages       pages generated (a multiple of pages_per_batch)
  pages_per_batch  stream mixes: pages a batch
  fill             "dense" (strips top to bottom) or "sparse"
  sparse_strips    sparse fill: strip counts, cycled over the pages
  layout_seed      the seed of the pages' layouts (fixed: the same work for
                   every --seed)
  margin, gap      [lo, hi] pixels: page margin, gap between strips
  ink_threshold    a pixel is ink below this value in some channel
  min_strip_rows   shorter runs of ink rows are left out (specks, rules)
  prefetch, depth  stream mixes: `run_stream`'s arguments
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from benchlib.png import decode_png

WHITE = 255


def to_rgb(img: np.ndarray) -> np.ndarray:
    """[H, W, C] uint8 with 1-4 channels -> [H, W, 3] uint8 RGB; alpha is
    laid over white in int32, so nothing wraps."""
    c = img.shape[2]
    if c in (1, 2):
        rgb = np.repeat(img[:, :, :1], 3, axis=2).astype(np.int32)
        alpha = img[:, :, 1:2].astype(np.int32) if c == 2 else None
    else:
        rgb = img[:, :, :3].astype(np.int32)
        alpha = img[:, :, 3:4].astype(np.int32) if c == 4 else None
    if alpha is not None:
        rgb = (rgb * alpha + WHITE * (255 - alpha) + 127) // 255
    return np.clip(rgb, 0, 255).astype(np.uint8)


def cut_strips(img: np.ndarray, ink_threshold: int, min_rows: int) -> List[np.ndarray]:
    """An RGB page -> its strips: maximal runs of rows with ink, each cut
    to the columns with ink, with one white row and column around."""
    ink = img.min(axis=2) < ink_threshold
    rows = ink.any(axis=1)
    strips = []
    y, h = 0, len(rows)
    while y < h:
        if not rows[y]:
            y += 1
            continue
        y1 = y
        while y1 < h and rows[y1]:
            y1 += 1
        if y1 - y >= min_rows:
            cols = np.flatnonzero(ink[y:y1].any(axis=0))
            x0, x1 = max(int(cols[0]) - 1, 0), min(int(cols[-1]) + 2, img.shape[1])
            strips.append(np.ascontiguousarray(img[max(y - 1, 0):min(y1 + 1, h), x0:x1]))
        y = y1
    return strips


def load_strips(root: str, mix: Dict) -> List[np.ndarray]:
    """Every strip of the mix's source pages, in a fixed order."""
    out = []
    for name in mix["sources"]:
        with open(os.path.join(root, "images", f"{name}.png"), "rb") as f:
            img = to_rgb(decode_png(f.read()))
        out += cut_strips(img, mix["ink_threshold"], mix["min_strip_rows"])
    if not out:
        raise ValueError("the mix's sources hold no strip of text")
    return out


class Deck:
    """The strips in a seeded order, each once, reshuffled when dealt out."""

    def __init__(self, n: int, rng: np.random.Generator):
        self.n, self.rng = n, rng
        self.order: List[int] = []

    def peek(self) -> int:
        if not self.order:
            self.order = list(self.rng.permutation(self.n))
        return int(self.order[0])

    def take(self) -> int:
        i = self.peek()
        self.order.pop(0)
        return i


def fit(strip: np.ndarray, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """A strip cut to at most [h, w] at a seeded offset (whole if it fits)."""
    sh, sw = strip.shape[:2]
    y0 = int(rng.integers(0, sh - h + 1)) if sh > h else 0
    x0 = int(rng.integers(0, sw - w + 1)) if sw > w else 0
    return strip[y0:y0 + h, x0:x0 + w]


def paste(page: np.ndarray, strip: np.ndarray, y: int, x: int) -> None:
    """Darken the page under the strip (np.minimum of two uint8: no wrap)."""
    h, w = strip.shape[:2]
    np.minimum(page[y:y + h, x:x + w], strip, out=page[y:y + h, x:x + w])


def dense_page(h: int, w: int, strips, deck: Deck, mix: Dict, lay: np.random.Generator,
               rng: np.random.Generator) -> np.ndarray:
    """Strips top to bottom until the next one does not fit (the first
    one is cut to the page if it is taller); the layout from `lay`, the
    places across the page from `rng`."""
    page = np.full((h, w, 3), WHITE, np.uint8)
    lo, hi = mix["margin"]
    top = y = int(lay.integers(lo, hi + 1))
    bottom = h - int(lay.integers(lo, hi + 1))
    while True:
        strip = strips[deck.peek()]
        if y > top and y + strip.shape[0] > bottom:
            break  # the rest of the page is too short for the next strip
        deck.take()
        s = fit(strip, bottom - y, w, rng)
        x = int(rng.integers(0, w - s.shape[1] + 1))
        paste(page, s, y, x)
        y += s.shape[0] + int(lay.integers(mix["gap"][0], mix["gap"][1] + 1))
    return page


def sparse_page(h: int, w: int, n: int, strips, deck: Deck, lay: np.random.Generator,
                rng: np.random.Generator) -> np.ndarray:
    """n strips, each in its own horizontal band at a height from `lay`."""
    page = np.full((h, w, 3), WHITE, np.uint8)
    band = h // n
    for i in range(n):
        s = fit(strips[deck.take()], band, w, rng)
        y = i * band + int(lay.integers(0, band - s.shape[0] + 1))
        x = int(rng.integers(0, w - s.shape[1] + 1))
        paste(page, s, y, x)
    return page


def generate(root: str, mix: Dict, seed: int) -> List[np.ndarray]:
    """The mix's pool of pages for `seed`: a list of [h, w, 3] uint8."""
    lay = np.random.default_rng(mix["layout_seed"])
    rng = np.random.default_rng(seed)
    strips = load_strips(root, mix)
    deck = Deck(len(strips), lay)
    n = mix["pool_pages"]
    sizes: List[Tuple[int, int]] = [tuple(s) for s in mix["page_sizes"]]
    if n % len(sizes):
        raise ValueError("pool_pages must deal the page sizes in equal shares")
    counts = mix.get("sparse_strips", [1])
    pages = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        if mix["fill"] == "dense":
            pages.append(dense_page(h, w, strips, deck, mix, lay, rng))
        elif mix["fill"] == "sparse":
            pages.append(sparse_page(h, w, counts[i % len(counts)], strips, deck, lay, rng))
        else:
            raise ValueError(f"unknown fill {mix['fill']!r}")
    return pages

