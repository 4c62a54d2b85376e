"""The page generator: deterministic for a seed, different across seeds,
the same work in another order, and no arithmetic that wraps."""

import json
import os

import numpy as np
import pytest

from traffic import pages as P

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def mix(name, **over):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return dict(json.load(f), **over)


SMALL = {"pool_pages": 8, "pages_per_batch": 4}


@pytest.mark.parametrize("name", ["stream-dense", "stream-sparse", "page-mixed"])
def test_deterministic_for_a_seed(name):
    m = mix(name, **SMALL)
    a = P.generate(ROOT, m, 2**31 + 17)
    b = P.generate(ROOT, m, 2**31 + 17)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = P.generate(ROOT, m, 2**31 + 18)
    assert any(x.shape != y.shape or not np.array_equal(x, y) for x, y in zip(a, c))


def test_sizes_dealt_in_equal_shares():
    m = mix("page-mixed", pool_pages=8)
    for seed in (1, 2**33 + 5):
        shapes = [p.shape[:2] for p in P.generate(ROOT, m, seed)]
        for h, w in m["page_sizes"]:
            assert shapes.count((h, w)) == 2


def test_pages_hold_text_on_white():
    for name in ("stream-dense", "stream-sparse"):
        for p in P.generate(ROOT, mix(name, **SMALL), 3):
            assert p.dtype == np.uint8 and p.shape == (1000, 754, 3)
            ink = (p.min(2) < 160).mean()
            assert (0.01 < ink < 0.5) if name == "stream-dense" else (0 < ink < 0.15)


def test_paste_never_wraps():
    rng = np.random.default_rng(0)
    page = np.full((40, 50, 3), 255, np.uint8)
    strips = [rng.integers(0, 256, (30, 40, 3), dtype=np.uint8) for _ in range(20)]
    lowest = np.full_like(page, 255)
    for s in strips:
        y, x = int(rng.integers(0, 10)), int(rng.integers(0, 10))
        P.paste(page, s, y, x)
        np.minimum(lowest[y:y + 30, x:x + 40], s, out=lowest[y:y + 30, x:x + 40])
    assert np.array_equal(page, lowest)  # darkest of what lies there, never brighter


def test_alpha_over_white_in_range():
    img = np.zeros((2, 3, 4), np.uint8)
    img[..., :3] = 255
    img[..., 3] = [[0, 128, 255], [255, 1, 0]]
    rgb = P.to_rgb(img)
    assert rgb.dtype == np.uint8 and int(rgb.min()) == 255
    img[..., :3] = 0
    rgb = P.to_rgb(img)
    assert rgb[0, 0, 0] == 255 and rgb[0, 2, 0] == 0 and rgb[0, 1, 0] == 127


def test_strips_are_rows_of_ink():
    img = np.full((30, 20, 3), 255, np.uint8)
    img[3:10, 2:5] = 0
    img[15:16, 1:19] = 0     # a one-row rule: shorter than min_rows
    img[20:28, 8:18] = 50
    strips = P.cut_strips(img, 160, 2)
    assert [s.shape[:2] for s in strips] == [(9, 5), (10, 12)]
