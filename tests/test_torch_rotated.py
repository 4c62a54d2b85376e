"""Rotated boxes of the port against the JAX package, on the CPU.

The same seeded numpy inputs go through `tuatara_tpu` (live: these are
small jitted functions) and `tuatara_tpu_torch`:

* `row_profiles`, `_dilate_profiles` and the hull chains (`_lower_chains`
  against the plain version of H1, `kernels/hull.lower_chains_plain`) are
  bit-equal: integers held in fp32, min/max and exact cross products;
* `min_area_rect_from_profiles` gives the same corners IN ORDER within
  1e-4 (a tie broken another way starts the corners at another vertex,
  a whole pixel or more away) and the same exact_ok, on random rotated
  blobs and on degenerate sets: one row, one point, a chain past the
  vertex budget, a dilation radius past _MAX_GROW. The port takes JAX's
  fused multiply-adds (`minarearect.fma`), and is bit-equal on these
  cases;
* `_pca_corners` within 1e-3: the port sums moments exactly in int64,
  JAX in fp32, and their cos/sin/atan2 differ in the last bit;
* `extract_crops_perspective_batched` within 1e-5 (JAX fuses the quad's
  nested lerps in an order the port does not repeat: ~1e-7 seen);
* the engine at `box_mode="rotated"`, `rotated_fit` "exact" and "pca",
  on the five reference pages against the JAX record
  tests/fixtures/torch_geometry_golden.json (`tests/gen_torch_geometry.py`):
  texts and bboxes equal, confidences within 1e-4; one live JAX case.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuatara_tpu.api import OcrEngine as JaxEngine
from tuatara_tpu.config import OcrConfig as JaxOcrConfig
from tuatara_tpu.ops import boxes as jboxes
from tuatara_tpu.ops import minarearect as jmar
from tuatara_tpu.ops import warp as jwarp
import tuatara_tpu_torch
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.kernels.hull import lower_chains_plain
from tuatara_tpu_torch.ops import boxes as tboxes
from tuatara_tpu_torch.ops import minarearect as tmar
from tuatara_tpu_torch.ops import warp as twarp

from torch_common import GOLDEN, ROOT, assert_same_words, image, torch_threads, words  # noqa: F401

RECORD = os.path.join(ROOT, "tests", "fixtures", "torch_geometry_golden.json")
PAGES = ["funsd_0001129658", "funsd_91372360", "resume_example", "table_english",
         "rotated_text"]
CORNER_ATOL = 1e-4
PCA_ATOL = 1e-3
CROP_ATOL = 1e-5


def blobs(seed, h=64, w=80, k=12, keep_p=0.95):
    """Seeded rotated rectangles of pixels, labelled by their smallest
    raster index (-1 background), sorted roots padded with 2**30 to k, and
    a random keep mask. -> (labels, roots, keep, reduced [h, w, k])."""
    rng = np.random.default_rng(seed)
    lab = -np.ones((h, w), np.int32)
    yy, xx = np.mgrid[:h, :w]
    roots = []
    for _ in range(k):
        cy, cx = rng.integers(5, h - 5), rng.integers(5, w - 5)
        th = rng.random() * np.pi
        a, b = rng.integers(2, 15), rng.integers(1, 5)
        u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        m = (np.abs(u) <= a) & (np.abs(v) <= b) & (lab < 0)
        if m.any():
            lab[m] = np.flatnonzero(m.ravel()).min()
            roots.append(int(lab[m][0]))
    roots = np.array(sorted(roots) + [2**30] * (k - len(roots)), np.int32)
    keep = rng.random((h, w)) < keep_p
    reduced = (lab[:, :, None] == roots[None, None, :]) & keep[:, :, None]
    return lab, roots, keep, reduced


def port_profiles(lab, roots, keep):
    slots = tmar.component_slots(torch.from_numpy(np.where(keep, lab, -1)),
                                 torch.from_numpy(roots))
    return tmar.row_profiles(slots, len(roots))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", range(4))
def test_profiles_dilation_and_chains_bit_equal(seed):
    lab, roots, keep, reduced = blobs(seed)
    h, w = lab.shape
    rng = np.random.default_rng(100 + seed)
    glt = rng.integers(0, 21, len(roots)).astype(np.int32)  # up to 20 > _MAX_GROW
    grb = glt + rng.integers(0, 2, len(roots)).astype(np.int32)
    cw, ch = np.int32(w - 3), np.int32(h - 2)
    jp = jmar.row_profiles(jnp.asarray(reduced))
    tp = port_profiles(lab, roots, keep)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jd = jmar._dilate_profiles(*jp, jnp.asarray(glt), jnp.asarray(grb), jnp.asarray(cw),
                               jnp.asarray(ch))
    td = tmar._dilate_profiles(*tp, t(glt), t(grb), t(cw), t(ch))
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    px = jnp.concatenate([jd[0].T, -jd[1].T])
    pv = jnp.concatenate([jd[2].T, jd[2].T])
    for a, b in zip(jax.jit(jmar._lower_chains)(px, pv), lower_chains_plain(*td[:3])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_chains_past_the_budget_bit_equal():
    """Rows on a strictly convex (even slots) or concave (odd) curve of 193
    slopes: one chain of each holds 194 vertices, past the budget of 192
    that the sweep keeps."""
    h, k = 200, 4
    steps = np.cumsum(np.arange(-96, 97)).astype(np.float32)
    curve = np.zeros((h, k), np.float32)
    curve[1:194, 0::2] = steps[:, None]
    curve[1:194, 1::2] = -steps[:, None]
    dmin, dmax = curve + 5000, 9000 - curve
    dval = np.zeros((h, k), bool)
    dval[:194] = True
    px = jnp.concatenate([jnp.asarray(dmin).T, -jnp.asarray(dmax).T])
    pv = jnp.concatenate([jnp.asarray(dval).T, jnp.asarray(dval).T])
    want = jax.jit(jmar._lower_chains)(px, pv)
    got = lower_chains_plain(t(dmin), t(dmax), t(dval))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(got[2].max()) == 194


def degenerate_cases():
    """(name, reduced [h, w, k]): one row, one point, one column or an
    L in slot 0, a short row in slot 2, the other slots empty."""
    h, w, k = 24, 40, 6
    out = []
    for name, cells in (("row", [(5, x) for x in range(3, 30)]), ("point", [(10, 20)]),
                        ("column", [(y, 7) for y in range(2, 20)]),
                        ("ell", [(y, 4) for y in range(3, 15)] + [(14, x) for x in range(4, 25)])):
        m = np.zeros((h, w, k), bool)
        for y, x in cells:
            m[y, x, 0] = True
        m[20, 33:36, 2] = True  # a short second component in another slot
        out.append((name, m))
    return out


def fit_both(reduced, glt, grb, cw, ch):
    """(JAX corners, JAX exact_ok, port corners, port exact_ok)."""
    jp = jmar.row_profiles(jnp.asarray(reduced))
    jc, jok = jmar.min_area_rect_from_profiles(*jp, jnp.asarray(glt), jnp.asarray(grb),
                                               jnp.asarray(cw), jnp.asarray(ch))
    tp = tuple(torch.from_numpy(np.asarray(a).copy()) for a in jp)
    tc, tok = tmar.min_area_rect_from_profiles(*tp, t(glt), t(grb), t(cw), t(ch), chunk=5)
    return np.asarray(jc), np.asarray(jok), tc.numpy(), tok.numpy()


@pytest.mark.parametrize("seed", range(6))
def test_min_area_rect_corners_in_order(seed):
    lab, roots, keep, reduced = blobs(seed + 10)
    h, w = lab.shape
    rng = np.random.default_rng(seed)
    glt = rng.integers(0, 20, len(roots)).astype(np.int32)
    grb = glt + rng.integers(0, 2, len(roots)).astype(np.int32)
    jc, jok, tc, tok = fit_both(reduced, glt, grb, np.int32(w - 3), np.int32(h - 2))
    np.testing.assert_array_equal(jok, tok)
    assert jok.sum() >= 3
    np.testing.assert_allclose(tc[jok], jc[jok], rtol=0, atol=CORNER_ATOL)


@pytest.mark.parametrize("case", [c[0] for c in degenerate_cases()])
def test_min_area_rect_degenerate(case):
    reduced = dict(degenerate_cases())[case]
    h, w, k = reduced.shape
    glt = np.array([2, 0, 19, 0, 0, 0], np.int32)  # slot 2: past _MAX_GROW
    grb = glt + 1
    jc, jok, tc, tok = fit_both(reduced, glt, grb, np.int32(w), np.int32(h))
    np.testing.assert_array_equal(jok, tok)
    assert jok[0] and not jok[2] and not jok[1]
    np.testing.assert_allclose(tc[jok], jc[jok], rtol=0, atol=CORNER_ATOL)


def test_min_area_rect_chain_budget_overflow(monkeypatch):
    """A chain longer than the vertex budget flags its component (budget
    cut to 3 in both packages: a disc's chains hold more vertices)."""
    h, w, k = 30, 34, 3
    yy, xx = np.mgrid[:h, :w]
    reduced = np.zeros((h, w, k), bool)
    reduced[..., 0] = (yy - 14) ** 2 + (xx - 15) ** 2 <= 100
    reduced[4:6, 2:6, 1] = True  # a 2x4 block: two vertices a chain
    monkeypatch.setattr(jmar, "_CHAIN_BUDGET", 3)
    monkeypatch.setattr(tmar, "_CHAIN_BUDGET", 3)
    fit = jax.jit(jmar.min_area_rect_from_profiles.__wrapped__)  # traced under the cut
    monkeypatch.setattr(jmar, "min_area_rect_from_profiles", fit)
    glt = np.array([1, 1, 0], np.int32)
    jc, jok, tc, tok = fit_both(reduced, glt, glt, np.int32(w), np.int32(h))
    np.testing.assert_array_equal(jok, tok)
    assert not jok[0] and jok[1]
    np.testing.assert_allclose(tc[jok], jc[jok], rtol=0, atol=CORNER_ATOL)


@pytest.mark.parametrize("seed", range(3))
def test_pca_corners(seed):
    lab, roots, keep, reduced = blobs(seed + 20, keep_p=0.9)
    h, w = lab.shape
    k = len(roots)
    rng = np.random.default_rng(seed)
    glt = rng.integers(0, 6, k).astype(np.int32)
    grb = glt + 1
    aabb = rng.uniform(0, 50, (k, 4)).astype(np.float32)
    member = lab[:, :, None] == roots[None, None, :]
    want = jax.jit(jboxes._pca_corners, static_argnums=(2, 3))(
        jnp.asarray(member), jnp.asarray(reduced), h, w, jnp.asarray(glt), jnp.asarray(grb),
        jnp.asarray(aabb))
    slots = tmar.component_slots(torch.from_numpy(np.where(keep, lab, -1)),
                                 torch.from_numpy(roots))
    got = tboxes._pca_corners(slots, k, t(glt), t(grb), t(aabb))
    live = roots < 2**30
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], rtol=0,
                               atol=PCA_ATOL)


@pytest.mark.parametrize("fit", ["exact", "pca", "axis"])
def test_extract_boxes_rotated(fit):
    """extract_boxes(box_mode="rotated") on seeded text-like heatmaps:
    the same valid slots, corners in order (exact within CORNER_ATOL, pca
    within PCA_ATOL); "axis": box_mode="axis", whose corners are the
    boxes' own, equal."""
    rng = np.random.default_rng(5)
    h, w = 96, 128
    yy, xx = np.mgrid[:h, :w]
    tm = rng.random((h, w)) * 0.2
    lm = rng.random((h, w)) * 0.2
    for i in range(14):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        th = rng.uniform(-0.6, 0.6) if i % 3 else rng.uniform(0, np.pi)
        a, b = rng.uniform(3, 25), rng.uniform(1.5, 5)
        u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        tm = np.maximum(tm, (1 - np.maximum(abs(u) / a, abs(v) / b)).clip(0, 1))
        lm = np.maximum(lm, ((abs(u) < a * 1.3) & (abs(v) < b * 0.4)) * 0.6)
    tm, lm = tm.astype(np.float32), lm.astype(np.float32)
    mask = np.zeros((h, w), bool)
    mask[:h - 10, :w - 6] = True
    kw = ({"box_mode": "axis", "max_boxes": 64} if fit == "axis" else
          {"box_mode": "rotated", "rotated_fit": fit, "max_boxes": 64})
    want = jboxes.extract_boxes(jnp.asarray(tm), jnp.asarray(lm), jnp.asarray(mask),
                                JaxOcrConfig(**kw))
    got = tboxes.extract_boxes(t(tm), t(lm), t(mask), OcrConfig(**kw))
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert valid.sum() >= 5
    np.testing.assert_allclose(got["corners"].numpy()[valid], np.asarray(want["corners"])[valid],
                               rtol=0, atol={"exact": CORNER_ATOL, "pca": PCA_ATOL, "axis": 0}[fit])


def test_extract_crops_perspective_batched():
    rng = np.random.default_rng(0)
    b, h, w, c, k = 3, 60, 90, 3, 24
    img = rng.integers(0, 256, (b, h, w, c)).astype(np.uint8)
    page = rng.integers(0, b, k).astype(np.int32)
    cx, cy = rng.uniform(-5, w + 5, k), rng.uniform(-5, h + 5, k)  # some reach past the page
    th, a, bb = rng.uniform(-1, 1, k), rng.uniform(5, 40, k), rng.uniform(2, 10, k)

    def at(u, v):
        return np.stack([cx + u * np.cos(th) - v * np.sin(th),
                         cy + u * np.sin(th) + v * np.cos(th)], -1)

    corners = np.stack([at(-a, -bb), at(a, -bb), at(a, bb), at(-a, bb)], 1).astype(np.float32)
    want = jwarp.extract_crops_perspective_batched(jnp.asarray(img), jnp.asarray(page),
                                                   jnp.asarray(corners), 32, 128)
    got = twarp.extract_crops_perspective_batched(t(img), t(page), t(corners), 32, 128)
    assert got.shape == (k, 32, 128, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=CROP_ATOL)


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def engines(record):
    base = record["base"]
    return {fit: tuatara_tpu_torch.OcrEngine(
        OcrConfig(**base, **record["variants"][f"rotated_{fit}"]["config"]),
        weights_dir=GOLDEN, device="cpu") for fit in ("exact", "pca")}


@pytest.mark.parametrize("fit", ["exact", "pca"])
@pytest.mark.parametrize("name", PAGES)
def test_engine_rotated_matches_jax(engines, record, fit, name):
    assert_same_words(engines[fit].run(image(name)),
                      record["variants"][f"rotated_{fit}"]["pages"][name])


def test_engine_rotated_record_is_live_jax(record):
    """The JAX engine, run live on one page, equals its record."""
    cfg = {**record["base"], **record["variants"]["rotated_exact"]["config"]}
    assert cfg == {"max_label_length": 7, "compute_dtype": "float32", "box_mode": "rotated",
                   "rotated_fit": "exact"}
    live = words(JaxEngine(JaxOcrConfig(**cfg), weights_dir=GOLDEN).run(image("rotated_text")))
    assert_same_words(live, record["variants"]["rotated_exact"]["pages"]["rotated_text"],
                      atol=1e-6)


def test_rotated_detect_gives_corners(engines):
    """detect() hands the crop corners [B, K, 4, 2]; the bbox is the AABB
    of the valid corners, rounded; warmup sizes its slab the same way and
    leaves `run` unchanged."""
    eng = engines["exact"]
    img = image("rotated_text")
    det = eng.detect(torch.from_numpy(img[None]))
    k = eng.config.max_boxes
    assert det["rects"].shape == (1, k, 4, 2) and det["bbox"].shape == (1, k, 4)
    n = int(det["count"][0])
    c = det["rects"][0, :n]
    want = torch.floor(torch.cat([c.amin(1), c.amax(1)], -1) + 0.5)
    assert torch.equal(det["bbox"][0, :n], want)
    before = eng.run(img)
    eng.warmup(*img.shape[:2])
    assert eng.run(img) == before
