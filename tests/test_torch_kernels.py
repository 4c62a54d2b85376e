"""The port's kernel modules on the CPU: their plain versions against the
JAX package's Pallas kernels (interpret mode) and XLA paths, bit for bit:
K1 (labels + aux), K4 (labels only), K2 (area filter), K3 (counts), K5
(counts + peak, -1e30 in empty slots) and the filtered root selection of
both detection branches.

The CUDA labeler of K1 and K4 (csrc/cc.cu) is held here through a numpy
model of its passes: run-start parents per 32-pixel warp segment (ballot +
clz), unions only across segment borders and the reduced vertical ones,
atomicMin linking with retries, run with its unions interleaved in several
seeded random orders, then flatten and the aux minimum.

The CUDA statistics kernel of K3 and K5 (csrc/stats.cu) is held here the
same way: a numpy model of its roots' hash table (the kernel's own hash,
roots chosen to collide, inserted in two orders), its column strips and
row bands that each write their whole block, and K5's per-band peak
partials with their reduction.

The CUDA area filter of K2 (csrc/cc.cu) is held here through a numpy model
of its one pass: 32x32 tiles (and tiles that do not divide the image)
staged with a halo of min_area-1 pixels (-1 beyond the image), each label
counted over that region (the CTA's hash table, filled by runs of equal
labels within a warp's 32 lanes), background written at once, and a
foreground pixel passing when its label's count reaches min_area.

The CUDA kernels themselves run only on the card; `chip_smoke.py` holds
them against these plain versions there. Here the wrappers must take the
plain path for CPU tensors and count no launch.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tuatara_tpu.ops.connected_components import (
    component_roots_filtered as jax_roots_filtered,
    label_components as jax_label,
    label_components_aux as jax_label_aux,
)
from tuatara_tpu.ops.pallas.cc import (
    area_ok_pallas, label_components_pallas, label_components_pallas_aux,
)
from tuatara_tpu.ops.pallas.stats import component_stats as pallas_stats
from tuatara_tpu.ops.pallas.stats import component_stats_nopeak as pallas_stats_nopeak
from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
from tuatara_tpu_torch.kernels import cc as tcc
from tuatara_tpu_torch.kernels import stats as tstats
from tuatara_tpu_torch.ops import connected_components as tplain

from torch_common import torch_threads  # noqa: F401

BIG = 2**30


def _snake(h=32, w=128):
    """One component winding through every other row (the JAX labeler's
    slow case, tests/test_pallas.py)."""
    m = np.zeros((h, w), bool)
    for i in range(0, h, 2):
        m[i, :] = True
    for i in range(0, h - 2, 4):
        m[i + 1, -1] = True
    for i in range(2, h - 1, 4):
        m[i + 1, 0] = True
    return m


def _masks():
    rng = np.random.default_rng(0)
    cases = []
    for p in (0.35, 0.55):
        m = rng.random((64, 128)) < p
        cases.append((f"random{p}", m, m & (rng.random((64, 128)) < 0.08)))
    snake = _snake()
    hot = np.zeros_like(snake)
    hot[30, 5] = True  # one hot pixel far from the root
    cases.append(("snake", snake, hot))
    cases.append(("empty", np.zeros((32, 128), bool), np.zeros((32, 128), bool)))
    return cases


def _stress_masks(h=20, w=100):
    """The labeler's hard cases at a small size whose rows cross three
    32-pixel segment borders and end inside a segment: full-width rows, a
    serpentine, a comb (teeth joined only by the bottom row), pixels that
    touch only diagonally, all foreground, and a random mask."""
    rows = np.zeros((h, w), bool)
    rows[::2] = True
    comb = np.zeros((h, w), bool)
    comb[:, ::2] = True
    comb[-1] = True
    yy, xx = np.mgrid[:h, :w]
    rng = np.random.default_rng(5)
    return [("rows", rows), ("serpentine", _snake(h, w)), ("comb", comb),
            ("diagonal", (yy + xx) % 2 == 0), ("all", np.ones((h, w), bool)),
            ("random", rng.random((h, w)) < 0.55)]


def _find(parent, x):
    while parent[x] != x:
        x = parent[x]
    return x


def _unite(parent, a, b):
    """cc.cu's unite as a sequence of steps: the finds, then one atomicMin
    of the larger root's parent; another union may run between steps, so
    a root found may have been linked by the time it is used."""
    while True:
        a, b = _find(parent, a), _find(parent, b)
        if a == b:
            return
        a, b = min(a, b), max(a, b)
        yield
        old = parent[b]
        parent[b] = min(old, a)  # atomicMin
        if old == b:
            return
        b = old


def _model_labeler(mask, aux, rng):
    """csrc/cc.cu's cc_label on numpy: -> (labels, auxmin, unions run)."""
    h, w = mask.shape
    flat, hot = mask.reshape(-1), aux.reshape(-1)
    parent = np.full(h * w, -1, np.int64)
    for y in range(h):  # 1. run starts inside each 32-pixel segment
        for x0 in range(0, w, 32):
            lanes = range(min(32, w - x0))
            bits = sum(1 << lane for lane in lanes if mask[y, x0 + lane])  # ballot
            for lane in lanes:
                i = y * w + x0 + lane
                if flat[i]:
                    gaps = ~bits & ((1 << lane) - 1)
                    start = gaps.bit_length()  # 32 - clz(gaps); 0 without gaps
                    parent[i] = i - (lane - start)
    unions = []  # 2. segment borders; vertical unless joined via the left
    for i in np.flatnonzero(flat):
        y, x = divmod(int(i), w)
        left = x > 0 and flat[i - 1]
        if x % 32 == 0 and left:
            unions.append(_unite(parent, i, i - 1))
        if y > 0 and flat[i - w] and not (left and flat[i - w - 1]):
            unions.append(_unite(parent, i, i - w))
    n_unions = len(unions)
    while unions:  # interleaved in a random order, one step at a time
        k = int(rng.integers(len(unions)))
        try:
            next(unions[k])
        except StopIteration:
            unions.pop(k)
    labels = np.full(h * w, -1, np.int64)  # 3. flatten, aux min per root
    auxmin = np.full(h * w, BIG, np.int64)
    for i in np.flatnonzero(flat):
        labels[i] = _find(parent, i)
        if hot[i]:
            auxmin[labels[i]] = min(auxmin[labels[i]], i)
    for i in np.flatnonzero(flat):  # 4. gather
        auxmin[i] = auxmin[labels[i]]
    return labels.reshape(h, w), auxmin.reshape(h, w), n_unions


@pytest.mark.parametrize("name,mask", _stress_masks(), ids=lambda v: v if isinstance(v, str) else "")
def test_labeler_model_matches_plain_and_jax(name, mask):
    """The CUDA labeler's passes (numpy model), with its unions in three
    seeded interleavings, == the plain version == JAX's Pallas labeler
    (interpret), labels and aux minimum, bit for bit."""
    hot = mask & (np.random.default_rng(11).random(mask.shape) < 0.1)
    want = tplain.label_components(torch.from_numpy(mask)).numpy()
    want_aux = tplain.aux_min(torch.from_numpy(want), torch.from_numpy(hot)).numpy()
    pl_lab, pl_iters = label_components_pallas(jnp.array(mask), interpret=True)
    assert int(pl_iters) < 64
    np.testing.assert_array_equal(want, np.asarray(pl_lab))
    for seed in range(3):
        lab, aux, n_unions = _model_labeler(mask, hot, np.random.default_rng(seed))
        np.testing.assert_array_equal(lab, want)
        np.testing.assert_array_equal(aux, want_aux)
    h, w = mask.shape
    if name == "all":  # the skip rule: column 0 vertically, segment borders
        assert n_unions == (h - 1) + h * (-(-w // 32) - 1)
    if name == "diagonal":
        assert n_unions == 0


@pytest.mark.parametrize("name,mask,hot", _masks(), ids=lambda v: v if isinstance(v, str) else "")
def test_label_components_aux_plain_matches_jax(name, mask, hot):
    """K1's plain version == the Pallas kernel (interpret) == the XLA
    fixpoint, exactly; the JAX labelers must have converged (< 64 sweeps)."""
    ref_lab, ref_aux, iters = jax_label_aux(jnp.array(mask), jnp.array(hot))
    pl_lab, pl_aux, pl_iters = label_components_pallas_aux(
        jnp.array(mask), jnp.array(hot), interpret=True)
    assert int(iters) < 64 and int(pl_iters) < 64
    lab, aux = tcc.label_components_aux(torch.from_numpy(mask), torch.from_numpy(hot))
    assert lab.dtype == torch.int32 and aux.dtype == torch.int32
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref_lab))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(pl_lab))
    np.testing.assert_array_equal(aux.numpy(), np.asarray(ref_aux))
    np.testing.assert_array_equal(aux.numpy(), np.asarray(pl_aux))
    # background and hot-less components hold exactly 2**30
    assert (aux.numpy()[~mask] == BIG).all()


@pytest.mark.parametrize("name,mask,hot", _masks(), ids=lambda v: v if isinstance(v, str) else "")
def test_label_components_plain_matches_jax(name, mask, hot):
    """K4's plain version == the Pallas kernel (interpret) == the XLA
    fixpoint, exactly (the JAX labelers converged: < 64 sweeps)."""
    ref, iters = jax_label(jnp.array(mask))
    pl_lab, pl_iters = label_components_pallas(jnp.array(mask), interpret=True)
    assert int(iters) < 64 and int(pl_iters) < 64
    lab = tcc.label_components(torch.from_numpy(mask))
    assert lab.dtype == torch.int32
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(pl_lab))


def test_label_components_true_components():
    """Union-find semantics: labels are the min raster index of the true
    4-connected components (brute-force flood fill)."""
    rng = np.random.default_rng(3)
    m = rng.random((40, 50)) < 0.5
    lab = tplain.label_components(torch.from_numpy(m)).numpy()
    want = -np.ones(m.shape, np.int64)
    h, w = m.shape
    for start in range(h * w):
        y, x = divmod(start, w)
        if not m[y, x] or want[y, x] >= 0:
            continue
        stack = [(y, x)]
        want[y, x] = start
        while stack:
            cy, cx = stack.pop()
            for ny, nx in ((cy - 1, cx), (cy + 1, cx), (cy, cx - 1), (cy, cx + 1)):
                if 0 <= ny < h and 0 <= nx < w and m[ny, nx] and want[ny, nx] < 0:
                    want[ny, nx] = start
                    stack.append((ny, nx))
    np.testing.assert_array_equal(lab, want)


@pytest.mark.parametrize("min_area", [1, 4, 10])
def test_area_ok_plain_matches_pallas(min_area):
    """K2's plain version (exact histogram) == the windowed Pallas kernel
    (interpret), which is exact when 2m-1 <= min(H, W)."""
    rng = np.random.default_rng(min_area)
    m = rng.random((32, 128)) < 0.4
    labels, _, _ = jax_label_aux(jnp.array(m), jnp.array(m))
    ref = np.asarray(area_ok_pallas(labels, min_area, interpret=True))
    got = tcc.area_ok(torch.from_numpy(np.array(labels)), min_area)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)


def _model_area_table(staged):
    """The CTA's hash table of a staged region, {label: count}, built as
    the kernel does: warps of 32 consecutive labels (the last padded with
    -1) split at each lane whose label differs from the lane below (lane 0
    always starts a run), and each run of a label adds its length."""
    flat = staged.reshape(-1)
    pad = -len(flat) % 32
    lanes = np.concatenate([flat, np.full(pad, -1, flat.dtype)]).reshape(-1, 32)
    starts = np.ones(lanes.shape, bool)
    starts[:, 1:] = lanes[:, 1:] != lanes[:, :-1]
    table = {}
    for row, st in zip(lanes, starts):
        pos = np.flatnonzero(st)
        runs = np.diff(np.append(pos, 32))  # up to the next run's start
        for p, n in zip(pos, runs):
            if row[p] >= 0:
                table[int(row[p])] = table.get(int(row[p]), 0) + int(n)
    return table


def _model_area_ok(labels, m, tile=32):
    """csrc/cc.cu's area_ok_region on numpy: each tile's labels staged with
    a halo of m-1 pixels (-1 beyond the image), each label counted over
    that region, ok = count >= m at the tile's foreground pixels. ->
    (ok [H, W] bool, region count [H, W], -1 at background)."""
    h, w = labels.shape
    r = m - 1
    side = tile + 2 * r
    ok = np.zeros((h, w), bool)
    counts = np.full((h, w), -1, np.int64)
    for by in range(0, h, tile):
        for bx in range(0, w, tile):
            staged = np.full((side, side), -1, np.int64)
            y0, x0 = by - r, bx - r
            ya, xa, yb, xb = max(y0, 0), max(x0, 0), min(y0 + side, h), min(x0 + side, w)
            staged[ya - y0:yb - y0, xa - x0:xb - x0] = labels[ya:yb, xa:xb]
            table = _model_area_table(staged)
            th, tw = min(tile, h - by), min(tile, w - bx)
            c = staged[r:r + th, r:r + tw]
            cnt = np.array([table.get(int(v), -1) for v in c.reshape(-1)]).reshape(th, tw)
            cnt[c < 0] = -1  # background is written 0 without a lookup
            counts[by:by + th, bx:bx + tw] = cnt
            ok[by:by + th, bx:bx + tw] = cnt >= m
    return ok, counts


def _area_cases():
    """(m, label, labels [45, 38] int32) for K2: the stress shapes of
    chip_smoke.area_stress_masks (areas m-1, m, m+1 across tile and image
    borders; all foreground; empty) and two seeded random masks, at
    m = 1, 2, 10, 16 (2m-1 <= 38, where the Pallas kernel is exact)."""
    from chip_smoke import area_stress_masks

    rng = np.random.default_rng(11)
    cases = []
    for m in (1, 2, 10, 16):
        masks = area_stress_masks(m, 45, 38, seed=m)
        masks += [(f"random{p}", rng.random((45, 38)) < p) for p in (0.3, 0.55)]
        for label, mask in masks:
            lab = tplain.label_components(torch.from_numpy(mask)).numpy()
            cases.append((m, label, lab))
    return cases


@pytest.mark.parametrize("m,label,lab", _area_cases(),
                         ids=lambda v: str(v) if not isinstance(v, np.ndarray) else "")
def test_area_ok_model_matches_plain_and_pallas(m, label, lab):
    """The CUDA area filter's pass (numpy model) at tiles of 32, 13 and 8
    pixels (none divides 45 or 38) == the plain version (area histogram)
    == the Pallas kernel (interpret), bit for bit; a region's count of a
    label lies between min(area, m) and the area."""
    want = tplain.area_ok(torch.from_numpy(lab), m).numpy()
    ref = np.asarray(area_ok_pallas(jnp.array(lab), m, interpret=True))
    np.testing.assert_array_equal(want, ref)
    np.testing.assert_array_equal(tcc.area_ok(torch.from_numpy(lab), m).numpy(), want)
    fg = lab >= 0
    values, inverse, areas = np.unique(lab[fg], return_inverse=True, return_counts=True)
    area = np.zeros(lab.shape, np.int64)
    area[fg] = areas[inverse]
    for tile in (32, 13, 8):
        got, counts = _model_area_ok(lab, m, tile)
        np.testing.assert_array_equal(got, want)
        assert (counts[~fg] == -1).all()
        assert (counts[fg] <= area[fg]).all()
        assert (counts[fg] >= np.minimum(area[fg], m)).all()


def test_area_ok_outside_window_range():
    """K2 takes 1 <= min_area <= 16 (ValueError otherwise); extract_boxes
    takes the plain area count outside that range, as JAX's gate does."""
    import dataclasses

    from tuatara_tpu_torch.config import OcrConfig
    from tuatara_tpu_torch.ops.boxes import extract_boxes

    lab = tplain.label_components(torch.from_numpy(_snake()))
    for m in (0, 17):
        with pytest.raises(ValueError):
            tcc.area_ok(lab, m)
    rng = np.random.default_rng(4)
    text = torch.from_numpy(rng.random((40, 48)).astype(np.float32))
    link = torch.from_numpy(rng.random((40, 48)).astype(np.float32))
    content = torch.ones(40, 48, dtype=torch.bool)
    for m in (0, 17, 40):
        cfg = dataclasses.replace(OcrConfig(), min_component_area=m, max_boxes=16)
        det = extract_boxes(text, link, content, cfg)
        assert det["boxes"].shape == (16, 4)


@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("h", [32, 40])
def test_stats_nopeak_plain_matches_pallas(K, h):
    """K3's plain version == the Pallas kernel (interpret), bit for bit,
    with roots from the JAX filtered root selection (padded with 2**30)."""
    rng = np.random.default_rng(h + K)
    m = rng.random((h, 128)) < 0.3
    hot = m & (rng.random((h, 128)) < 0.3)
    labels, hot_min, _ = jax_label_aux(jnp.array(m), jnp.array(hot))
    roots, _ = jax_roots_filtered(labels, K, 3, hot_min=hot_min, area_ok_map=None)
    if K == 256:
        assert int((np.asarray(roots) == BIG).sum()) > 0  # padding is exercised
    keep = rng.random((h, 128)) < 0.8
    ref = pallas_stats_nopeak(labels, jnp.array(keep), roots, interpret=True)
    got = tstats.component_stats_nopeak(torch.from_numpy(np.array(labels)),
                                        torch.from_numpy(keep),
                                        torch.from_numpy(np.array(roots)))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("h", [32, 40])
def test_stats_peak_plain_matches_pallas(K, h):
    """K5's plain version == the Pallas kernel (interpret), bit for bit:
    counts, and the peak of tn with exactly -1e30 in the padding slots,
    with roots from the JAX selection of the text_threshold < low_text
    branch."""
    rng = np.random.default_rng(h * K)
    m = rng.random((h, 128)) < 0.3
    hot = m & (rng.random((h, 128)) < 0.3)
    keep = rng.random((h, 128)) < 0.8
    tn = rng.random((h, 128)).astype(np.float32)
    labels, _ = jax_label(jnp.array(m))
    roots, _ = jax_roots_filtered(labels, K, 3, jnp.array(hot), jnp.array(keep),
                                  hot_implies_keep=False)
    if K == 256:
        assert int((np.asarray(roots) == BIG).sum()) > 0  # padding slots are exercised
    ref = pallas_stats(labels, jnp.array(tn), jnp.array(keep), roots, interpret=True)
    got = tstats.component_stats(torch.from_numpy(np.array(labels)), torch.from_numpy(tn),
                                 torch.from_numpy(keep), torch.from_numpy(np.array(roots)))
    assert len(got) == 5
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got[4].numpy()[np.asarray(roots) == BIG] == np.float32(-1e30)).all()


def _ordered(x):
    """stats.cu's `ordered`: float32 -> int whose order is the float order."""
    b = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(b >= 0, b, b ^ 0x7FFFFFFF)


def _unordered(v):
    b = np.where(v >= 0, v, v ^ 0x7FFFFFFF).astype(np.int32)
    return b.view(np.float32)


def _model_table(roots, n, order):
    """The CTA's hash table of the roots, inserted in `order` (atomicCAS
    claims the first free bucket of the root's probe sequence):
    -> lookup(label)."""
    k = len(roots)
    size = 1 << tstats.table_bits(k)
    keys, slots = [-1] * size, [-1] * size
    for j in order:
        r = int(roots[j])
        if r < 0 or r >= n:
            continue  # padding
        i = 0
        while keys[tstats.table_probe(r, k, i)] != -1:
            i += 1
        keys[tstats.table_probe(r, k, i)], slots[tstats.table_probe(r, k, i)] = r, j

    def lookup(lab):
        if lab < 0:
            return -1
        for i in range(size):
            b = tstats.table_probe(int(lab), k, i)
            if keys[b] == lab:
                return slots[b]
            if keys[b] < 0:
                return -1
        return -1

    return lookup


def _model_stats(labels, keep, tn, roots, bh, bw, order):
    """csrc/stats.cu's component_stats<true> on numpy: strips of bw columns
    write their [bw, K] blocks of col/rcol, bands of bh rows their blocks of
    row/rrow and a peak partial row; the partials' max over the bands is the
    peak. Outputs start as NaN (torch.empty), so an entry no item writes
    shows."""
    h, w = labels.shape
    k = len(roots)
    lookup = _model_table(roots, h * w, order)
    slot = np.vectorize(lookup, otypes=[np.int64])(labels)
    row, rrow = np.full((h, k), np.nan, np.float32), np.full((h, k), np.nan, np.float32)
    col, rcol = np.full((w, k), np.nan, np.float32), np.full((w, k), np.nan, np.float32)
    empty = int(_ordered(np.float32(-1e30)))
    partial = []
    for x0 in range(0, w, bw):  # strips
        cnt, rcnt = np.zeros((bw, k), np.int64), np.zeros((bw, k), np.int64)
        for y in range(h):
            for xl in range(min(bw, w - x0)):
                s = slot[y, x0 + xl]
                if s >= 0:
                    cnt[xl, s] += 1
                    rcnt[xl, s] += keep[y, x0 + xl]
        nl = min(bw, w - x0)
        col[x0:x0 + nl], rcol[x0:x0 + nl] = cnt[:nl], rcnt[:nl]
    for y0 in range(0, h, bh):  # bands
        nl = min(bh, h - y0)
        cnt, rcnt = np.zeros((bh, k), np.int64), np.zeros((bh, k), np.int64)
        pk = np.full(k, empty, np.int64)
        for yl in range(nl):
            for x in range(w):
                s = slot[y0 + yl, x]
                if s >= 0:
                    cnt[yl, s] += 1
                    rcnt[yl, s] += keep[y0 + yl, x]
                    pk[s] = max(pk[s], int(_ordered(tn[y0 + yl, x])))
        row[y0:y0 + nl], rrow[y0:y0 + nl] = cnt[:nl], rcnt[:nl]
        partial.append(pk)
    peak = _unordered(np.max(np.stack(partial), axis=0))
    return row, col, rrow, rcol, peak


def _collision_roots(labels, K, rng):
    """K roots in a shuffled order: about K/2 of the image's component
    labels, each of the first four joined by another index below H*W with
    the same home bucket in the kernel's table for K (a second label where
    one shares it, else an index that labels nothing), and padding 2**30.
    -> (roots, groups of roots that share a home bucket)."""
    n = labels.size
    home = np.array([tstats.table_probe(i, K) for i in range(n)])
    present = np.unique(labels[labels >= 0])
    chosen = list(rng.permutation(present)[:K // 2])
    if not chosen:
        chosen = [int(rng.integers(n))]  # a root that labels nothing
    groups = []
    for r in chosen[:4]:
        mates = [int(i) for i in np.flatnonzero(home == home[r]) if i != r and i not in chosen]
        if mates:
            labelled = [i for i in mates if i in set(present.tolist())]
            mate = (labelled or mates)[0]
            chosen.append(mate)
            groups.append((int(r), mate, int(home[r])))
    roots = np.full(K, BIG, np.int32)
    roots[:len(chosen)] = chosen[:K]
    return rng.permutation(roots).astype(np.int32), groups


def _stats_masks():
    return _stress_masks() + [("empty", np.zeros((20, 100), bool))]


@pytest.mark.parametrize("K", [16, 128, 256])
@pytest.mark.parametrize("name,mask", _stats_masks(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_stats_model_matches_plain_and_pallas(name, mask, K):
    """The CUDA statistics kernel's passes (numpy model: hash table with
    colliding roots inserted in two orders; strips and bands of several
    sizes, 8-column strips and 10-row bands among them (the kernel's sizing
    at 512x384 and K = 256); peak partials reduced over the bands)
    == the plain versions of K3 and K5 == the Pallas kernels (interpret),
    bit for bit. Pallas takes H a multiple of 8 and K of 128: its inputs
    get background rows and padding roots, sliced off after."""
    rng = np.random.default_rng(K * 31 + len(name))
    h, w = mask.shape
    keep = rng.random((h, w)) < 0.8
    tn = rng.random((h, w)).astype(np.float32)
    labels = tplain.label_components(torch.from_numpy(mask)).numpy()
    roots, groups = _collision_roots(labels, K, rng)
    assert groups, "no pair of roots shares a home bucket"
    t_args = [torch.from_numpy(a) for a in (labels, keep, roots)]
    want = [t.numpy() for t in tstats.component_stats_plain(
        t_args[0], torch.from_numpy(tn), t_args[1], t_args[2])]
    want3 = [t.numpy() for t in tstats.component_stats_nopeak_plain(*t_args)]
    for a, b in zip(want[:4], want3):
        np.testing.assert_array_equal(a, b)

    hp, kp = -(-h // 8) * 8, -(-K // 128) * 128
    pad = lambda a, v: np.pad(a, ((0, hp - h), (0, 0)), constant_values=v)
    roots_p = np.concatenate([roots, np.full(kp - K, BIG, np.int32)])
    ref = pallas_stats(jnp.array(pad(labels, -1)), jnp.array(pad(tn, 0)),
                       jnp.array(pad(keep, False)), jnp.array(roots_p), interpret=True)
    ref3 = pallas_stats_nopeak(jnp.array(pad(labels, -1)), jnp.array(pad(keep, False)),
                               jnp.array(roots_p), interpret=True)
    for got, full in zip(want, ref):
        full = np.asarray(full)
        np.testing.assert_array_equal(got, full[..., :K] if full.ndim == 1
                                      else full[:got.shape[0], :K])
    for got, full in zip(want3, ref3):
        np.testing.assert_array_equal(got, np.asarray(full)[:got.shape[0], :K])

    for bh, bw in ((3, 8), (2, 3), (10, 8)):
        for order in (range(K), range(K - 1, -1, -1)):
            model = _model_stats(labels, keep, tn, roots, bh, bw, order)
            for m, want_t in zip(model, want):
                np.testing.assert_array_equal(m, want_t)
    empty = roots >= labels.size
    assert (want[4][empty] == np.float32(-1e30)).all()


def test_stats_table_probe_visits_every_bucket():
    """The mirror of csrc/stats.cu's hash: at least 256 buckets and at least
    2K; the home bucket is the top bits of key * 2^32/phi; a probe sequence
    visits every bucket once, so an insertion always finds a free one and a
    miss always reaches an empty one."""
    assert [tstats.table_bits(k) for k in (1, 16, 128, 129, 1024, 8192)] == [8, 8, 8, 9, 11, 14]
    assert tstats.table_probe(0, 16) == 0
    assert tstats.table_probe(1, 16) == 0x9E
    assert tstats.table_probe(1, 16, 1) == (0x9E + 0x85) % 256
    for key in (3, 977, 2**20 + 5):
        assert sorted(tstats.table_probe(key, 256, i) for i in range(512)) == list(range(512))


@pytest.mark.parametrize("K", [8, 64, 256])
def test_component_roots_filtered_hot_keep_matches_jax(K):
    """Roots of the text_threshold < low_text branch, selected by the hot
    and keep pixel masks (JAX's hot_implies_keep=False): equal to the JAX
    selection, area filter by histogram there and by K2's plain version
    here. Link-only hot pixels make presence of both differ from presence
    of a pixel that is both."""
    rng = np.random.default_rng(K)
    m = rng.random((64, 128)) < 0.45
    hot = m & (rng.random((64, 128)) < 0.05)
    keep = rng.random((64, 128)) < 0.7
    labels, _ = jax_label(jnp.array(m))
    ref, ref_n = jax_roots_filtered(labels, K, 4, jnp.array(hot), jnp.array(keep),
                                    hot_implies_keep=False)
    t_lab = torch.from_numpy(np.array(labels))
    got, n = tplain.component_roots_filtered(
        t_lab, K, None, tplain.area_ok(t_lab, 4), hot=torch.from_numpy(hot),
        keep=torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(n) == int(ref_n)


@pytest.mark.parametrize("K", [8, 256])
def test_component_roots_filtered_matches_jax(K):
    """Roots: the K smallest passing raster indices, ascending, padded with
    2**30 — equal to the JAX selection (area filter by histogram)."""
    rng = np.random.default_rng(K)
    m = rng.random((64, 128)) < 0.4
    hot = m & (rng.random((64, 128)) < 0.1)
    labels, hot_min, _ = jax_label_aux(jnp.array(m), jnp.array(hot))
    ref, ref_n = jax_roots_filtered(labels, K, 5, hot_min=hot_min, area_ok_map=None)
    t_lab = torch.from_numpy(np.array(labels))
    got, n = tplain.component_roots_filtered(
        t_lab, K, torch.from_numpy(np.array(hot_min)), tplain.area_ok(t_lab, 5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(n) == int(ref_n)


def test_wrappers_take_plain_path_on_cpu_without_launching():
    """CPU tensors go to the plain versions: no build, no launch counted."""
    reset_launches()
    m = torch.from_numpy(_snake())
    lab, aux = tcc.label_components_aux(m, m)
    ok = tcc.area_ok(lab, 10)
    roots, _ = tplain.component_roots_filtered(lab, 16, aux, ok)
    tstats.component_stats_nopeak(lab, torch.ones_like(m), roots)
    lab = tcc.label_components(m)
    tstats.component_stats(lab, torch.rand(m.shape), torch.ones_like(m), roots)
    assert sum(LAUNCHES.values()) == 0


def test_build_names_sources_without_compiling(tmp_path, monkeypatch):
    """The build step hashes each source with its flags into the library
    name (an edited source gets a new library) and builds nothing at
    import."""
    from tuatara_tpu_torch.kernels import _build

    assert set(_build.SOURCES) == {"cc", "stats", "vit", "decode", "stage1", "hull"}
    for name in _build.SOURCES:
        target = _build._target(name)
        assert target.startswith(_build.BUILD_DIR) and target.endswith(".so")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not _build._libs
    src = tmp_path / "cc.cu"
    src.write_text("// a")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    first = _build._target("cc")
    src.write_text("// b")
    assert _build._target("cc") != first
