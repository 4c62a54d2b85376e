"""A numpy model of `csrc/bias_act.cu`'s work assignment, on the CPU.

The kernel (BA, `kernels/bias_act.py`) picks one of three routes a call
(`plan` in the source) and maps threads to elements with no division in
its loops. There is no nvcc here, so the source is checked on the card by
`chip_smoke.py` (phase 10a: every mode bit-equal to its plain version on
the default path's calls and the edge cases below); this file mirrors its
constants, `plan`, `row_shape` and the three index maps, and holds:

* every element is written exactly once, with its own bias channel
  ((i / div) % C) and, in the fp32 mode, its own residual element
  (i % period), whatever the grid (the card sizes it by occupancy, which
  the CPU cannot read: 1 CTA, a few, 132 x 8 and more than the work);
* the routes of the path's calls: CRAFT's ReLU convs at the four pages'
  maps under `OcrConfig()` in channels_last memory (rows) and contiguous
  (planes, the training graph's layout); PARSEQ's [N, S, 384 / 1536]
  and the head's [N, T, 96] (rows), the residuals [N, S, D], [1, S, D]
  (`pos_embed`) and [1, 1, D] (rows, one residual row a row);
* the scalar branch takes exactly the calls the vectorised routes cannot:
  95 channels, a map whose planes are not a multiple of 8 elements, a
  view 2 bytes off 16-byte alignment, more than 2048 channels; and a call
  smaller than one CTA still takes its vectorised route;
* 32-bit offsets (n <= 2^30) cannot overflow in the loops;
* the wrapper's layout code (`_channel_divisor`, the stride along the
  channel dimension) is the `div` the model takes.
"""

import numpy as np
import pytest
import torch

from torch_common import torch_threads  # noqa: F401
from tuatara_tpu_torch.kernels import bias_act as BA
from tuatara_tpu_torch.ops.resize import canvas_shape
from tuatara_tpu_torch import OcrConfig

# csrc/bias_act.cu's constants.
UNROLL, ROW_THREADS, THREADS = 4, 256, 256
MAX_GROUPS = ROW_THREADS
PLANE_CHUNK = THREADS * 8 * UNROLL
MAX_I32 = 1 << 30
ROWS, PLANES, SCALAR = "rows", "planes", "scalar"
# Grids to model: the card's is min(the work, resident CTAs), and the
# resident count comes from the occupancy query there.
GRIDS = (1, 3, 132 * 8, 1 << 20)

# The four main-path pages (height, width) and CRAFT's ReLU-followed convs
# (channels, downscale) in the default path's order: the trunk's 12, each
# decoder level's conv2, the head's conv1-4 (20 a page).
PAGES = {"resume_example": (763, 607), "funsd_0001129658": (1000, 754),
         "funsd_91372360": (1000, 814), "table_english": (664, 1245)}
CRAFT_RELU = ([(64, 1)] * 2 + [(128, 2)] * 2 + [(256, 4)] * 3 + [(512, 8)] * 3 + [(512, 16)] * 2
              + [(256, 16), (128, 8), (64, 4), (32, 2)] + [(32, 2)] * 2 + [(16, 2)] * 2)


def plan(n, c, div, period, aligned, res):
    """`plan` of csrc/bias_act.cu."""
    if not aligned:
        return SCALAR
    if div == 1 and c % 8 == 0 and c // 8 <= MAX_GROUPS and n % c == 0 and (
            not res or period % c == 0):
        return ROWS
    if div > 1 and div % 8 == 0 and not res and n % (div * c) == 0:
        return PLANES
    return SCALAR


def row_shape(c):
    """`row_shape`: (G, rows a CTA)."""
    g = c // 8
    return g, ROW_THREADS // g


def rows_visited(rows, c, grid):
    """The rows route's loop (`bias_act_rows` / `bias_add_f32_rows`) for the threads of
    one 8-channel slice, every CTA: -> the rows they visit. A thread's
    slice is tid % G and its row in the CTA tid / G (`slots`), so every
    slice's threads visit the same rows."""
    rpc = row_shape(c)[1]
    step = grid * rpc
    assert rows + UNROLL * step < 2 ** 31 or rows * c > MAX_I32
    r = np.arange(grid * rpc)  # blockIdx.x * rpc + tid / G
    out = []
    while (r < rows).any():
        for u in range(UNROLL):
            ru = r + u * step
            out.append(ru[ru < rows])
        r = r + step * UNROLL
    return np.concatenate(out)


def slots(c):
    """A rows CTA's threads -> (slice, row in the CTA), tid % G and tid / G:
    each pair exactly once."""
    g_count, rpc = row_shape(c)
    tid = np.arange(g_count * rpc)
    pairs = (tid // g_count) * g_count + tid % g_count
    assert g_count * rpc <= ROW_THREADS and np.array_equal(np.sort(pairs), tid)
    return tid % g_count, tid // g_count


def rows_map(n, c, grid, period=None):
    """The rows route's writes, element by element: -> (element index,
    channel, residual index or None) of every write, all threads."""
    g, _ = slots(c)
    ru = rows_visited(n // c, c, grid)
    gk = (np.unique(g)[:, None] * 8 + np.arange(8)).ravel()  # a row's channels, by slice
    elem = (ru[:, None] * c + gk[None, :]).ravel()
    chan = np.broadcast_to(gk, (ru.size, gk.size)).ravel()
    res = None
    if period is not None:
        res = ((ru % (period // c))[:, None] * c + gk[None, :]).ravel()
    return elem, chan, res


def planes_visited(planes, grid_y):
    """The planes route's CTAs along y walking the planes -> planes visited."""
    gy = min(planes, grid_y)
    return np.concatenate([np.arange(by, planes, gy) for by in range(gy)])


def plane_offsets(hw):
    """A plane's 8-element groups as its grid.x CTAs' threads and unrolled
    loads reach them -> their first elements."""
    gx = -(-hw // PLANE_CHUNK)
    i0 = (np.arange(gx)[:, None] * PLANE_CHUNK + np.arange(THREADS)[None, :] * 8).ravel()
    offs = (i0[:, None] + np.arange(UNROLL)[None, :] * (THREADS * 8)).ravel()
    return offs[offs < hw]


def planes_map(n, c, hw, grid_y):
    """The planes route's writes (`bias_act_planes` / `bias_add_f32_planes`), element by
    element: -> (element index, channel)."""
    pl = planes_visited(n // hw, grid_y)
    groups = (plane_offsets(hw)[:, None] + np.arange(8)).ravel()
    elem = (pl[:, None] * hw + groups[None, :]).ravel()
    return elem, np.repeat(pl % c, groups.size)


def scalar_map(n, c, div, grid, period=None):
    """The scalar route's grid-stride loop (`bias_act_scalar` / `bias_add_f32_scalar`)."""
    step = grid * THREADS
    assert n + step < 2 ** 31 or n > MAX_I32
    i = np.arange(min(grid, -(-n // THREADS)) * THREADS)
    out = []
    while i.size and (i < n).any():
        out.append(i[i < n])
        i = i + step
    elem = np.concatenate(out)
    return elem, (elem // div) % c, None if period is None else elem % period


def check_written_once(n, c, div, elem, chan, res=None, period=None):
    counts = np.bincount(elem, minlength=n)
    assert counts.size == n and (counts == 1).all(), (n, np.unique(counts))
    np.testing.assert_array_equal(chan, (elem // div) % c)
    if period is not None:
        np.testing.assert_array_equal(res, elem % period)


def route_and_check(n, c, div, aligned=True, period=None, grids=GRIDS):
    """plan() for the call, then its index map over several grids."""
    route = plan(n, c, div, period or 1, aligned, period is not None)
    for grid in grids:
        if route == ROWS:
            elem, chan, res = rows_map(n, c, grid, period)
        elif route == PLANES:
            elem, chan = planes_map(n, c, div, min(grid, 65535))
            res = None
        else:
            elem, chan, res = scalar_map(n, c, div, min(grid, 4096), period)
        check_written_once(n, c, div, elem, chan, res, period)
    return route


def meta(shape, channels_last=False):
    """A tensor of `shape` on the meta device in the given memory format
    (no storage: the wrapper's layout code reads strides only)."""
    t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def path_maps():
    """{(C, H, W)} of CRAFT's ReLU calls on the four pages' default
    canvases."""
    out = set()
    for h, w in PAGES.values():
        ch, cw = canvas_shape(h, w, OcrConfig())[:2]
        out |= {(c, ch // f, cw // f) for c, f in CRAFT_RELU}
    return sorted(out)


def test_path_maps_are_twenty_a_page():
    assert len(CRAFT_RELU) == 20
    assert {c for c, _, _ in path_maps()} == {16, 32, 64, 128, 256, 512}


@pytest.mark.parametrize("channels_last", [True, False], ids=["channels_last", "contiguous"])
def test_craft_maps_of_the_four_pages(channels_last):
    """Every ReLU conv of CRAFT at the four pages' default canvases:
    channels_last memory (serving) takes the rows route, contiguous NCHW
    (training) the planes route; each written once with its channel. The
    model runs at one image of the batch (the routes' maps repeat per
    image: rows and planes both walk whole images), rows and planes at the
    granularity the loops assign them, each element on the smallest map."""
    maps = path_maps()
    for c, h, w in maps:
        t = meta((1, c, h, w), channels_last)
        div = BA._channel_divisor(t, 1)
        assert div == (1 if channels_last else h * w)
        want = ROWS if channels_last else PLANES
        n = c * h * w
        route = plan(n, c, div, 1, True, False)
        assert route == want, (c, h, w, route)
        if route == ROWS:
            # Each thread owns one slice; every slice's threads visit the
            # same rows: rows covered once, at several grids.
            slots(c)
            for grid in GRIDS[:3]:
                assert (np.bincount(rows_visited(h * w, c, grid), minlength=h * w) == 1).all()
        else:
            offs = plane_offsets(h * w)
            assert (np.bincount((offs[:, None] + np.arange(8)).ravel(),
                                minlength=h * w) == 1).all()
            for grid_y in (7, 65535):
                assert (np.bincount(planes_visited(c, grid_y), minlength=c) == 1).all()
        # The element-level map, channels included, on one map a page.
        if (c, h, w) == min(maps, key=lambda m: m[0] * m[1] * m[2]):
            route_and_check(n, c, div, grids=(3, 132 * 8))


@pytest.mark.parametrize("shape,act", [((32, 128, 384), "residual"), ((7, 128, 1536), "gelu"),
                                       ((256, 26, 96), "head"), ((13, 26, 384), "residual")],
                         ids=str)
def test_parseq_rows(shape, act):
    """PARSEQ's Linear calls take the rows route: fc1's GELU at 1536, the
    head's 95 classes padded to 96, the residual Linears at 384."""
    t = meta(shape)
    assert BA._channel_divisor(t, -1) == 1
    n = int(np.prod(shape))
    assert route_and_check(n, shape[-1], 1, grids=(1, 132 * 8)) == ROWS


@pytest.mark.parametrize("rshape", [(32, 128, 384), (1, 128, 384), (1, 1, 384), (384,)],
                         ids=str)
def test_fp32_mode_residual_rows(rshape):
    """The fp32 mode's residual: a whole number of rows a period (the
    wrapper's `residual_period`, no copy for these), each row reading
    residual row row % (period / C): every element meets its own residual
    element (i % period)."""
    y = (32, 128, 384)
    r = torch.zeros(rshape)
    period = BA.residual_period(r, torch.Size(y)).numel()
    assert BA.residual_period(r, torch.Size(y)) is r
    assert period == int(np.prod(rshape))
    assert route_and_check(int(np.prod(y)), 384, 1, period=period, grids=(1, 5, 132 * 8)) == ROWS


@pytest.mark.parametrize("case", ["c95", "planes_not_x8", "two_bytes_off", "c4096",
                                  "residual_unaligned", "small_rows", "small_plane"])
def test_edge_cases_route(case):
    """The calls the vectorised routes cannot take go to the scalar branch,
    and only those; a call smaller than one CTA keeps its route."""
    if case == "c95":
        n, c, div, aligned, want = 3 * 26 * 95, 95, 1, True, SCALAR
    elif case == "planes_not_x8":
        t = meta((2, 6, 5, 7))
        n, c, div, aligned, want = 2 * 6 * 35, 6, BA._channel_divisor(t, 1), True, SCALAR
    elif case == "two_bytes_off":
        # chip_smoke's view: a [1001] tensor from element 1, as [10, 100].
        t = torch.empty(1001, dtype=torch.bfloat16)[1:].view(10, 100)
        aligned = (t.storage_offset() * t.element_size()) % 16 == 0
        n, c, div, want = 1000, 100, BA._channel_divisor(t, -1), SCALAR
        assert not aligned
    elif case == "c4096":
        n, c, div, aligned, want = 2 * 4096, 4096, 1, True, SCALAR
    elif case == "residual_unaligned":
        n, c, div, aligned, want = 26 * 384, 384, 1, False, SCALAR
    elif case == "small_rows":
        n, c, div, aligned, want = 8, 8, 1, True, ROWS
    else:
        n, c, div, aligned, want = 3 * 16, 3, 16, True, PLANES
    period = 384 * 26 if case == "residual_unaligned" else None
    assert route_and_check(n, c, div, aligned, period) == want


def test_scalar_branch_is_exactly_the_rest():
    """Over a grid of (n, C, div, alignment, residual), the scalar branch
    takes a call exactly when a 16-byte group could straddle a channel, a
    plane, a residual period or an unaligned address, or C > 2048."""
    for c in (1, 3, 8, 95, 96, 384, 2048, 2056):
        for div in (1, 8, 35, 64):
            for lead in (1, 3):
                n = lead * c * div
                for aligned in (True, False):
                    for period in (None, c, 2 * c + 8, n):
                        got = plan(n, c, div, period or 1, aligned, period is not None)
                        vector_ok = aligned and (
                            (div == 1 and c % 8 == 0 and c <= 8 * MAX_GROUPS
                             and (period is None or period % c == 0))
                            or (div > 1 and div % 8 == 0 and period is None))
                        assert (got == SCALAR) == (not vector_ok), (c, div, n, aligned, period)
                        if got == ROWS:
                            assert div == 1 and c % 8 == 0
                        if got == PLANES:
                            assert div % 8 == 0 and period is None


def test_int32_offsets_do_not_overflow():
    """n <= 2^30 takes 32-bit offsets: the largest index a loop forms
    (a row or element start plus kUnroll strides of the largest resident
    grid, 132 SMs x 8 CTAs x 256 rows) stays below 2^31."""
    resident = 132 * 8
    for c in (8, 384, 2048):
        rows = MAX_I32 // c
        step = resident * row_shape(c)[1]
        assert rows + UNROLL * step < 2 ** 31
    assert MAX_I32 + resident * THREADS < 2 ** 31
    assert MAX_I32 + PLANE_CHUNK < 2 ** 31
