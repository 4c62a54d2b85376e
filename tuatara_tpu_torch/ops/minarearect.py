"""Exact minimum-area rotated rectangles per component.

Port of `tuatara_tpu/ops/minarearect.py`, which keeps the reference's
`cv::minAreaRect(cv::findNonZero(dilated segmap))` (tuatara.cpp:162-179)
exact in four dense steps:

1. row profiles: every convex-hull vertex of a pixel set is the leftmost
   or rightmost pixel of its row, so a component collapses to its per-row
   x extents [H, K];
2. the reference's square dilation, clipped at the content edge, is a
   sliding min/max over rows plus a constant x offset on those profiles;
3. the hull's left and right chains (the right one is the left chain of
   the x-negated profile) by one monotone-chain pass over the rows: the
   CUDA kernel H1 (`kernels/hull.py`) on the card, its plain version on
   the CPU;
4. the minimum-area rectangle has a side on a hull edge, so every edge
   direction is tried at once as a masked [K, E, P] projection min/max,
   and the smallest area wins (first on ties, as in JAX).

Coordinates are small integers held in fp32, so the profiles and the hull
are exact. The sweep rounds as XLA's CPU backend does: see `fma`, `_edge_sweep`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tuatara_tpu_torch.kernels.hull import lower_chains

_INF = 1e30

# Hull vertices kept per chain (JAX's budget): a convex polygon on an n x n
# grid has O(n^(2/3)) vertices, so 192 a chain is past the bound for a
# 512-row heatmap; a chain that overflows flags its component, which then
# takes the PCA fit.
_CHAIN_BUDGET = 192

# Dilation radius bound per side (niter <= 32 at canvas 1024 gives 16);
# larger radii are clamped and flagged.
_MAX_GROW = 18

# Components swept at once: a chunk's [k, E, P] fp64 buffer is ~75 MB at
# k = 64, E = 383, P = 384 (the CPU); 300 MB at k = 256 (the card).
SWEEP_CHUNK = {"cpu": 64, "cuda": 256}


# Pixels of no slot scatter into this many spare cells (by raster index),
# not one: a single cell would take every background pixel's atomic.
SPARE_CELLS = 4096


def spare_cells(index: torch.Tensor, live: torch.Tensor, n: int) -> torch.Tensor:
    """index where live, else one of SPARE_CELLS cells from n on (by the
    element's flat position): scatter targets for a buffer of
    n + SPARE_CELLS cells whose first n are the result."""
    spare = n + torch.arange(index.numel(), device=index.device).view(index.shape) % SPARE_CELLS
    return torch.where(live, index, spare)


def component_slots(labels: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """labels [H, W] int32 (-1 background), roots [K] int32 (2**30 padding)
    -> [H, W] int64: each pixel's slot in `roots`, K where it has none.
    No host read: padding roots write a table cell no label reads."""
    K = roots.shape[0]
    n = labels.numel()
    table = torch.full((n + 1,), K, dtype=torch.int64, device=labels.device)
    table[roots.long().clamp(max=n)] = torch.arange(K, device=labels.device)
    lab = labels.long()
    return torch.where(lab >= 0, table[lab.clamp(min=0)], torch.full_like(lab, K))


def row_profiles(slots: torch.Tensor, K: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                           torch.Tensor]:
    """Per-row x extents of each slot's pixels: slots [H, W] int64 (K = no
    slot) -> (xmin, xmax [H, K] fp32, +-1e30 on empty rows; row_any [H, K]).

    JAX reduces an [H, W, K] one-hot; here each pixel's x goes to its
    (row, slot) cell by one amin and one amax scatter. Min and max of
    integers are exact and independent of order, so the profiles are
    JAX's bit for bit."""
    H, W = slots.shape
    dev = slots.device
    n = H * K
    cell = spare_cells(torch.arange(H, device=dev)[:, None] * K + slots, slots < K, n)
    xs = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    xmin = torch.full((n + SPARE_CELLS,), _INF, device=dev).scatter_reduce_(
        0, cell.reshape(-1), xs.reshape(-1), "amin")
    xmax = torch.full((n + SPARE_CELLS,), -_INF, device=dev).scatter_reduce_(
        0, cell.reshape(-1), xs.reshape(-1), "amax")
    xmin = xmin[:n].view(H, K)
    xmax = xmax[:n].view(H, K)
    return xmin, xmax, xmin < _INF


def _dilate_profiles(xmin, xmax, rvalid, grow_lt, grow_rb, cw, ch):
    """Row profiles of the dilated, content-clipped set. A source pixel
    covers [p - grow_lt, p + grow_rb] on each axis (OpenCV's KxK dilate,
    K = 1 + niter, centre anchor), so row y gathers rows y - grow_rb ..
    y + grow_lt: a window of 2 * _MAX_GROW + 1 shifts, masked per slot."""
    H, K = xmin.shape
    G = _MAX_GROW
    pad = torch.nn.functional.pad
    # [H, K, 2G + 1] windows; window index d holds row y + d - G.
    smin = pad(xmin, (0, 0, G, G), value=_INF).unfold(0, 2 * G + 1, 1)
    smax = pad(xmax, (0, 0, G, G), value=-_INF).unfold(0, 2 * G + 1, 1)
    sval = pad(rvalid, (0, 0, G, G)).unfold(0, 2 * G + 1, 1)

    lt = grow_lt.clamp(0, G)
    rb = grow_rb.clamp(0, G)
    grow_ok = (grow_lt <= G) & (grow_rb <= G)
    ds = torch.arange(-G, G + 1, dtype=lt.dtype, device=xmin.device)
    m = (ds[None, :] >= -rb[:, None]) & (ds[None, :] <= lt[:, None])     # [K, D]

    dmin = torch.where(m, smin, torch.full_like(smin, _INF)).amin(-1) - lt.float()
    dmax = torch.where(m, smax, torch.full_like(smax, -_INF)).amax(-1) + rb.float()
    dval = (sval & m).any(-1)

    ys = torch.arange(H, device=xmin.device)[:, None]
    dval = dval & (ys < ch)
    dmin = torch.clamp(dmin, min=0.0)
    dmax = torch.minimum(dmax, cw.float() - 1.0)
    return dmin, dmax, dval, grow_ok


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to fp32, as XLA's CPU backend evaluates an
    fp32 `a * b + c` (it contracts the pair into a fused multiply-add;
    torch rounds the product first). The product of two fp32 values is
    exact in fp64, so the fp64 sum rounds once and the cast once more:
    that agrees with a true fma except where the fp64 sum falls on an fp32
    rounding midpoint it was not on before, about 2^-29 of the cases."""
    return (a.double() * b.double() + c.double()).float()


def _extents(a, b, c, d):
    """Per row of the [k, E, P] grid, min and max over P of fma(a, b, c * d)
    (a, c [k, 1, P]; b, d [k, E, 1]), rounded to fp32. The sum is formed
    in fp64 (c * d rounded to fp32 first, then the exact product a * b
    added, as `fma` does) and reduced there: rounding is monotone, so the
    rounded min is the min of the rounded values. One fp64 [k, E, P]
    buffer, three passes over it."""
    k, e, p = b.shape[0], b.shape[1], a.shape[2]
    acc = torch.empty((k, e, p), dtype=torch.float64, device=a.device)
    torch.mul(c, d, out=acc)                      # fp32 product, stored as fp64
    acc.addcmul_(a.double(), b.double())
    lo, hi = torch.aminmax(acc, dim=2)
    return lo.float(), hi.float()


def _edge_sweep(left, right):
    """Smallest-area rectangle over every hull-edge direction, for the
    chains of k components: left and right are (x, y, valid) [k, EB] with
    x un-mirrored. -> corners [k, 4, 2]. Each step is JAX's expression in
    JAX's order: the edge lengths are exact (integer coordinates), and
    the projections and corners take `fma` where XLA's CPU backend fuses
    a product into the sum (found by comparing the two: rounding the
    product first moves corners by ulps, and an area that ties within an
    ulp then picks another edge, turning the crop by 90 degrees).

    JAX masks the points past a chain's count out of each min and max;
    here they take the value of the component's first point instead, so
    one unmasked min/max pass serves both (a repeated member changes no
    extreme). A component with no point gets finite garbage where JAX has
    +-1e30, and `exact_ok` rejects it either way."""
    (lx, ly, lm), (rx, ry, rm) = left, right
    pmask = torch.cat([lm, rm], dim=1)                          # [k, P]
    pxs = torch.where(pmask, torch.cat([lx, rx], dim=1), lx[:, :1])
    pys = torch.where(pmask, torch.cat([ly, ry], dim=1), ly[:, :1])

    def chain_edges(x, y, m):
        return x[:, 1:] - x[:, :-1], y[:, 1:] - y[:, :-1], m[:, 1:] & m[:, :-1]

    dx_l, dy_l, em_l = chain_edges(lx, ly, lm)
    dx_r, dy_r, em_r = chain_edges(rx, ry, rm)
    one = torch.ones((lx.shape[0], 1), device=lx.device)
    ex = torch.cat([dx_l, dx_r, one], dim=1)                   # [k, E]
    ey = torch.cat([dy_l, dy_r, torch.zeros_like(one)], dim=1)
    em = torch.cat([em_l, em_r, one.bool()], dim=1)
    ln = torch.sqrt(ex * ex + ey * ey)
    em = em & (ln > 0)
    ln = torch.clamp(ln, min=1e-12)
    c = ex / ln
    s = ey / ln

    px, py = pxs[:, None, :], pys[:, None, :]
    cc, ss = c[:, :, None], s[:, :, None]
    umin, umax = _extents(px, cc, py, ss)                      # u = x c + y s
    # XLA rewrites -x * s + y * c as y * c - x * s before fusing.
    vmin, vmax = _extents(py, cc, px, -ss)                     # v = y c - x s
    area = torch.where(em, (umax - umin) * (vmax - vmin), torch.full_like(umin, _INF))

    best = area.argmin(1)[:, None]
    bc, bs = c.gather(1, best)[:, 0], s.gather(1, best)[:, 0]
    u0, u1 = umin.gather(1, best)[:, 0], umax.gather(1, best)[:, 0]
    v0, v1 = vmin.gather(1, best)[:, 0], vmax.gather(1, best)[:, 0]

    def corner(uu, vv):
        return torch.stack([fma(uu, bc, -(vv * bs)), fma(uu, bs, vv * bc)], dim=-1)

    return torch.stack([corner(u0, v0), corner(u1, v0), corner(u1, v1), corner(u0, v1)],
                       dim=1)


def sweep_chains(hx: torch.Tensor, hy: torch.Tensor, cnt: torch.Tensor,
                 chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edge sweep over the hull chains of K components (H1's outputs:
    hx, hy [2K, H], cnt [2K]), `chunk` components at a time, each chunk's
    arrays [chunk, E, P], never over a batch of pages. -> (corners [K, 4, 2],
    overflow [K]: a chain holds more than the vertex budget)."""
    K, H = hx.shape[0] // 2, hx.shape[1]
    dev = hx.device
    chunk = chunk or SWEEP_CHUNK.get(dev.type, 64)
    EB = min(H, _CHAIN_BUDGET)
    hx, hy = hx[:, :EB], hy[:, :EB]
    vmask = torch.arange(EB, device=dev)[None, :] < cnt[:, None]
    over = cnt > EB
    rx = hx * torch.cat([torch.ones(K, device=dev), -torch.ones(K, device=dev)])[:, None]
    parts = []
    for a in range(0, K, chunk):
        b = min(a + chunk, K)
        parts.append(_edge_sweep((rx[a:b], hy[a:b], vmask[a:b]),
                                 (rx[K + a:K + b], hy[K + a:K + b], vmask[K + a:K + b])))
    corners = torch.cat(parts) if parts else torch.zeros((0, 4, 2), device=dev)
    return corners, over[:K] | over[K:]


def min_area_rect_from_profiles(xmin, xmax, rvalid, grow_lt, grow_rb, cw, ch,
                                chunk: Optional[int] = None):
    """Exact min-area rotated rect per component from row profiles.

    xmin/xmax [H, K] fp32 (+-1e30 on empty rows), rvalid [H, K] bool,
    grow_lt/grow_rb [K] int32 dilation radii, cw/ch the content extent
    (0-d tensors). -> (corners [K, 4, 2] fp32 (x, y), exact_ok [K] bool).
    Corners run (umin, vmin), (umax, vmin), (umax, vmax), (umin, vmax) of
    the winning edge's frame, rotated back, as `boxes._pca_corners` does.
    exact_ok is False where a chain overflows the budget, a radius exceeds
    _MAX_GROW, the component has no pixel, or a corner is not finite."""
    dmin, dmax, dval, grow_ok = _dilate_profiles(xmin, xmax, rvalid, grow_lt, grow_rb,
                                                 cw, ch)
    hx, hy, cnt = lower_chains(dmin.contiguous(), dmax.contiguous(), dval.contiguous())
    corners, overflow = sweep_chains(hx, hy, cnt, chunk)
    finite = torch.isfinite(corners)
    exact_ok = grow_ok & dval.any(0) & ~overflow & finite.all(2).all(1)
    corners = torch.where(finite, corners, torch.zeros_like(corners))
    return corners, exact_ok
