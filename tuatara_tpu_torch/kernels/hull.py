"""H1: the monotone-chain hull of the rotated fit (`csrc/hull.cu`).

`lower_chains` launches `tt_lower_chains` for CUDA tensors and runs
`lower_chains_plain` for CPU tensors. It replaces no TPU kernel: JAX builds
the chains outside Pallas, as a `lax.scan` over rows with a data-dependent
`while_loop` of pops (`tuatara_tpu/ops/minarearect.py:117 _lower_chains`).
Eager PyTorch would need a host read per pop test there, so on the card
one thread walks one chain's rows serially instead.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry

H1 = "lower_chains"


def _chain_inputs(dmin, dmax, dval):
    """[H, K] profiles -> px, pv [2K, H]: left chains on dmin, right chains
    on -dmax (the right boundary is the left boundary of the mirror)."""
    return torch.cat([dmin.T, -dmax.T]), torch.cat([dval.T, dval.T])


def lower_chains_plain(dmin: torch.Tensor, dmax: torch.Tensor, dval: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's monotone chain over the rows, all 2K chains at once.

    The stack entries below the top are not changed by a pop, so the pop
    test of stack position i against the new point is the same whenever
    it is made: popping while the top turn is not strictly convex stops at
    the highest position whose test fails. Each row takes that position
    with one masked max over the stack, in place of JAX's pop loop; the
    stack arrays (entries past a chain's count keep what was last written
    there, zeros at first) equal JAX's bit for bit."""
    px, pv = _chain_inputs(dmin, dmax, dval)
    B, H = px.shape
    dev = px.device
    hx = torch.zeros((B, H), dtype=torch.float32, device=dev)
    hy = torch.zeros((B, H), dtype=torch.float32, device=dev)
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    for y in range(H):
        v = pv[:, y]
        x = px[:, y]
        top = int(n.max())
        if top >= 2:
            i = torch.arange(1, top, device=dev)
            ox, oy = hx[:, :top - 1], hy[:, :top - 1]
            ax, ay = hx[:, 1:top], hy[:, 1:top]
            cr = (ax - ox) * (y - oy) - (ay - oy) * (x[:, None] - ox)
            keep = (cr < 0) & (i[None, :] < n[:, None])
            last = torch.where(keep, i[None, :], torch.zeros_like(i)[None, :]).amax(1)
            n = torch.where(v & (n >= 2), last + 1, n)
        idx = torch.where(v, n, torch.full_like(n, H))
        live = idx < H
        hx[rows[live], idx[live]] = x[live]
        hy[rows[live], idx[live]] = float(y)
        n = n + v.long()
    return hx, hy, n.to(torch.int32)


def lower_chains(dmin: torch.Tensor, dmax: torch.Tensor, dval: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dilated row profiles dmin, dmax [H, K] fp32, dval [H, K] bool ->
    (hx, hy [2K, H] fp32, cnt [2K] int32): rows :K the left chains of the
    points (dmin[y], y), rows K: those of (-dmax[y], y), over the rows
    where dval holds."""
    if not dmin.is_cuda:
        return lower_chains_plain(dmin, dmax, dval)
    H, K = dmin.shape
    for t, dt, what in ((dmin, torch.float32, "dmin"), (dmax, torch.float32, "dmax"),
                        (dval, torch.bool, "dval")):
        if t.shape != (H, K) or t.dtype != dt or not t.is_contiguous() or t.device != dmin.device:
            raise ValueError(f"{what}: expected a contiguous [{H}, {K}] {dt} tensor on "
                             f"{dmin.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    hx, hy = torch.zeros((2, 2 * K, H), dtype=torch.float32, device=dmin.device)  # one memset
    cnt = torch.empty(2 * K, dtype=torch.int32, device=dmin.device)
    if K == 0 or H == 0:
        return hx, hy, cnt.zero_()
    fn = entry("hull", "tt_lower_chains", 6, 2)
    err = fn(dmin.data_ptr(), dmax.data_ptr(), dval.data_ptr(), hx.data_ptr(),
             hy.data_ptr(), cnt.data_ptr(), H, K,
             torch.cuda.current_stream(dmin.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tt_lower_chains failed to launch: CUDA error {err}")
    LAUNCHES[H1] += 1
    return hx, hy, cnt
