"""int8 serving's products: int8 x int8 -> exact int32 sums.

The JAX package runs them in XLA (`tuatara_tpu/models/layers.py:
conv2d_q_pre` and `linear_q`), not as Pallas kernels, so on the card they
are library GEMMs: `torch._int_mm` (cuBLASLt, int32 accumulators).

`int8_conv`, CRAFT's convolutions: the activation [B, H, W, C] is padded
once ("SAME" zeros, exact: 0 quantizes to 0), its k*k shifted windows are
concatenated along the channels into rows [B*H*W, k*k*C] (moved as int64
words, 8 channels each, since C is a multiple of 8 on the card), and one
GEMM multiplies them by the weights held as [O, k*k*C], K-contiguous
(cuBLASLt's int8 tensor-core kernels take that "TN" layout; the row-major
[K, O] one ran slower on the H100).

`int8_linear`, the recognizer encoder's linear layers (`QLinear`): rows
[M, K] times the weights held as [N, K], K-contiguous, the same GEMM.

The int32 sums are exact, so they equal JAX's bit for bit. `int8_conv`
counts `LAUNCHES["int8_conv"]` once a convolution and `int8_linear`
`LAUNCHES["int8_linear"]` once a product. On the CPU both take their plain
versions, the rows times the weights in float64: every product and partial
sum is an integer below 2^53, so they are exact too. On the card
`torch._int_mm` needs more than 16 rows (padded here) and K and N
multiples of 8: `check_shapes` raises unless they are, and the engine
calls it at construction for every quantized layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tuatara_tpu_torch.kernels import LAUNCHES

INT8_CONV = "int8_conv"
INT8_LINEAR = "int8_linear"
_MIN_ROWS = 17  # torch._int_mm on CUDA: more than 16 rows


def check_shapes(cin: int, cout: int) -> None:
    """ValueError unless the card's int8 GEMM takes K = cin (k*k*cin for a
    conv) and N = cout."""
    if cin % 8 or cout % 8:
        raise ValueError(f"int8 products on the card need cin and cout multiples of 8 "
                         f"(torch._int_mm), got {cin} -> {cout}")


def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """[k, k, C, O] int8 (JAX's HWIO) -> [O, k*k*C] int8, K-contiguous."""
    return wq.reshape(-1, wq.shape[3]).t().contiguous()


def int8_conv_plain(xq: torch.Tensor, wmat: torch.Tensor, k: int,
                    dilation: int = 1) -> torch.Tensor:
    """xq [B, H, W, C] int8, wmat [O, k*k*C] int8 -> [B, H, W, O] int32,
    "SAME" padding: im2col rows times the weights in float64 (exact).
    (A float64 `F.conv2d` is exact too, but its CPU kernel slows down
    by an order of magnitude when other processes load the cores.)"""
    b, h, w, c = xq.shape
    d = dilation
    p = d * (k - 1) // 2
    xp = F.pad(xq, (0, 0, p, p, p, p))
    cols = torch.cat([xp[:, ky * d:ky * d + h, kx * d:kx * d + w]
                      for ky in range(k) for kx in range(k)], dim=3).reshape(-1, k * k * c)
    return (cols.double() @ wmat.double().t()).to(torch.int32).view(b, h, w, -1)


def int8_conv_im2col(xq: torch.Tensor, wmat: torch.Tensor, k: int,
                     dilation: int = 1) -> torch.Tensor:
    """The card's route (on any device with `torch._int_mm`): im2col rows
    and one GEMM; C a multiple of 8. -> [B, H, W, O] int32."""
    b, h, w, c = xq.shape
    if k == 1:
        cols = xq.reshape(-1, c)
    else:
        d = dilation
        p = d * (k - 1) // 2
        xp = F.pad(xq.view(torch.int64), (0, 0, p, p, p, p))  # 8 channels a word
        cols = torch.cat([xp[:, ky * d:ky * d + h, kx * d:kx * d + w]
                          for ky in range(k) for kx in range(k)], dim=3)
        cols = cols.view(torch.int8).reshape(-1, k * k * c)
    m = cols.shape[0]
    if m < _MIN_ROWS:
        cols = torch.cat([cols, cols.new_zeros(_MIN_ROWS - m, cols.shape[1])])
    return torch._int_mm(cols, wmat.t())[:m].view(b, h, w, wmat.shape[0])


def int8_conv(xq: torch.Tensor, wmat: torch.Tensor, k: int, dilation: int = 1) -> torch.Tensor:
    """xq [B, H, W, C] int8 contiguous, wmat [O, k*k*C] int8 contiguous (odd
    k) -> [B, H, W, O] int32."""
    if not xq.is_cuda:
        return int8_conv_plain(xq, wmat, k, dilation)
    o, kk = wmat.shape
    if (xq.dtype, wmat.dtype) != (torch.int8, torch.int8) or xq.dim() != 4 \
            or kk != k * k * xq.shape[3] or k % 2 == 0 \
            or not (xq.is_contiguous() and wmat.is_contiguous()):
        raise ValueError(f"int8_conv: expected int8 [B, H, W, C] and [O, {k}*{k}*C] "
                         f"contiguous, got {tuple(xq.shape)} {xq.dtype}, "
                         f"{tuple(wmat.shape)} {wmat.dtype}")
    check_shapes(xq.shape[3], o)
    out = int8_conv_im2col(xq, wmat, k, dilation)
    LAUNCHES[INT8_CONV] += 1
    return out


def int8_linear_plain(xq: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """xq [..., K] int8, wmat [N, K] int8 -> [..., N] int32: the rows times
    the weights in float64 (exact)."""
    return (xq.double() @ wmat.double().t()).to(torch.int32)


def int8_linear(xq: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """xq [..., K] int8 contiguous, wmat [N, K] int8 contiguous -> [..., N]
    int32 (JAX `linear_q`'s dot_general with int32 accumulation)."""
    if not xq.is_cuda:
        return int8_linear_plain(xq, wmat)
    n, k = wmat.shape
    if (xq.dtype, wmat.dtype) != (torch.int8, torch.int8) or xq.shape[-1] != k \
            or not (xq.is_contiguous() and wmat.is_contiguous()):
        raise ValueError(f"int8_linear: expected int8 [..., K] and [N, K] contiguous, got "
                         f"{tuple(xq.shape)} {xq.dtype}, {tuple(wmat.shape)} {wmat.dtype}")
    check_shapes(k, n)
    rows = xq.reshape(-1, k)
    m = rows.shape[0]
    if m < _MIN_ROWS:
        rows = torch.cat([rows, rows.new_zeros(_MIN_ROWS - m, k)])
    out = torch._int_mm(rows, wmat.t())[:m]
    LAUNCHES[INT8_LINEAR] += 1
    return out.view(*xq.shape[:-1], n)
