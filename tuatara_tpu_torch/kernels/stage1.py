"""Fused CRAFT stage-1 tail, kernel K8: conv3x3 + bias + ReLU + 2x2 max-pool.

`fused_conv_pool` launches `csrc/stage1.cu` for CUDA tensors and runs
`fused_conv_pool_plain` for CPU tensors. It replaces the Pallas kernel
`fused_conv_pool` (tuatara_tpu/ops/pallas/stage1.py:134), in the port's
shapes: x [B, C, H, W] bf16, the packed weights of w [O, C, 3, 3]
(`pack_conv_pool_weights`), b [O] -> [B, O, H/2, W/2] bf16, x and the output
channels_last: the memory layout of the port's trunk, whose canvas is NHWC.
Numerics as the TPU kernel's: bf16 inputs and weights, fp32 accumulation,
fp32 bias and ReLU, bf16 output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry
from tuatara_tpu_torch.kernels.cc import _raise_on

K8 = "fused_conv_pool"
CHUNK = 64  # channels of one 128-byte swizzle row


def _swizzled_columns(o: int) -> torch.Tensor:
    """[O, 64] int64: the column of channel c in weight row o, its 16-byte
    chunk c // 8 XOR-ed with o % 8 (the 128-byte swizzle)."""
    c = torch.arange(CHUNK)
    return ((c // 8) ^ (torch.arange(o)[:, None] % 8)) * 8 + c % 8


def pack_conv_pool_weights(w: torch.Tensor) -> torch.Tensor:
    """w [O, C, 3, 3] -> packed [9, ceil(C / 64), O, 64] bf16: for each tap
    (ky * 3 + kx) and 64-channel chunk, an O x 128-byte block whose row o
    holds w[o, chunk channels, ky, kx] in the 128-byte swizzle (16-byte
    chunk q at q ^ (o % 8)), channels past C zero: the K-major B operand
    that K8's wgmma reads through a shared-memory descriptor, copied in
    as it lies. Done once where the weights reach the device."""
    o, c = w.shape[:2]
    if tuple(w.shape) != (o, c, 3, 3):
        raise ValueError(f"w: expected [O, C, 3, 3], got {tuple(w.shape)}")
    n_chunks = -(-c // CHUNK)
    taps = w.detach().to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, o, c)
    taps = F.pad(taps, (0, n_chunks * CHUNK - c)).reshape(9, o, n_chunks, CHUNK)
    taps = taps.permute(0, 2, 1, 3)
    cols = _swizzled_columns(o).to(w.device)
    packed = torch.empty_like(taps)
    packed.scatter_(3, cols.expand_as(taps), taps)
    return packed.contiguous()


def unpack_conv_pool_weights(packed: torch.Tensor, c: int) -> torch.Tensor:
    """The inverse of `pack_conv_pool_weights`: -> w [O, c, 3, 3] bf16."""
    _, n_chunks, o, _ = packed.shape
    cols = _swizzled_columns(o).to(packed.device)
    taps = packed.gather(3, cols.expand_as(packed))
    taps = taps.permute(0, 2, 1, 3).reshape(9, o, n_chunks * CHUNK)[:, :, :c]
    return taps.reshape(3, 3, o, c).permute(2, 3, 0, 1).contiguous()


def fused_conv_pool_plain(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv2d (SAME zero padding) -> ReLU -> 2x2/2 max-pool in fp32 on the
    bf16-rounded inputs and the weights unpacked from `wp`, one rounding to
    bf16 at the end."""
    w = unpack_conv_pool_weights(wp, x.shape[1])
    y = F.conv2d(x.to(torch.bfloat16).float(), w.float(), b.float(), padding=1)
    return F.max_pool2d(F.relu(y), 2, 2).to(torch.bfloat16)


def fused_conv_pool(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] bf16 channels_last, wp = pack_conv_pool_weights(w) for
    w [O, C, 3, 3], b [O] -> pooled [B, O, H/2, W/2] bf16 channels_last.
    The CUDA kernel takes C = O = 64 (CRAFT's conv1_2; any other width is
    refused, not padded), H % 4 == 0 and an even W, and reads x through a
    TMA descriptor, so x's data must be 16-byte aligned (a view at an odd
    offset into a larger tensor is refused); the bias (bf16 or fp32, read
    as it is, so the call launches nothing but the kernel) is added in
    fp32."""
    if not x.is_cuda:
        return fused_conv_pool_plain(x, wp, b)
    if x.dim() != 4 or x.dtype != torch.bfloat16 \
            or not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError(f"x: expected a channels_last [B, C, H, W] bfloat16 tensor with "
                         f"16-byte aligned data, got {tuple(x.shape)} {x.dtype} strides "
                         f"{x.stride()} at offset {x.storage_offset()}")
    n, c, h, wd = x.shape
    o = b.shape[0]
    if tuple(wp.shape) != (9, 1, o, CHUNK) or wp.dtype != torch.bfloat16 \
            or not wp.is_contiguous() or wp.data_ptr() % 16 or tuple(b.shape) != (o,) \
            or b.dtype not in (torch.bfloat16, torch.float32) or not b.is_contiguous() \
            or b.data_ptr() % 8 or wp.device != x.device or b.device != x.device:
        raise ValueError(f"wp, b: expected the packed weights [9, 1, O, 64] bfloat16 "
                         f"(pack_conv_pool_weights) and a contiguous [O] bfloat16 or "
                         f"float32 bias on {x.device}, got {tuple(wp.shape)} {wp.dtype}, "
                         f"{tuple(b.shape)} {b.dtype}")
    if o != 64 or c != 64 or h % 4 or wd % 2:
        raise ValueError(f"fused_conv_pool takes C = O = 64, H % 4 == 0 and an even W; "
                         f"got C={c} O={o} H={h} W={wd}")
    out = torch.empty((n, o, h // 2, wd // 2), dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    fn = entry("stage1", "tt_fused_conv_pool", 4, 6)
    err = fn(x.data_ptr(), wp.data_ptr(), b.data_ptr(), out.data_ptr(), n, c, h, wd, o,
             int(b.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "tt_fused_conv_pool")
    LAUNCHES[K8] += 1
    return out
