"""Fused CRAFT stage-1 tail, kernel K8: conv3x3 + bias + ReLU + 2x2 max-pool.

`fused_conv_pool` launches `csrc/stage1.cu` for CUDA tensors and runs
`fused_conv_pool_plain` for CPU tensors. It replaces the Pallas kernel
`fused_conv_pool` (tuatara_tpu/ops/pallas/stage1.py:134), in the port's
shapes: x [B, C, H, W] bf16, w [O, C, 3, 3], b [O] -> [B, O, H/2, W/2]
bf16, x and the output channels_last: the memory layout of the port's
trunk, whose canvas is NHWC. Numerics as the TPU kernel's: bf16 inputs and
weights, fp32 accumulation, fp32 bias and ReLU, bf16 output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry
from tuatara_tpu_torch.kernels.cc import _raise_on

K8 = "fused_conv_pool"


def fused_conv_pool_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv2d (SAME zero padding) -> ReLU -> 2x2/2 max-pool in fp32 on the
    bf16-rounded inputs and weights, one rounding to bf16 at the end."""
    y = F.conv2d(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(), b.float(),
                 padding=1)
    return F.max_pool2d(F.relu(y), 2, 2).to(torch.bfloat16)


def fused_conv_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] bf16 channels_last, w [O, C, 3, 3], b [O] -> pooled
    [B, O, H/2, W/2] bf16 channels_last. The CUDA kernel takes O = 64
    (CRAFT's conv1_2), C a multiple of 16 up to 64, H % 4 == 0 and an even
    W, and reads x with 16-byte loads, so x's data must be 16-byte aligned
    (a view at an odd offset into a larger tensor is refused); the bias is
    added in fp32."""
    if not x.is_cuda:
        return fused_conv_pool_plain(x, w, b)
    if x.dim() != 4 or x.dtype != torch.bfloat16 \
            or not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError(f"x: expected a channels_last [B, C, H, W] bfloat16 tensor with "
                         f"16-byte aligned data, got {tuple(x.shape)} {x.dtype} strides "
                         f"{x.stride()} at offset {x.storage_offset()}")
    n, c, h, wd = x.shape
    o = w.shape[0]
    if tuple(w.shape) != (o, c, 3, 3) or w.dtype != torch.bfloat16 or not w.is_contiguous() \
            or tuple(b.shape) != (o,) or w.device != x.device or b.device != x.device:
        raise ValueError(f"w, b: expected contiguous [O, {c}, 3, 3] bfloat16 and [O] on "
                         f"{x.device}, got {tuple(w.shape)} {w.dtype}, {tuple(b.shape)}")
    if o != 64 or c % 16 or not 16 <= c <= 64 or h % 4 or wd % 2:
        raise ValueError(f"fused_conv_pool takes O = 64, C a multiple of 16 up to 64, "
                         f"H % 4 == 0 and an even W; got C={c} O={o} H={h} W={wd}")
    bias = b.float().contiguous()
    out = torch.empty((n, o, h // 2, wd // 2), dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    fn = entry("stage1", "tt_fused_conv_pool", 4, 5)
    err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), n, c, h, wd, o,
             torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "tt_fused_conv_pool")
    LAUNCHES[K8] += 1
    return out
