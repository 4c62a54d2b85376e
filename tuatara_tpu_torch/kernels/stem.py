"""SC: int8 CRAFT's float first convolution at bf16 (`csrc/stem.cu`).

`stem_conv` launches `tt_stem_conv` for CUDA tensors and runs
`stem_conv_plain` for CPU tensors. It replaces no TPU kernel: JAX's conv1_1
is an XLA convolution (`tuatara_tpu/models/layers.py:84-95`). Under
`production()` the layers after it are int8 with dynamic per-tensor scales,
so conv1_1 must round as JAX's graph rounds: XLA's CPU backend computes a
bf16 convolution as an fp32 one over the bf16 values, each output a chain
of fp32 sums over its taps in (kh, kw, ci) order (every product exact),
rounded once to bf16; then the bias rounded to bf16 is added with a second
rounding, and the ReLU. cuDNN (and oneDNN on the CPU) sum in other orders,
and the int8 trunk turns the few outputs that round otherwise into other
int8 values and, layers later, other scales. Both routes here sum in XLA's
order: the plain version with PyTorch ops (an exact product added to an
fp32 accumulator, tap by tap), the kernel with one fma chain an output, bit
for bit the same. The kernel reads its weights packed once
(`pack_stem_weights`), so a call launches it alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry

SC = "stem_conv"
MAX_CIN = 4  # the kernel's limits: a 3x3 conv, cin <= 4, cout a multiple of 8 up to 256
MAX_COUT = 256


def _relu_bias(acc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """fp32 sums [B, O, H, W] -> ReLU(bf16(float(bf16(acc)) + bf16(bias)))."""
    y = acc.to(torch.bfloat16).float() + bias.to(torch.bfloat16).float().view(1, -1, 1, 1)
    v = y.to(torch.bfloat16)
    return torch.where(v > 0, v, torch.zeros((), dtype=v.dtype, device=v.device))


def stem_conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] (any float dtype, rounded to bf16), weight [O, C, 3,
    3], bias [O] -> ReLU(conv(x) + bias) in bf16, "SAME" padding, the sum
    of each output taken tap by tap in (kh, kw, ci) order in fp32 (the
    products of bf16 values are exact), channels_last memory."""
    xb = x.to(torch.bfloat16).float()
    w = weight.to(torch.bfloat16).float()
    b, c, h, wd = xb.shape
    o = w.shape[0]
    xp = F.pad(xb, (1, 1, 1, 1))
    acc = torch.zeros((b, h, wd, o), dtype=torch.float32, device=x.device).permute(0, 3, 1, 2)
    for kh in range(3):
        for kw in range(3):
            for ci in range(c):
                acc.addcmul_(xp[:, ci:ci + 1, kh:kh + h, kw:kw + wd],
                             w[:, ci, kh, kw].view(1, o, 1, 1))
    return _relu_bias(acc, bias)


def pack_stem_weights(weight: torch.Tensor, bias: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight [O, C, 3, 3], bias [O] -> (w [O, 3, 3, C], b [O]) fp32 holding
    their bf16 values, the layout `tt_stem_conv` reads. Done once where the
    weights are set (CRAFT's buffers `conv1_1_packed_*`), not on every call."""
    w = weight.detach().to(torch.bfloat16).permute(0, 2, 3, 1).float().contiguous()
    return w, bias.detach().to(torch.bfloat16).float().contiguous()


def stem_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """conv1_1 of int8 CRAFT at bf16: x [B, C, H, W] float (read through its
    strides: a canvas in NHWC memory with no copy; a gray canvas expanded to
    C channels is read once a pixel), weight [O, C, 3, 3], bias [O] ->
    ReLU(conv(x) + bias), bf16 [B, O, H, W] in channels_last memory,
    rounded as XLA's CPU backend rounds JAX's conv2d (see the module
    docstring). `packed` is `pack_stem_weights(weight, bias)` made
    beforehand; without it the call packs them."""
    if not x.is_cuda:
        return stem_conv_plain(x, weight, bias)
    b, c, h, wd = x.shape
    o = weight.shape[0]
    if (tuple(weight.shape) != (o, c, 3, 3) or tuple(bias.shape) != (o,) or c > MAX_CIN
            or o % 8 or o > MAX_COUT or weight.device != x.device or bias.device != x.device):
        raise ValueError(f"stem_conv: x {tuple(x.shape)}, weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)}: expected a 3x3 conv with cin <= {MAX_CIN} and "
                         f"cout a multiple of 8 up to {MAX_COUT}, on one device")
    w, bf = pack_stem_weights(weight, bias) if packed is None else packed
    if (tuple(w.shape) != (o, 3, 3, c) or tuple(bf.shape) != (o,) or w.dtype != torch.float32
            or bf.dtype != torch.float32 or not (w.is_contiguous() and bf.is_contiguous())
            or w.device != x.device or bf.device != x.device):
        raise ValueError(f"stem_conv: packed weights {tuple(w.shape)} {w.dtype}, bias "
                         f"{tuple(bf.shape)} {bf.dtype}: expected pack_stem_weights' layout "
                         f"on {x.device}")
    cx = 1 if c > 1 and x.stride(1) == 0 else c  # a gray canvas broadcast to c channels
    xs = x[:, :cx].float()
    y = torch.empty((b, h, wd, o), dtype=torch.bfloat16, device=x.device)
    if y.numel() == 0:
        return y.permute(0, 3, 1, 2)
    fn = entry("stem", "tt_stem_conv", 4, 6, n_i64=4)
    err = fn(xs.data_ptr(), w.data_ptr(), bf.data_ptr(), y.data_ptr(), b, h, wd, cx, c, o,
             xs.stride(0), xs.stride(2), xs.stride(3), xs.stride(1),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tt_stem_conv failed to launch: CUDA error {err}")
    LAUNCHES[SC] += 1
    return y.permute(0, 3, 1, 2)
