"""BA: a product's bias add and the activation after it, at a 16-bit
compute dtype (`csrc/bias_act.cu`).

`bias_act` launches `tt_bias_act` for CUDA tensors and runs
`bias_act_plain` for CPU tensors. It replaces no TPU kernel. JAX's
`conv2d` and `linear` (`tuatara_tpu/models/layers.py:84-95, 387-393`)
round a bf16 product to bf16 and then add the bias cast to bf16, with a
second rounding; a library call that takes the bias (cuDNN's convolution,
cuBLAS's addmm) adds it in fp32 before the one rounding. So the port takes
the product without its bias and adds the bias afterwards. Where an
activation follows, this kernel does both in one pass: CRAFT's ReLU (and,
for the trunk convs that feed a skip, the pre-ReLU value as a second
output), or PARSEQ's exact GELU rounded as XLA's CPU backend rounds
`jax.nn.gelu(approximate=False)` (`gelu_plain`). A bias add that no
activation follows is one `torch.add` (`models/layers.add_bias`), which
rounds the same way.

Numerics, per element, in the tensor's dtype T (bf16 or fp16): v =
T(float(p) + float(b)), then ReLU(v), or T(0.5 * float(v) * float(T(erfc(
-float(v) * T(sqrt(0.5)))))); with no bias v = p. The plain version runs
the same ops in PyTorch, so on the card the kernel equals it bit for bit.

`bias_add_f32` is the fp32-output mode (`tt_bias_add_f32`): where a
Linear's sum goes straight into an fp32 op (PARSEQ's residual adds,
`patch_embed + pos_embed`, in training the head before the PLM loss),
XLA's CPU backend adds the bias in fp32 and never rounds the sum to the
dtype, so the port computes `r + (fp32(y) + fp32(b))` in fp32, that
order, the residual r folded into the same pass, bit-equal to its plain
version (`bias_add_f32_plain`) on the card. A bias add whose sum is
rounded stays `torch.add` (`models/layers.add_bias`).

The kernel is differentiable (`_BiasAct`, `_BiasAddF32`), so the training
graph launches it too. Its backward (`bias_act_grads`) is the one PyTorch's
autograd takes through the plain version, op for op: ReLU's is one
`threshold_backward`, the bias's a sum, and GELU's, ~20 elementwise ops
in autograd, one pass of a second kernel, `gelu_grad` (`tt_gelu_grad`,
plain version `gelu_plain_grad`), bit-equal to them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry
from tuatara_tpu_torch.kernels.cc import _raise_on

BA = "bias_act"
GG = "gelu_grad"
ACTS = ("relu", "gelu")
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
_ERFC_GRAD = -2.0 / math.sqrt(math.pi)  # d erfc(a) / da = this * exp(-a^2)


def sqrt_half(dtype: torch.dtype) -> float:
    """JAX's `np.sqrt(0.5).astype(x.dtype)`: sqrt(1/2) rounded to `dtype`."""
    return _SQRT_HALF.get(dtype) or torch.tensor(math.sqrt(0.5), dtype=dtype).item()


_SQRT_HALF = {dt: torch.tensor(math.sqrt(0.5), dtype=dt).item() for dt in _DTYPES}


def gelu_plain(v: torch.Tensor) -> torch.Tensor:
    """Exact GELU of a 16-bit tensor as XLA's CPU backend computes JAX's
    `0.5 * x * erfc(-x * sqrt_half)`: erfc in fp32 of the unrounded
    product, rounded to the dtype, then the product 0.5 * x * e in fp32,
    rounded once."""
    f = v.float()
    e = torch.erfc(f * -sqrt_half(v.dtype)).to(v.dtype).float()
    return (0.5 * f * e).to(v.dtype)


def gelu_plain_grad(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The gradient autograd takes through `gelu_plain(v)` for the output
    gradient g, op for op: the same products, casts and order."""
    dt, c = v.dtype, -sqrt_half(v.dtype)
    f = v.float()
    a = f * c
    e = torch.erfc(a).to(dt).float()
    g32 = g.float()
    ge = (g32 * (0.5 * f)).to(dt).float()
    ga = _ERFC_GRAD * torch.exp(-(a.pow(2))) * ge
    return (ga * c + g32 * e * 0.5).to(dt)


def gelu_grad(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """`gelu_plain_grad(g, v)`: one `tt_gelu_grad` launch for CUDA tensors
    (g and v of one 16-bit dtype and shape, contiguous), the plain version
    for CPU tensors."""
    if not g.is_cuda:
        return gelu_plain_grad(g, v)
    if g.dtype not in _DTYPES or v.dtype != g.dtype or v.shape != g.shape:
        raise ValueError(f"gelu_grad: expected two bfloat16 or float16 tensors of one shape, "
                         f"got {g.dtype} {tuple(g.shape)} and {v.dtype} {tuple(v.shape)}")
    g, v = g.contiguous(), v.contiguous()
    out = torch.empty_like(g)
    if g.numel():
        fn = entry("bias_act", "tt_gelu_grad", 3, 1, n_float=2, n_i64=1)
        err = fn(g.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[g.dtype], g.numel(),
                 sqrt_half(g.dtype), _ERFC_GRAD, torch.cuda.current_stream(g.device).cuda_stream)
        _raise_on(err, "tt_gelu_grad")
        LAUNCHES[GG] += 1
    return out


def bias_view(bias: torch.Tensor, p: torch.Tensor, dim: int) -> torch.Tensor:
    """bias [C] -> a view that broadcasts along dimension `dim` of p."""
    return bias.reshape(-1, *([1] * (p.dim() - 1 - dim % p.dim())))


def _check_act(act) -> None:
    if act not in ACTS:
        raise ValueError(f"bias_act: act must be one of {ACTS}, got {act!r}")


def bias_act_plain(p: torch.Tensor, bias: Optional[torch.Tensor], act: str,
                   keep_pre: bool = False, dim: int = 1):
    """p + bias along `dim`, rounded to p's dtype, then `act`; with
    `keep_pre`, (the activation, the pre-activation value)."""
    _check_act(act)
    v = p if bias is None else p + bias_view(bias.to(p.dtype), p, dim)
    y = F.relu(v) if act == "relu" else gelu_plain(v)
    return (y, v) if keep_pre else y


def bias_act_grads(gy: Optional[torch.Tensor], gpre: Optional[torch.Tensor],
                   saved: torch.Tensor, act: str, bias_shape: Optional[torch.Size]):
    """The backward of `bias_act_plain` as autograd takes it: gy, the
    gradient of the activation, and gpre, of the pre-activation output
    (either None where it has none); saved, the activation (ReLU) or the
    pre-activation value (GELU); bias_shape, the bias's shape broadcast
    against p (None: no bias) -> (the gradient of p, of the bias [C])."""
    gv = None
    if gy is not None:
        gv = (torch.ops.aten.threshold_backward(gy, saved, 0) if act == "relu"
              else gelu_grad(gy, saved))
    if gpre is not None:
        gv = gpre if gv is None else gv + gpre
    if gv is None:
        return None, None
    gb = None if bias_shape is None else gv.sum_to_size(bias_shape).reshape(-1)
    return gv, gb


def _channel_divisor(p: torch.Tensor, dim: int) -> int:
    """Memory order -> the step in elements between channels: 1 where the
    channel is the innermost dimension (a Linear's [..., C], an NCHW
    tensor in channels_last memory), H * W for a contiguous NCHW tensor."""
    dim %= p.dim()
    if dim == p.dim() - 1 and p.is_contiguous():
        return 1
    if p.dim() == 4 and dim == 1:
        if p.is_contiguous(memory_format=torch.channels_last):
            return 1
        if p.is_contiguous():
            return p.shape[2] * p.shape[3]
    raise ValueError(f"bias_act: expected a contiguous tensor with channels along dim {dim}, "
                     f"or an NCHW one in channels_last memory; got {tuple(p.shape)} strides "
                     f"{p.stride()}")


def _launch(p: torch.Tensor, bias: Optional[torch.Tensor], act: str, keep_pre: bool,
            dim: int):
    """One `tt_bias_act` launch -> (the activation, the pre-activation
    value or None)."""
    if p.dtype not in _DTYPES:
        raise ValueError(f"bias_act: expected a bfloat16 or float16 tensor, got {p.dtype}")
    div = _channel_divisor(p, dim)
    c = p.shape[dim]
    if bias is not None and (tuple(bias.shape) != (c,) or not bias.is_contiguous()
                             or bias.device != p.device or bias.dtype != p.dtype):
        raise ValueError(f"bias: expected a contiguous [{c}] {p.dtype} tensor on {p.device}, "
                         f"got {tuple(bias.shape)} {bias.dtype} on {bias.device}")
    y = torch.empty_like(p)
    pre = torch.empty_like(p) if keep_pre else None
    if p.numel():
        fn = entry("bias_act", "tt_bias_act", 4, 2, n_float=1, n_i64=2)
        err = fn(p.data_ptr(), 0 if bias is None else bias.data_ptr(), y.data_ptr(),
                 0 if pre is None else pre.data_ptr(), c, _DTYPES[p.dtype] * 4 + ACTS.index(act),
                 p.numel(), div, sqrt_half(p.dtype),
                 torch.cuda.current_stream(p.device).cuda_stream)
        _raise_on(err, "tt_bias_act")
        LAUNCHES[BA] += 1
    return y, pre


class _BiasAct(torch.autograd.Function):
    """The kernel with the plain version's backward (`bias_act_grads`)."""

    @staticmethod
    def forward(ctx, p, bias, act, keep_pre, dim):
        ctx.set_materialize_grads(False)
        # GELU's backward needs the pre-activation value: ask the kernel
        # for it whether or not the caller does.
        y, pre = _launch(p, bias, act, keep_pre or act == "gelu", dim)
        ctx.act, ctx.keep_pre = act, keep_pre
        ctx.bias_shape = None if bias is None else bias_view(bias, p, dim).shape
        ctx.save_for_backward(y if act == "relu" else pre)
        return (y, pre) if keep_pre else y

    @staticmethod
    def backward(ctx, gy, gpre=None):
        saved, = ctx.saved_tensors
        gp, gb = bias_act_grads(gy, gpre if ctx.keep_pre else None, saved, ctx.act,
                                ctx.bias_shape)
        return gp, gb, None, None, None


def bias_act(p: torch.Tensor, bias: Optional[torch.Tensor], act: str, keep_pre: bool = False,
             dim: int = 1):
    """p [...] bf16 or fp16, the product of a layer without its bias;
    bias [C] (cast to p's dtype) or None, along `dim` (1: CRAFT's NCHW
    convolutions, in either memory format; -1: a Linear's [..., C]) ->
    the activation ("relu" or "gelu") of p + bias, in p's dtype and memory
    format; with `keep_pre`, (that, p + bias). Differentiable: where p or
    the bias needs a gradient the launch is recorded for the backward."""
    _check_act(act)
    if not p.is_cuda:
        return bias_act_plain(p, bias, act, keep_pre, dim)
    if bias is not None and bias.dtype != p.dtype:
        bias = bias.to(p.dtype)
    if torch.is_grad_enabled() and (p.requires_grad or (bias is not None and bias.requires_grad)):
        return _BiasAct.apply(p, bias, act, keep_pre, dim)
    y, pre = _launch(p, bias, act, keep_pre, dim)
    return (y, pre) if keep_pre else y


def bias_add_f32_plain(y: torch.Tensor, bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fp32-output mode's plain version: y [..., C] (bf16 or fp16) plus
    the bias [C] rounded to y's dtype, both widened to fp32, never rounded;
    then residual + that sum (residual fp32, of y's shape or broadcast over
    its leading dimensions)."""
    s = y.float() + bias.to(y.dtype).float()
    return s if residual is None else residual + s


def bias_add_f32_grads(g: Optional[torch.Tensor], y_dtype: torch.dtype,
                       bias_shape: torch.Size, bias_dtype: torch.dtype,
                       residual_shape: Optional[torch.Size]):
    """The backward of `bias_add_f32_plain` as autograd takes it, for the
    output's gradient g (fp32) -> (y's gradient, g cast to y's dtype; the
    bias's, g summed to its shape and cast to its dtype; the residual's, g
    summed to its shape, None without a residual); all None without g."""
    if g is None:
        return None, None, None
    gb = g.sum_to_size(bias_shape).to(bias_dtype)
    gr = None if residual_shape is None else g.sum_to_size(residual_shape)
    return g.to(y_dtype), gb, gr


def residual_period(residual: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """A residual that broadcasts to `shape` (y's) over leading dimensions
    only -> a contiguous tensor whose flat values, repeated, are the
    broadcast residual's: the residual without the leading dimensions that
    broadcast (size 1 against more, or stride 0 in an expanded view).
    Raises if it broadcasts elsewhere."""
    rs = (1,) * (len(shape) - residual.dim()) + tuple(residual.shape)
    if len(rs) != len(shape) or any(a != b and a != 1 for a, b in zip(rs, shape)):
        raise ValueError(f"bias_add_f32: residual {tuple(residual.shape)} does not broadcast to "
                         f"{tuple(shape)}")
    k, lead = 0, len(shape) - residual.dim()
    while k < len(shape) and ((rs[k] == 1 and shape[k] != 1)
                              or (k >= lead and residual.stride(k - lead) == 0)):
        k += 1
    if rs[k:] != tuple(shape[k:]):
        raise ValueError(f"bias_add_f32: residual {tuple(residual.shape)} broadcasts over an "
                         f"inner dimension of {tuple(shape)}")
    r = residual[(0,) * (k - lead)] if k > lead else residual
    return r.contiguous()


def _launch_f32(y: torch.Tensor, bias: torch.Tensor,
                residual: Optional[torch.Tensor]) -> torch.Tensor:
    """One `tt_bias_add_f32` launch -> the fp32 output, y's shape."""
    if y.dtype not in _DTYPES or not y.is_contiguous():
        raise ValueError(f"bias_add_f32: expected a contiguous bfloat16 or float16 tensor, got "
                         f"{y.dtype} strides {y.stride()}")
    c = y.shape[-1]
    if (tuple(bias.shape) != (c,) or not bias.is_contiguous() or bias.device != y.device
            or bias.dtype != y.dtype):
        raise ValueError(f"bias: expected a contiguous [{c}] {y.dtype} tensor on {y.device}, "
                         f"got {tuple(bias.shape)} {bias.dtype} on {bias.device}")
    r = None
    if residual is not None:
        if residual.dtype != torch.float32 or residual.device != y.device:
            raise ValueError(f"bias_add_f32: expected an fp32 residual on {y.device}, got "
                             f"{residual.dtype} on {residual.device}")
        r = residual_period(residual, y.shape)
    out = torch.empty(y.shape, dtype=torch.float32, device=y.device)
    if y.numel():
        fn = entry("bias_act", "tt_bias_add_f32", 4, 2, n_i64=2)
        err = fn(y.data_ptr(), bias.data_ptr(), 0 if r is None else r.data_ptr(),
                 out.data_ptr(), c, _DTYPES[y.dtype],
                 y.numel(), 1 if r is None else r.numel(),
                 torch.cuda.current_stream(y.device).cuda_stream)
        _raise_on(err, "tt_bias_add_f32")
        LAUNCHES[BA] += 1
    return out


class _BiasAddF32(torch.autograd.Function):
    """The fp32-output mode with the plain version's backward
    (`bias_add_f32_grads`)."""

    @staticmethod
    def forward(ctx, y, bias, residual):
        ctx.set_materialize_grads(False)
        ctx.y_dtype, ctx.bias_shape, ctx.bias_dtype = y.dtype, bias.shape, bias.dtype
        ctx.residual_shape = None if residual is None else residual.shape
        return _launch_f32(y, bias, residual)

    @staticmethod
    def backward(ctx, g):
        return bias_add_f32_grads(g, ctx.y_dtype, ctx.bias_shape, ctx.bias_dtype,
                                  ctx.residual_shape)


def bias_add_f32(y: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y [..., C] bf16 or fp16, a Linear's product without its bias; bias
    [C] (rounded to y's dtype); residual fp32 of y's shape or
    broadcast over its leading dimensions ([1, S, D] against [N, S, D]),
    or None -> residual + (fp32(y) + fp32(bias)) in fp32, y's shape, never
    rounded to y's dtype. One `tt_bias_add_f32` launch for CUDA tensors,
    differentiable (`_BiasAddF32`); the plain version for CPU tensors."""
    if not y.is_cuda:
        return bias_add_f32_plain(y, bias, residual)
    if bias.dtype != y.dtype:
        bias = bias.to(y.dtype)
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad or (
            residual is not None and residual.requires_grad)):
        return _BiasAddF32.apply(y, bias, residual)
    return _launch_f32(y, bias, residual)
