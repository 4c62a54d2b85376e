"""BA: a product's bias add and the activation after it, at a 16-bit
compute dtype (`csrc/bias_act.cu`).

`bias_act` launches `tt_bias_act` for CUDA tensors and runs
`bias_act_plain` for CPU tensors. It replaces no TPU kernel. JAX's
`conv2d` and `linear` (`tuatara_tpu/models/layers.py:84-95, 387-393`)
round a bf16 product to bf16 and then add the bias cast to bf16, with a
second rounding; a library call that takes the bias adds it in fp32
before its one rounding (cuBLAS's addmm; oneDNN's convolution on the CPU)
or, for PyTorch's cuDNN convolution, in a second op of its own. So the
port takes the product without its bias and adds the bias afterwards.
Where an activation follows, this kernel does both in one pass: CRAFT's
ReLU (and, for the trunk convs that feed a skip, the pre-ReLU value as a
second output), or PARSEQ's exact GELU rounded as XLA's CPU backend rounds
`jax.nn.gelu(approximate=False)` (`gelu_plain`). A bias add that no
activation follows is one `torch.add` (`models/layers.add_bias`), which
rounds the same way.

Numerics, per element, in the tensor's dtype T (bf16 or fp16): v =
T(float(p) + float(b)), then ReLU(v), or T(T(0.5 * float(v)) *
float(T(erfc(a)))) with a = -float(v) * T(sqrt(0.5)) (rounded to T for
fp16, as XLA's fp16 graph keeps it) and denormals flushed as XLA's CPU
backend flushes them; with no bias v = p. The plain version runs the same
ops in PyTorch, so on the card the kernel equals it bit for bit.

`bias_add_f32` is the fp32-output mode (`tt_bias_add_f32`): where a
Linear's sum goes straight into an fp32 op (PARSEQ's residual adds,
`patch_embed + pos_embed`, in training the head before the PLM loss and
CRAFT's conv5 before its loss, along dim 1 of NCHW), XLA's CPU backend
adds the bias in fp32 and never rounds the sum to the dtype, so the port
computes `r + (fp32(y) + fp32(b))` in fp32, that order, the residual r
folded into the same pass, bit-equal to its plain version
(`bias_add_f32_plain`) on the card. A bias add whose sum is rounded stays
`torch.add` (`models/layers.add_bias`).

The launch path is kept thin, since a call's host time is as long as its
device time on most of the path's calls: the C entries are bound at their
first launch into module variables, the memory layout is the tensor's
stride along the channel dimension (`_channel_divisor`), the stream is the
current stream's raw handle, and the outputs are `torch.empty_like`. The
checks stay (dtype, device, shape, contiguity raise), and nothing catches a
failed build or launch. The kernel picks its own work assignment from the
layout and the pointers' alignment (`csrc/bias_act.cu` `plan`;
`tests/test_torch_bias_act_model.py` models it on the CPU).

The kernel is differentiable (`_BiasAct`, `_BiasAddF32`), so the training
graph launches it too. Its backward (`bias_act_grads`) is the one PyTorch's
autograd takes through the plain version: ReLU's is one
`threshold_backward`, the bias's a sum, and GELU's JAX's: XLA's CPU graph
of the gradient of `jax.nn.gelu(approximate=False)` rounds every product
to the dtype and takes -2/sqrt(pi) as the dtype's, so `gelu_plain_grad`
computes it that way, its terms that depend on v alone (e, ex) read from a
table XLA wrote (`tests/gen_torch_gelu_table.py`, `gelu_window`), and the
plain version's GELU carries it as its backward (`_GeluPlain`). On the
card it is one pass of a second kernel, `gelu_grad` (GG, `tt_gelu_grad`),
bit-equal to `gelu_plain_grad`.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry
from tuatara_tpu_torch.kernels.cc import _raise_on

BA = "bias_act"
GG = "gelu_grad"
ACTS = ("relu", "gelu")
_ACT_CODES = {act: i for i, act in enumerate(ACTS)}
_FP32_TINY = 2.0 ** -126  # the least normal fp32 magnitude
_SQRT_HALF = {dt: torch.tensor(math.sqrt(0.5), dtype=dt).item()
              for dt in (torch.bfloat16, torch.float16)}
# d erfc(a) / da = k * exp(-a^2), k = -2/sqrt(pi) rounded to the dtype as
# JAX's jvp of erfc takes it.
_ERFC_GRAD = {dt: torch.tensor(-2.0 / math.sqrt(math.pi), dtype=dt).item()
              for dt in (torch.bfloat16, torch.float16)}
# dtype -> (the C entries' dtype code, sqrt(1/2) rounded to it).
_DTYPES = {torch.bfloat16: (0, _SQRT_HALF[torch.bfloat16]),
           torch.float16: (1, _SQRT_HALF[torch.float16])}
# The C entries, bound at their first launch.
_BIAS_ACT = _BIAS_ADD_F32 = _GELU_GRAD = None
# The GELU gradient's tables (`gelu_window`), by dtype and by (dtype, device).
_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16"}
_SHORT = {"bfloat16": "bf16", "float16": "fp16"}
# name -> (exponent bias, significand bits, bit magnitude of +Inf)
_FORMATS = {"bfloat16": (127, 7, 0x7F80), "float16": (15, 10, 0x7C00)}
_TABLES: dict = {}
_ON_DEVICE: dict = {}


def sqrt_half(dtype: torch.dtype) -> float:
    """JAX's `np.sqrt(0.5).astype(x.dtype)`: sqrt(1/2) rounded to `dtype`."""
    return _SQRT_HALF.get(dtype) or torch.tensor(math.sqrt(0.5), dtype=dtype).item()


def erfc_grad(dtype: torch.dtype) -> float:
    """-2/sqrt(pi) rounded to `dtype` (bf16: -1.125)."""
    return _ERFC_GRAD[dtype]


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's card (no Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """fp32 x with its denormals flushed to zero of the same sign, as XLA's
    CPU backend computes (flush-to-zero and denormals-are-zero)."""
    return torch.where(x.abs() < _FP32_TINY, x * 0, x)


def _rnd(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """One op's fp32 result as XLA's CPU backend keeps it: flushed, rounded
    to the 16-bit dtype, widened again."""
    return _ftz(x).to(dt).float()


def gelu_plain(v: torch.Tensor) -> torch.Tensor:
    """Exact GELU of a 16-bit tensor as XLA's CPU backend computes JAX's
    `0.5 * x * erfc(-x * sqrt_half)`: erfc in fp32 of the product (bf16:
    unrounded; fp16: rounded to the dtype, as XLA's fp16 graph keeps it),
    rounded to the dtype, then T(0.5 * x) * e rounded once; denormals
    flushed at the input, at the product, at erfc and at the output."""
    dt = v.dtype
    f = _ftz(v.float())
    a = _ftz(f * -sqrt_half(dt))
    if dt == torch.float16:
        a = a.to(dt).float()
    e = _rnd(torch.erfc(a), dt)
    return _ftz(_rnd(0.5 * f, dt) * e).to(dt)


def gelu_window(dtype: torch.dtype):
    """-> (the table as uint32 [65536] numpy, the bit magnitudes (lo, hi)
    of its window) for a 16-bit dtype: entry b holds the GELU gradient's
    terms e (low half) and ex (high half) for the value of bit pattern b
    (`tests/gen_torch_gelu_table.py`); every magnitude below lo shares lo's
    entry and every finite one above hi hi's, for each sign. Read once;
    raises if a file is missing or the table is not the 65,536 entries the
    window describes."""
    hit = _TABLES.get(dtype)
    if hit is None:
        name = _DTYPE_NAMES[dtype]
        table = np.load(os.path.join(_DATA, f"gelu_{_SHORT[name]}_table.npy"))
        with open(os.path.join(_DATA, "gelu_window.json")) as f:
            win = json.load(f)[name]
        if table.shape != (1 << 16,) or table.dtype != np.uint32:
            raise ValueError(f"gelu table for {name}: expected uint32 [65536], got {table.dtype} "
                             f"{list(table.shape)}")
        bias, mant, inf = _FORMATS[name]
        lo, hi = ((win["lo_exp"] + bias) << mant) - 1, (win["hi_exp"] + bias) << mant
        mags = np.arange(inf)
        for sign in (0, 0x8000):
            t = table[sign | mags]
            if not (0 <= lo < hi < inf and np.all(t[:lo] == t[lo]) and np.all(t[hi:] == t[hi])):
                raise ValueError(f"gelu table for {name}: not constant outside its window "
                                 f"[{lo}, {hi}]")
        hit = _TABLES[dtype] = (table, lo, hi)
    return hit


def _device_table(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The table of `gelu_window` on `device` as int32 [65536], loaded once
    a device."""
    key = (dtype, str(device))
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = torch.from_numpy(gelu_window(dtype)[0].view(np.int32)).to(device)
    return t


def gelu_plain_grad(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The gradient of `gelu_plain` at v for the output gradient g (16-bit,
    one dtype and shape) as XLA's CPU backend computes JAX's vjp of
    `jax.nn.gelu(approximate=False)`: e = T(erfc(a)) and ex =
    T(exp(-T(T(a)^2))) read from the table by v's bits, then, each product
    rounded to T and denormals flushed,
    T(T(T(g * e) * 0.5) - T(T(T(T(T(0.5 v) * g) * k) * ex) * s)),
    k = T(-2/sqrt(pi)), s = T(sqrt(1/2))."""
    dt = v.dtype
    terms = _device_table(dt, v.device).view(torch.int16).view(-1, 2)
    w = terms[v.reshape(-1).view(torch.int16).long() & 0xFFFF]
    e, ex = (_ftz(w[:, i].view(dt).float().reshape(v.shape)) for i in (0, 1))
    f, g32 = _ftz(v.float()), _ftz(g.float())
    t = _rnd(_rnd(_rnd(_rnd(_rnd(0.5 * f, dt) * g32, dt) * erfc_grad(dt), dt) * ex, dt)
             * sqrt_half(dt), dt)
    return _ftz(_rnd(_rnd(g32 * e, dt) * 0.5, dt) - t).to(dt)


def gelu_grad(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """`gelu_plain_grad(g, v)`: one `tt_gelu_grad` launch for CUDA tensors
    (g and v of one 16-bit dtype and shape, contiguous), the plain version
    for CPU tensors."""
    global _GELU_GRAD
    if not g.is_cuda:
        return gelu_plain_grad(g, v)
    if g.dtype not in _DTYPES or v.dtype != g.dtype or v.shape != g.shape:
        raise ValueError(f"gelu_grad: expected two bfloat16 or float16 tensors of one shape, "
                         f"got {g.dtype} {tuple(g.shape)} and {v.dtype} {tuple(v.shape)}")
    g, v = g.contiguous(), v.contiguous()
    out = torch.empty_like(g)
    if g.numel():
        if _GELU_GRAD is None:
            _GELU_GRAD = entry("bias_act", "tt_gelu_grad", 4, 3, n_float=2, n_i64=1)
        _, lo, hi = gelu_window(g.dtype)
        code, s = _DTYPES[g.dtype]
        _raise_on(_GELU_GRAD(g.data_ptr(), v.data_ptr(), out.data_ptr(),
                             _device_table(g.dtype, g.device).data_ptr(), code, lo, hi,
                             g.numel(), s, erfc_grad(g.dtype), _stream(g)), "tt_gelu_grad")
        LAUNCHES[GG] += 1
    return out


class _GeluPlain(torch.autograd.Function):
    """`gelu_plain` with `gelu_plain_grad` as its backward, so that autograd
    through the plain version takes JAX's gradient (autograd's own, through
    the forward's ops, rounds elsewhere)."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return gelu_plain(v)

    @staticmethod
    def backward(ctx, g):
        v, = ctx.saved_tensors
        return gelu_plain_grad(g, v)


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
    y = F.relu(v) if act == "relu" else _GeluPlain.apply(v)
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
    """Memory order -> the step in elements between channels, p's stride
    along `dim`: 1 where the channel is the innermost dimension (a
    Linear's [..., C], an NCHW tensor in channels_last memory), H * W for a
    contiguous NCHW tensor. The channel of element i is then (i / step) % C."""
    if p.is_contiguous() or (p.dim() == 4 and dim % 4 == 1
                             and p.is_contiguous(memory_format=torch.channels_last)):
        return p.stride(dim)
    raise ValueError(f"bias_act: expected a contiguous tensor with channels along dim {dim}, "
                     f"or an NCHW one in channels_last memory; got {tuple(p.shape)} strides "
                     f"{p.stride()}")


def _check_bias(bias: torch.Tensor, p: torch.Tensor, c: int) -> None:
    if (bias.shape != (c,) or not bias.is_contiguous() or bias.device != p.device
            or bias.dtype != p.dtype):
        raise ValueError(f"bias: expected a contiguous [{c}] {p.dtype} tensor on {p.device}, "
                         f"got {tuple(bias.shape)} {bias.dtype} on {bias.device}")


def _launch(p: torch.Tensor, bias: Optional[torch.Tensor], act: str, keep_pre: bool,
            dim: int):
    """One `tt_bias_act` launch -> (the activation, the pre-activation
    value or None)."""
    global _BIAS_ACT
    dt = _DTYPES.get(p.dtype)
    if dt is None:
        raise ValueError(f"bias_act: expected a bfloat16 or float16 tensor, got {p.dtype}")
    div = _channel_divisor(p, dim)
    c = p.shape[dim]
    if bias is not None:
        _check_bias(bias, p, c)
    y = torch.empty_like(p)
    pre = torch.empty_like(p) if keep_pre else None
    n = p.numel()
    if n:
        if _BIAS_ACT is None:
            _BIAS_ACT = entry("bias_act", "tt_bias_act", 4, 2, n_float=1, n_i64=2)
        _raise_on(_BIAS_ACT(p.data_ptr(), None if bias is None else bias.data_ptr(),
                            y.data_ptr(), None if pre is None else pre.data_ptr(), c,
                            dt[0] * 4 + _ACT_CODES[act], n, div, dt[1], _stream(p)),
                  "tt_bias_act")
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
                       residual: Optional[torch.Tensor] = None, dim: int = -1) -> torch.Tensor:
    """The fp32-output mode's plain version: y (bf16 or fp16) plus the bias
    [C] along `dim` rounded to y's dtype, both widened to fp32, never
    rounded; then residual + that sum (residual fp32, of y's shape or
    broadcast over its leading dimensions)."""
    s = y.float() + bias_view(bias.to(y.dtype).float(), y, dim)
    return s if residual is None else residual + s


def bias_add_f32_grads(g: Optional[torch.Tensor], y_dtype: torch.dtype,
                       bias_shape: torch.Size, bias_dtype: torch.dtype,
                       residual_shape: Optional[torch.Size]):
    """The backward of `bias_add_f32_plain` as autograd takes it, for the
    output's gradient g (fp32) -> (y's gradient, g cast to y's dtype; the
    bias's, g summed to `bias_shape` (the bias as it broadcasts against y,
    `bias_view`), flattened and cast to its dtype; the residual's, g
    summed to its shape, None without a residual); all None without g."""
    if g is None:
        return None, None, None
    gb = g.sum_to_size(bias_shape).reshape(-1).to(bias_dtype)
    gr = None if residual_shape is None else g.sum_to_size(residual_shape)
    return g.to(y_dtype), gb, gr


def residual_period(residual: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """A residual that broadcasts to `shape` (y's) over leading dimensions
    only -> a contiguous tensor whose flat values, repeated, are the
    broadcast residual's: the residual itself where it is contiguous and
    y's trailing dimensions behind size-1 ones (the path's: y's shape,
    [1, S, D], [1, 1, D]; no copy), else the residual without the leading
    dimensions that broadcast (size 1 against more, or stride 0 in an
    expanded view). Raises if it broadcasts elsewhere."""
    lead_ones = 0
    while lead_ones < residual.dim() - 1 and residual.shape[lead_ones] == 1:
        lead_ones += 1
    tail = residual.shape[lead_ones:]
    if (residual.is_contiguous() and len(tail) <= len(shape)
            and tail == shape[len(shape) - len(tail):]):
        return residual
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


def _launch_f32(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
                dim: int) -> torch.Tensor:
    """One `tt_bias_add_f32` launch -> the fp32 output, y's shape and
    memory format."""
    global _BIAS_ADD_F32
    dt = _DTYPES.get(y.dtype)
    if dt is None:
        raise ValueError(f"bias_add_f32: expected a bfloat16 or float16 tensor, got {y.dtype}")
    div = _channel_divisor(y, dim)
    c = y.shape[dim]
    _check_bias(bias, y, c)
    r = None
    if residual is not None:
        if residual.dtype != torch.float32 or residual.device != y.device or div != 1:
            raise ValueError(f"bias_add_f32: expected an fp32 residual on {y.device} and "
                             f"channels innermost, got {residual.dtype} on {residual.device}, "
                             f"channels along dim {dim} of strides {y.stride()}")
        r = residual_period(residual, y.shape)
    out = torch.empty_like(y, dtype=torch.float32)
    n = y.numel()
    if n:
        if _BIAS_ADD_F32 is None:
            _BIAS_ADD_F32 = entry("bias_act", "tt_bias_add_f32", 4, 2, n_i64=3)
        _raise_on(_BIAS_ADD_F32(y.data_ptr(), bias.data_ptr(),
                                None if r is None else r.data_ptr(), out.data_ptr(), c, dt[0],
                                n, div, 1 if r is None else r.numel(), _stream(y)),
                  "tt_bias_add_f32")
        LAUNCHES[BA] += 1
    return out


class _BiasAddF32(torch.autograd.Function):
    """The fp32-output mode with the plain version's backward
    (`bias_add_f32_grads`)."""

    @staticmethod
    def forward(ctx, y, bias, residual, dim):
        ctx.set_materialize_grads(False)
        ctx.y_dtype, ctx.bias_dtype = y.dtype, bias.dtype
        ctx.bias_shape = bias_view(bias, y, dim).shape
        ctx.residual_shape = None if residual is None else residual.shape
        return _launch_f32(y, bias, residual, dim)

    @staticmethod
    def backward(ctx, g):
        return (*bias_add_f32_grads(g, ctx.y_dtype, ctx.bias_shape, ctx.bias_dtype,
                                    ctx.residual_shape), None)


def bias_add_f32(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                 dim: int = -1) -> torch.Tensor:
    """y bf16 or fp16, a product without its bias, its channels along
    `dim` (-1: a Linear's [..., C]; 1: a CRAFT conv's NCHW, contiguous or in
    channels_last memory); bias [C] (rounded to y's dtype); residual fp32
    of y's shape or broadcast over its leading dimensions ([1, S, D]
    against [N, S, D]; channels innermost only), or None -> residual +
    (fp32(y) + fp32(bias)) in fp32, y's shape and memory format, never
    rounded to y's dtype. One `tt_bias_add_f32` launch for CUDA tensors,
    differentiable (`_BiasAddF32`); the plain version for CPU tensors."""
    if not y.is_cuda:
        return bias_add_f32_plain(y, bias, residual, dim)
    if bias.dtype != y.dtype:
        bias = bias.to(y.dtype)
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad or (
            residual is not None and residual.requires_grad)):
        return _BiasAddF32.apply(y, bias, residual, dim)
    return _launch_f32(y, bias, residual, dim)
