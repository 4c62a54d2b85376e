"""Neural-net building blocks of the port (the part of
`tuatara_tpu/models/layers.py` that the default OCR path and int8 serving
use).

Dtype policy, as in the JAX package: parameters are loaded in fp32; the
weights of convolutions and linear layers are cast once to the model's
compute dtype (`set_compute_dtype`), and each such layer casts its input to
that dtype, so products run in the compute dtype with fp32 accumulation.
LayerNorm and softmax always run in fp32. GELU is the exact erf form.
At a 16-bit compute dtype the port rounds where XLA's CPU backend rounds
JAX's compiled bf16 graph: a product is rounded to the dtype before its
bias is added, with a second rounding (`add_bias`: `torch.add`, or the
`bias_act` kernel where a ReLU or GELU follows), except where a Linear's
sum goes straight into an fp32 add (PARSEQ's residuals, `patch_embed +
pos_embed`): there XLA adds the bias in fp32 and never rounds the sum, so
`Linear(x, residual=r)` returns `r + (fp32(y) + fp32(b))` in fp32
(`kernels.bias_act.bias_add_f32`, one pass with the residual); the
attention logits are fp32 sums never rounded to the dtype
(`attention_logits`); GELU rounds erfc to the dtype before its last
product (`kernels.bias_act.gelu_plain`).

int8 serving (`QConv`, JAX's `quantize_conv` / `conv2d_q` family, and
`QLinear`, its `quantize_linear` / `linear_q`): weights per output channel
and activations per tensor, symmetric, int8 x int8 -> int32 sums (exact,
so equal to JAX's), then `y.float() * (sw / xs) + b` and a cast to the
compute dtype, in JAX's order. An activation's scale is dynamic (its
abs-max) until `make_static_quant` freezes a calibrated one.

Training (`train/`): the initialisers draw from an explicit
`torch.Generator` with JAX's distributions (`he_normal_conv`,
`trunc_normal`, `xavier_uniform`); `BatchNorm` holds CRAFT's unfolded
BatchNorm and normalises with batch statistics when asked (JAX
`batchnorm_train`); `cast_products` runs the products of a module's Conv
and Linear layers in a compute dtype while its parameters stay fp32, as
JAX casts input and weight at each product.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tuatara_tpu_torch.kernels.bias_act import bias_act, bias_add_f32, bias_view
from tuatara_tpu_torch.kernels.int8 import int8_conv, int8_linear, weight_matrix


def _cast(layer: nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Conv's or Linear's (weight, bias) in the layer's `compute_dtype`
    (None: as stored)."""
    w, b = layer.weight, layer.bias
    if layer.compute_dtype is not None:
        w, b = w.to(layer.compute_dtype), b.to(layer.compute_dtype)
    return w, b


def add_bias(y: torch.Tensor, b: Optional[torch.Tensor], act: Optional[str] = None,
             keep_pre: bool = False, dim: int = 1):
    """A 16-bit product y, rounded to its dtype, plus the bias b (or None)
    along `dim`, rounded again (JAX's `y + params["b"].astype(y.dtype)`),
    then `act` ("relu", "gelu" or None). With an activation, one
    `bias_act` pass (with `keep_pre`, also the pre-activation value);
    without, one `torch.add`, which rounds the same way."""
    if act is not None:
        return bias_act(y, b, act, keep_pre, dim)
    if b is None:
        return y
    return y + bias_view(b.to(y.dtype), y, dim)


class Conv(nn.Module):
    """2-D convolution over NCHW with an OIHW weight, "SAME" padding."""

    compute_dtype: Optional[torch.dtype] = None  # set by `cast_products`

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dilation = dilation
        self.padding = dilation * (k - 1) // 2

    def forward(self, x: torch.Tensor, relu: bool = False, keep_pre: bool = False):
        """-> the output, its ReLU with `relu`, or (the ReLU, the output)
        with `keep_pre` as well (a trunk conv that feeds a skip). At fp32
        the bias is part of the product; at a 16-bit compute dtype the
        product is rounded first and the bias added with a second
        rounding, as JAX's `conv2d` does (`add_bias`)."""
        w, b = _cast(self)
        x = x.to(w.dtype)
        if w.dtype == torch.float32:
            y = F.conv2d(x, w, b, padding=self.padding, dilation=self.dilation)
            if not relu:
                return y
            return (F.relu(y), y) if keep_pre else F.relu(y)
        y = F.conv2d(x, w, None, padding=self.padding, dilation=self.dilation)
        return add_bias(y, b, "relu" if relu else None, keep_pre)


class Linear(nn.Module):
    """y = x @ W^T + b, W stored [out, in]."""

    compute_dtype: Optional[torch.dtype] = None  # set by `cast_products`

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, act: Optional[str] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> x @ W^T + b, its exact GELU with act="gelu", or residual +
        (x @ W^T + b) in fp32 with an fp32 `residual` (of the output's shape
        or broadcast over its leading dimensions). At fp32 the bias is part
        of the product; at a 16-bit compute dtype the product is rounded
        first, as JAX's `linear` does, and then either the bias is added
        with a second rounding (`add_bias`) or, with a residual, added in
        fp32 and never rounded, as XLA compiles JAX's `x + linear(h)`
        (`bias_add_f32`)."""
        if act is not None and residual is not None:
            raise ValueError("Linear: an activation and a residual do not go together")
        w, b = _cast(self)
        x = x.to(w.dtype)
        if w.dtype == torch.float32:
            y = F.linear(x, w, b)
            if residual is not None:
                return residual + y
            return gelu(y) if act else y
        if residual is not None:
            return bias_add_f32(F.linear(x, w), b, residual)
        return add_bias(F.linear(x, w), b, act, dim=-1)


class PaddedLinear(Linear):
    """A Linear whose product runs at an output width rounded up to a
    multiple of 8 (zero rows, sliced off after). On the card cuBLAS picks
    the kernel of a bf16 product whose output width is not a multiple of 8
    by its row count, so a row's result depended on how many rows shared
    the call: the recognizer head (95 classes) gave other logits, and
    other confidences, when a slab held more padding rows. At a multiple
    of 8 the rows' results do not depend on the row count."""

    def forward(self, x: torch.Tensor, fp32_logits: bool = False) -> torch.Tensor:
        """-> x @ W^T + b. With `fp32_logits` at a 16-bit compute dtype, the
        bias is added to the rounded product in fp32 and never rounded
        (`bias_add_f32`), as XLA compiles JAX's training loss, whose
        log-softmax reads the head's logits as fp32; else rounded, as its
        serving graph keeps them (argmax and softmax of bf16 logits)."""
        n = self.weight.shape[0]
        w, b = _cast(self)
        pad = -n % 8
        if pad:
            w, b = F.pad(w, (0, 0, 0, pad)), F.pad(b, (0, pad))
        x = x.to(w.dtype)
        if w.dtype == torch.float32:
            return F.linear(x, w, b)[..., :n]
        y = F.linear(x, w)
        y = bias_add_f32(y, b) if fp32_logits else add_bias(y, b, dim=-1)
        return y[..., :n]


class LayerNorm(nn.Module):
    """LayerNorm in fp32 whatever the input dtype (output fp32)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                            self.eps)


@contextlib.contextmanager
def cast_products(module: nn.Module, dtype: torch.dtype):
    """For the calls it encloses, every Conv and Linear of `module` casts
    its input, weight and bias to `dtype` at each call (JAX's
    `x.astype(compute_dtype)` and `w.astype(compute_dtype)` in `conv2d` /
    `linear`); the fp32 parameters stay as they are, so gradients reach
    them in fp32. LayerNorm, BatchNorm and softmax stay fp32. The layers'
    own setting is restored on exit."""
    layers = [m for m in module.modules() if isinstance(m, (Conv, Linear))]
    old = [m.compute_dtype for m in layers]
    for m in layers:
        m.compute_dtype = dtype
    try:
        yield module
    finally:
        for m, d in zip(layers, old):
            m.compute_dtype = d


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the weights of every Conv and Linear to `dtype` (LayerNorms and
    free parameters such as embeddings stay fp32); every QConv and QLinear
    keeps its int8 weights and fp32 scales and outputs `dtype`."""
    for m in module.modules():
        if isinstance(m, (Conv, Linear)):
            m.weight.data = m.weight.data.to(dtype)
            m.bias.data = m.bias.data.to(dtype)
        elif isinstance(m, (QConv, QLinear)):
            m.out_dtype = dtype
    return module


# ---------------------------------------------------------------------------
# int8 serving
# ---------------------------------------------------------------------------

def quantize_conv(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 weights (JAX `quantize_conv`):
    OIHW fp32 -> (wq [kh, kw, cin, cout] int8, JAX's HWIO layout; sw [cout]
    fp32), sw = max(amax, 1e-12) / 127, wq = clip(round(w / sw), +-127)."""
    w = w.float()
    sw = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
    wq = torch.clamp(torch.round(w / sw[:, None, None, None]), -127, 127).to(torch.int8)
    return wq.permute(2, 3, 1, 0).contiguous(), sw


def _abs_max(x: torch.Tensor) -> torch.Tensor:
    """max |x| of an NCHW tensor, fp32 scalar. Exact in any dtype, with no
    abs() pass; over the NHWC view, the memory order of the trunk's
    channels_last activations (a reduction over a non-contiguous view
    copies it first)."""
    lo, hi = torch.aminmax(x.permute(0, 2, 3, 1))
    return torch.maximum(-lo, hi).float()


def _global_amax(amax: torch.Tensor) -> torch.Tensor:
    """A local abs-max -> its max over the ranks of an open `amax_group`
    (the data-parallel shards of one batch), else as it is."""
    if _AMAX_GROUP is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=_AMAX_GROUP)
    return amax


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8 (JAX `quantize_act`): x [B, C, H,
    W] -> (xq [B, H, W, C] int8, xs fp32 scalar), xs = 127 / max(amax,
    1e-12) over the whole tensor, batch included (under `amax_group`, the
    whole batch of every rank)."""
    amax = torch.clamp(_global_amax(_abs_max(x)), min=1e-12)
    # A true division: `127.0 / tensor` is a reciprocal times 127 in torch,
    # one more rounding than JAX's quotient.
    xs = torch.full_like(amax, 127.0) / amax
    return _round_int8(x, xs), xs


def _round_int8(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """NCHW x -> NHWC clip(round(x * xs), +-127) int8, the product in fp32
    (xs as a [1] tensor takes part in type promotion, so a bf16 x is read
    once). torch.round rounds half to even, as jnp.round does."""
    y = torch.mul(x.permute(0, 2, 3, 1), xs.reshape(1))
    return y.round_().clamp_(-127, 127).to(torch.int8).contiguous()


def dequant(acc: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
            out_dtype: torch.dtype) -> torch.Tensor:
    """int32 sums [..., O] -> `acc * scale (+ bias)` in fp32 with one
    rounding, as XLA compiles JAX's dequant (it contracts the two into a
    fused multiply-add), then cast to out_dtype. On the card one
    `torch.addcmul` (an fma there) reading the int32 sums and writing
    out_dtype; on the CPU in float64 after the sums' rounding to fp32
    (JAX's `astype(float32)`, and the card's type promotion), where the
    product of two fp32 values is exact, then rounded to fp32."""
    if acc.is_cuda:
        out = torch.empty(acc.shape, dtype=out_dtype, device=acc.device)
        if bias is None:
            return torch.mul(acc, scale, out=out)
        return torch.addcmul(bias, acc, scale, out=out)
    y = acc.float().double() * scale.double()
    if bias is not None:
        y = y + bias.double()
    return y.float().to(out_dtype)


class QConv(nn.Module):
    """int8 convolution over NCHW (JAX `conv2d_q`, "SAME" padding): int8
    weights `wq` [kh, kw, cin, cout] (also held as `wmat` [cout, kh*kw*cin]
    for the GEMM) and their scales `sw` [cout], the fp32
    bias (or None), and `sx`, the calibrated static activation scale (None:
    dynamic). The output is NCHW in channels_last memory, `out_dtype`."""

    def __init__(self, wq: torch.Tensor, sw: torch.Tensor, bias: Optional[torch.Tensor],
                 dilation: int = 1):
        super().__init__()
        self.register_buffer("wq", wq)
        self.register_buffer("wmat", weight_matrix(wq), persistent=False)
        self.register_buffer("sw", sw)
        self.register_buffer("bias", bias)
        self.register_buffer("sx", None)
        self.dilation = dilation
        self.out_dtype = torch.float32

    @classmethod
    def from_weight(cls, w: torch.Tensor, bias: Optional[torch.Tensor],
                    dilation: int = 1) -> "QConv":
        """Quantize an fp32 OIHW weight (BN already folded)."""
        wq, sw = quantize_conv(w)
        return cls(wq, sw, None if bias is None else bias.detach().float().clone(), dilation)

    @property
    def cin(self) -> int:
        return self.wq.shape[2]

    @property
    def cout(self) -> int:
        return self.wq.shape[3]

    def quantize_input(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """JAX `quantize_act_q`: the static scale when calibrated, else the
        dynamic one; the input's abs-max goes to an open `calibration()`."""
        if _CALIB is not None:
            amax = float(_abs_max(x))
            _CALIB[self] = max(_CALIB.get(self, amax), amax)
        if self.sx is None:
            return quantize_act(x)
        return _round_int8(x, self.sx), self.sx

    def sums(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (the exact int32 sums [B, H, W, O], the dequant scale sw / xs)."""
        xq, xs = self.quantize_input(x)
        return int8_conv(xq, self.wmat, self.wq.shape[0], self.dilation), self.sw / xs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """JAX `conv2d_q`: quantize, the exact int32 sums, then `y.float() *
        (sw / xs) + b`, cast to `out_dtype`."""
        acc, scale = self.sums(x)
        return dequant(acc, scale, self.bias, self.out_dtype).permute(0, 3, 1, 2)


def quantize_linear(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column symmetric int8 weights (JAX `quantize_linear`):
    [out, in] fp32 -> (wq [in, out] int8, JAX's layout; sw [out] fp32),
    sw = max(amax, 1e-12) / 127, wq = clip(round(w / sw), +-127)."""
    w = w.float()
    sw = torch.clamp(w.abs().amax(dim=1), min=1e-12) / 127.0
    wq = torch.clamp(torch.round(w / sw[:, None]), -127, 127).to(torch.int8)
    return wq.t().contiguous(), sw


class QLinear(nn.Module):
    """int8 linear layer (JAX `linear_q`): int8 weights `wq` [in, out]
    (also held as `wmat` [out, in], K-contiguous, for the GEMM), their
    scales `sw` [out], the fp32 bias (or None) and `sx`, the calibrated
    static activation scale (None: dynamic, one abs-max over the whole
    input, every row of the slab included). x [..., in] in any float dtype
    -> [..., out] in `out_dtype`."""

    def __init__(self, wq: torch.Tensor, sw: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("wq", wq)
        self.register_buffer("wmat", wq.t().contiguous(), persistent=False)
        self.register_buffer("sw", sw)
        self.register_buffer("bias", bias)
        self.register_buffer("sx", None)
        self.out_dtype = torch.float32

    @classmethod
    def from_linear(cls, lin: "Linear") -> "QLinear":
        """Quantize an fp32 Linear."""
        wq, sw = quantize_linear(lin.weight.detach())
        return cls(wq, sw, lin.bias.detach().float().clone())

    @property
    def cin(self) -> int:
        return self.wq.shape[0]

    @property
    def cout(self) -> int:
        return self.wq.shape[1]

    def quantize_input(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """JAX `quantize_act_q` over [..., in]: the static scale when
        calibrated, else 127 / max(amax, 1e-12); the input's abs-max goes
        to an open `calibration()`."""
        if _CALIB is not None or self.sx is None:
            lo, hi = torch.aminmax(x)
            amax = torch.maximum(-lo, hi).float()
            if _CALIB is not None:
                _CALIB[self] = max(_CALIB.get(self, float(amax)), float(amax))
        if self.sx is None:
            amax = torch.clamp(_global_amax(amax), min=1e-12)
            xs = torch.full_like(amax, 127.0) / amax  # a true division, as in JAX
        else:
            xs = self.sx
        xq = torch.mul(x, xs.reshape(1)).round_().clamp_(-127, 127).to(torch.int8)
        return xq, xs

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> the output in `out_dtype`; with a residual, residual + that
        (JAX's `linear_q` rounds its fp32 sum to out_dtype explicitly, and
        XLA keeps that rounding before the residual add)."""
        xq, xs = self.quantize_input(x)
        y = dequant(int8_linear(xq, self.wmat), self.sw / xs, self.bias, self.out_dtype)
        return y if residual is None else residual + y


# Under a data-parallel mesh each rank quantizes its shard of a batch with
# the scale of the whole batch, as JAX's partitioned program does: while an
# `amax_group(group)` context is open, a dynamic scale's abs-max is the max
# over the group's ranks.
_AMAX_GROUP: Optional["dist.ProcessGroup"] = None


@contextlib.contextmanager
def amax_group(group):
    """Dynamic activation scales over the ranks of `group` (None: this
    rank's tensor alone) for the forwards it encloses."""
    global _AMAX_GROUP
    prev, _AMAX_GROUP = _AMAX_GROUP, group
    try:
        yield
    finally:
        _AMAX_GROUP = prev


# Calibration: while a `calibration()` context is open, every QConv and
# QLinear records its input's abs-max under its own module (JAX keys on id()
# of the weight array; a module is the port's stable identity for the layer).
_CALIB: Optional[Dict[nn.Module, float]] = None


class calibration:
    """Context collecting {QConv or QLinear: input abs-max} over the
    forwards it encloses (JAX `layers.calibration`)."""

    def __enter__(self) -> Dict[nn.Module, float]:
        global _CALIB
        self._prev = _CALIB
        _CALIB = {}
        return _CALIB

    def __exit__(self, *exc) -> None:
        global _CALIB
        _CALIB = self._prev


def merge_calib_stats(stats: Iterable[Dict[nn.Module, float]]) -> Dict[nn.Module, float]:
    """Per-layer max across per-batch calibration stats."""
    out: Dict[nn.Module, float] = {}
    for s in stats:
        for k, v in s.items():
            out[k] = max(out[k], float(v)) if k in out else float(v)
    return out


def static_scale(amax: float, margin: float) -> np.float32:
    """JAX `make_static_quant`'s sx = 127 / (amax * margin), in double
    precision then fp32."""
    return np.float32(127.0 / (max(float(amax), 1e-12) * margin))


def make_static_quant(stats: Dict[nn.Module, float], margin: float = 1.1) -> int:
    """Freeze sx into every QConv / QLinear in `stats` (replacing an earlier one);
    layers the calibration never ran keep dynamic scales. -> layers set."""
    for q, amax in stats.items():
        q.sx = torch.tensor(static_scale(amax, margin), device=q.wq.device)
    return len(stats)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU: `F.gelu` at fp32; at a 16-bit dtype rounded as XLA's
    CPU backend rounds JAX's bf16 `jax.nn.gelu(approximate=False)`
    (`kernels.bias_act.gelu_plain`), one `bias_act` pass on the card."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    return add_bias(x, None, "gelu", dim=-1)


def linear_gelu(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """gelu(lin(x)): a float Linear adds its bias and the GELU in one pass."""
    return lin(x, act="gelu") if isinstance(lin, Linear) else gelu(lin(x))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """fc2(gelu(fc1(x))), plus `residual` inside fc2 (`Linear`)."""
        return self.fc2(linear_gelu(self.fc1, x), residual=residual)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, heads, d // heads).transpose(1, 2)  # [B, H, L, hd]


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


class _Fp32Logits(torch.autograd.Function):
    """q3 [B, Lq, hd] @ k3 [B, Lk, hd]^T of a 16-bit dtype -> fp32 [B, Lq,
    Lk]: one cuBLAS product with an fp32 output. Its backward is the one
    autograd takes through the same product of the operands cast to fp32
    (exact): fp32 products, the gradients cast back."""

    @staticmethod
    def forward(ctx, q3, k3):
        ctx.save_for_backward(q3, k3)
        return torch.bmm(q3, k3.transpose(1, 2), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        q3, k3 = ctx.saved_tensors
        gq = torch.bmm(g, k3.float()).to(q3.dtype) if ctx.needs_input_grad[0] else None
        gk = (torch.bmm(g.transpose(1, 2), q3.float()).to(k3.dtype)
              if ctx.needs_input_grad[1] else None)
        return gq, gk


def attention_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [..., Lq, hd] @ k[..., Lk, hd]^T in fp32, the sums of the products
    of q's dtype never rounded to it: XLA folds JAX's
    `einsum(...).astype(float32)` into a dot with an fp32 result. At a
    16-bit dtype on the card, one cuBLAS product with an fp32 output
    (`_Fp32Logits`, differentiable); on the CPU, which has no such
    product, the same sums of the operands cast to fp32 (exact)."""
    k = k.to(q.dtype)
    if q.dtype == torch.float32:
        return torch.matmul(q, k.transpose(-1, -2))
    if not q.is_cuda:
        return torch.matmul(q.float(), k.float().transpose(-1, -2))
    lq, lk = q.shape[-2], k.shape[-2]
    lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2])
    q3 = q.expand(*lead, *q.shape[-2:]).reshape(-1, lq, q.shape[-1])
    k3 = k.expand(*lead, *k.shape[-2:]).reshape(-1, lk, k.shape[-1])
    return _Fp32Logits.apply(q3, k3).reshape(*lead, lq, lk)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over [B, H, L, hd]: the logits in fp32
    (`attention_logits`), the scale and softmax in fp32, the probabilities
    rounded to the inputs' dtype for their product with v; mask True =
    attend."""
    dtype = q.dtype
    logits = attention_logits(q, k) * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p.to(dtype), v.to(dtype))


class MHA(nn.Module):
    """Multi-head attention with separate q/k/v/o projections."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = Linear(dim, dim)
        self.k = Linear(dim, dim)
        self.v = Linear(dim, dim)
        self.o = Linear(dim, dim)

    def kv(self, xkv: torch.Tensor):
        return split_heads(self.k(xkv), self.heads), split_heads(self.v(xkv), self.heads)

    def attend(self, xq: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Attention over cached k, v [B, H, Lk, hd]; with a residual, the
        output projection adds it (`Linear`: residual + o(...) in fp32)."""
        q = split_heads(self.q(xq), self.heads)
        return self.o(merge_heads(attention_core(q, k, v, mask)), residual=residual)

    def forward(self, xq: torch.Tensor, xkv: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        k, v = self.kv(xkv)
        return self.attend(xq, k, v, mask, residual)


class VitBlock(nn.Module):
    """Pre-norm ViT block (timm style), fp32 residual stream."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, eps: float):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps)
        self.attn = MHA(dim, heads)
        self.norm2 = LayerNorm(dim, eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x + attn(norm1(x)), then that + mlp(norm2(that)): each residual
        added inside the output projection (o, fc2), in fp32."""
        h = self.norm1(x)
        x = self.attn(h, h, residual=x)
        return self.mlp(self.norm2(x), residual=x)


# ---------------------------------------------------------------------------
# Training: initialisers (JAX's distributions, drawn from a torch.Generator)
# and CRAFT's unfolded BatchNorm
# ---------------------------------------------------------------------------

def he_normal_conv(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int) -> torch.Tensor:
    """OIHW weight ~ N(0, 2 / (kh * kw * cin)) (JAX `he_normal_conv`)."""
    std = math.sqrt(2.0 / (kh * kw * cin))
    return torch.randn((cout, cin, kh, kw), generator=gen) * std


def trunc_normal(gen: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    """The standard normal truncated to [-2, 2], times `std` (JAX
    `trunc_normal`), by the inverse CDF of a uniform draw."""
    def cdf(v):
        return 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))

    lo, hi = 2.0 * cdf(-2.0) - 1.0, 2.0 * cdf(2.0) - 1.0
    u = torch.rand(shape, generator=gen) * (hi - lo) + lo
    return torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0) * std


def xavier_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """U(-l, l), l = sqrt(6 / (fan_in + fan_out)) over a 2-D shape (JAX
    `xavier_uniform`; the sum is the same for [in, out] and [out, in])."""
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


@torch.no_grad()
def init_conv(conv: Conv, gen: torch.Generator) -> None:
    """He-normal weight, zero bias (JAX `init_conv`), in place."""
    cout, cin, kh, kw = conv.weight.shape
    conv.weight.copy_(he_normal_conv(gen, kh, kw, cin, cout))
    conv.bias.zero_()


@torch.no_grad()
def init_linear(lin: Linear, gen: torch.Generator, init=trunc_normal) -> None:
    """`init` weight ([out, in]), zero bias (JAX `init_linear`), in place."""
    lin.weight.copy_(init(gen, tuple(lin.weight.shape)))
    lin.bias.zero_()


class BatchNorm(nn.Module):
    """BatchNorm over NCHW with fp32 output whatever the input dtype: the
    scale `weight` and shift `bias` are trained; the running `mean` and
    `var` are buffers (JAX holds the four as leaves {scale, bias, mean,
    var}). `forward(x, train=True)` is JAX `batchnorm_train`: normalise
    with the batch mean and the biased batch variance, and update the
    buffers in place with `momentum`, the running variance from the
    unbiased estimate (`F.batch_norm(training=True)`'s contract);
    `train=False` is JAX `batchnorm` on the running statistics."""

    sync_group = None  # set by `train.trainer.shard_train_state` under dp

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.eps = eps

    def forward(self, x: torch.Tensor, train: bool, momentum: float = 0.1) -> torch.Tensor:
        if train and self.sync_group is not None:
            return self._forward_synced(x.float(), momentum)
        return F.batch_norm(x.float(), self.mean, self.var, self.weight, self.bias,
                            training=train, momentum=momentum, eps=self.eps)

    def _forward_synced(self, x: torch.Tensor, momentum: float) -> torch.Tensor:
        """Batch statistics over the global batch of `sync_group`'s ranks,
        by JAX `batchnorm_train`'s formula: the mean, then the biased
        variance as the mean squared deviation (two passes), each a sum
        all-reduced with its gradient (`torch.distributed.nn`). The running
        statistics take the same update on every rank."""
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        n_local = torch.tensor([x.numel() // c], dtype=torch.float32, device=x.device)
        dist.all_reduce(n_local, group=self.sync_group)
        n = float(n_local)
        mean = all_reduce(x.sum(dim=(0, 2, 3)), group=self.sync_group) / n
        d = x - mean[None, :, None, None]
        var = all_reduce((d * d).sum(dim=(0, 2, 3)), group=self.sync_group) / n
        inv = torch.rsqrt(var + self.eps)
        with torch.no_grad():
            self.mean.mul_(1 - momentum).add_(momentum * mean)
            self.var.mul_(1 - momentum).add_(momentum * var * (n / max(n - 1, 1)))
        return d * (inv * self.weight)[None, :, None, None] + self.bias[None, :, None, None]
