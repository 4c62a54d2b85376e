"""Tensor-parallel (Megatron) linear layers for training PARSEQ over a mesh's
'tp' axis (JAX `train/trainer.py parseq_param_pspecs`, whose sharding
annotations let XLA insert the collectives; here they are written out).

* `ColumnParallelLinear`: the weight's output rows are split over tp (JAX
  P(None, "tp") on its [in, out] layout); each rank computes its slice of
  the output. Its input enters through `copy_to_tp` (identity forward,
  all-reduce of the gradient backward). Its bias stays whole on every rank
  (JAX replicates every 1-D leaf): the forward adds this rank's slice and
  the backward assembles the whole bias gradient over tp.
* `RowParallelLinear`: the weight's input columns are split (JAX P("tp",
  None)); each rank's partial product is summed by `reduce_from_tp`
  (all-reduce forward, identity backward), and the whole bias is added
  once, after the sum, with the residual where one follows (o, fc2,
  linear2: in fp32 and never rounded at bf16, as `Linear` adds it).

A column layer followed by a row layer (q/k/v then o; fc1 then fc2;
linear1 then linear2) keeps the heads or hidden units of the pair on one
rank, so each pair costs one all-reduce forward and one backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tuatara_tpu_torch.kernels.bias_act import bias_add_f32
from tuatara_tpu_torch.models.layers import Linear, _cast, add_bias, gelu


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceAssemble(torch.autograd.Function):
    """b[lo:hi] forward; backward: the whole-size gradient, each rank's
    slice in place, summed over tp."""

    @staticmethod
    def forward(ctx, b, lo, hi, group):
        ctx.shape, ctx.lo, ctx.hi, ctx.group = b.shape, lo, hi, group
        return b[lo:hi]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.lo:ctx.hi] = g
        dist.all_reduce(full, group=ctx.group)
        return full, None, None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


class _ParallelLinear(Linear):
    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, group, rank: int, size: int):
        nn.Module.__init__(self)
        self.weight = nn.Parameter(weight.detach().clone().contiguous())
        self.bias = nn.Parameter(bias.detach().clone())
        self.weight.tp_sharded = True
        self.group, self.rank, self.size = group, rank, size


    @classmethod
    def from_linear(cls, lin: Linear, group, rank: int, size: int) -> "_ParallelLinear":
        return cls(cls.shard(lin.weight, rank, size), lin.bias, group, rank, size)


class ColumnParallelLinear(_ParallelLinear):
    """A Linear whose output rows [rank * o, (rank + 1) * o) this rank holds."""

    @staticmethod
    def shard(w: torch.Tensor, rank: int, size: int) -> torch.Tensor:
        """This rank's rows of an [out, in] tensor (the weight, its moments)."""
        o = w.shape[0] // size
        return w[rank * o:(rank + 1) * o].contiguous()

    def forward(self, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
        o = self.weight.shape[0]
        # The slice's gradient is assembled in fp32, then the cast's.
        b = _SliceAssemble.apply(self.bias, self.rank * o, (self.rank + 1) * o, self.group)
        w = self.weight
        if self.compute_dtype is not None:
            w, b = w.to(self.compute_dtype), b.to(self.compute_dtype)
        x = copy_to_tp(x, self.group).to(w.dtype)
        if w.dtype == torch.float32:
            y = F.linear(x, w, b)
            return gelu(y) if act else y
        return add_bias(F.linear(x, w), b, act, dim=-1)


class RowParallelLinear(_ParallelLinear):
    """A Linear whose input columns [rank * i, (rank + 1) * i) this rank holds."""

    @staticmethod
    def shard(w: torch.Tensor, rank: int, size: int) -> torch.Tensor:
        """This rank's columns of an [out, in] tensor (the weight, its moments)."""
        i = w.shape[1] // size
        return w[:, rank * i:(rank + 1) * i].contiguous()

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The partial products summed over tp in fp32 and rounded to the
        compute dtype, then the bias, rounded again, or with an fp32
        `residual`, residual + (sum + bias) in fp32 (`Linear`'s forms)."""
        w, b = _cast(self)
        y = F.linear(x.to(w.dtype), w)
        y = reduce_from_tp(y.float(), self.group).to(w.dtype)
        if residual is None:
            return y + b
        if w.dtype == torch.float32:
            return residual + (y + b)
        return bias_add_f32(y, b, residual)


def tp_sharded(p: torch.Tensor) -> bool:
    """Whether a parameter is a tensor-parallel shard (its square sum is
    part of the global norm on every tp rank)."""
    return bool(getattr(p, "tp_sharded", False))
