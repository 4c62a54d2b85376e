"""Neural-net building blocks of the port (the part of
`tuatara_tpu/models/layers.py` that the default OCR path uses).

Dtype policy, as in the JAX package: parameters are loaded in fp32; the
weights of convolutions and linear layers are cast once to the model's
compute dtype (`set_compute_dtype`), and each such layer casts its input to
that dtype, so products run in the compute dtype with fp32 accumulation.
LayerNorm and softmax always run in fp32. GELU is the exact erf form.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Module):
    """2-D convolution over NCHW with an OIHW weight, "SAME" padding."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dilation = dilation
        self.padding = dilation * (k - 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.weight.dtype), self.weight, self.bias,
                        padding=self.padding, dilation=self.dilation)


class Linear(nn.Module):
    """y = x @ W^T + b, W stored [out, in]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


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


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the weights of every Conv and Linear to `dtype` (LayerNorms and
    free parameters such as embeddings stay fp32)."""
    for m in module.modules():
        if isinstance(m, (Conv, Linear)):
            m.weight.data = m.weight.data.to(dtype)
            m.bias.data = m.bias.data.to(dtype)
    return module


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, heads, d // heads).transpose(1, 2)  # [B, H, L, hd]


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over [B, H, L, hd]. Products in the
    inputs' dtype, the scale and softmax in fp32; mask True = attend."""
    dtype = q.dtype
    logits = torch.matmul(q, k.transpose(-1, -2).to(dtype)).float()
    logits = logits * (1.0 / math.sqrt(q.shape[-1]))
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
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = split_heads(self.q(xq), self.heads)
        return self.o(merge_heads(attention_core(q, k, v, mask)))

    def forward(self, xq: torch.Tensor, xkv: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        k, v = self.kv(xkv)
        return self.attend(xq, k, v, mask)


class VitBlock(nn.Module):
    """Pre-norm ViT block (timm style), fp32 residual stream."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, eps: float):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps)
        self.attn = MHA(dim, heads)
        self.norm2 = LayerNorm(dim, eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.attn(h, h)
        return x + self.mlp(self.norm2(x))
