"""Fused ViT encoder blocks, kernel K6.

`vit_blocks` launches `csrc/vit.cu` for CUDA tensors and runs
`vit_blocks_plain` for CPU tensors. It replaces the Pallas kernel
`vit_blocks_pallas` (tuatara_tpu/ops/pallas/vit.py:181) and computes what
its body computes: pre-norm blocks of LayerNorm -> fused QKV projection ->
per-head attention -> output projection -> LayerNorm -> fc1 ->
tanh-approximate GELU -> fc2, on an fp32 residual stream, with bf16
matmul operands and fp32 accumulation, fp32 LayerNorm and softmax, and
q/k/v and the attention probabilities rounded to bf16 before their
products. The GELU is the tanh form because the TPU kernel uses it (Mosaic
lowers no erf); the port's plain block chain (`models/layers.py`) keeps the
exact erf form, as the JAX XLA path does.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry
from tuatara_tpu_torch.kernels.cc import _raise_on

K6 = "vit_blocks"
# What each of a block's CUDA launches computes, in launch order.
LAUNCH_ROLES = ("ln1+qkv", "attention", "out_proj", "ln2+fc1", "fc2")
WEIGHTS = ("qkv_w", "qkv_b", "o_w", "o_b", "f1_w", "f1_b", "f2_w", "f2_b",
           "ln1_g", "ln1_b", "ln2_g", "ln2_b")


def stack_vit_block_weights(blocks: Sequence[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """Per-block weights of `models.layers.VitBlock`s (fp32, as loaded) ->
    leading-block-dim tensors in the JAX layout ([in, out]): q/k/v fused
    into one [D, 3D] projection, matmul weights cast to bf16, biases and
    LayerNorm parameters kept fp32 (`stack_vit_block_weights`,
    tuatara_tpu/ops/pallas/vit.py:42)."""
    def t(lin):
        return lin.weight.detach().float().t()

    cols = {k: [] for k in WEIGHTS}
    for blk in blocks:
        a = blk.attn
        cols["qkv_w"].append(torch.cat([t(a.q), t(a.k), t(a.v)], dim=1))
        cols["qkv_b"].append(torch.cat([a.q.bias, a.k.bias, a.v.bias]))
        cols["o_w"].append(t(a.o))
        cols["o_b"].append(a.o.bias)
        cols["f1_w"].append(t(blk.mlp.fc1))
        cols["f1_b"].append(blk.mlp.fc1.bias)
        cols["f2_w"].append(t(blk.mlp.fc2))
        cols["f2_b"].append(blk.mlp.fc2.bias)
        cols["ln1_g"].append(blk.norm1.weight)
        cols["ln1_b"].append(blk.norm1.bias)
        cols["ln2_g"].append(blk.norm2.weight)
        cols["ln2_b"].append(blk.norm2.bias)
    out = {}
    for k, v in cols.items():
        dtype = torch.bfloat16 if k.endswith("_w") else torch.float32
        out[k] = torch.stack([x.detach().float() for x in v]).to(dtype).contiguous()
    return out


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 LayerNorm written as the JAX kernels write it (mean, biased
    variance, rsqrt)."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def mm(a_bf: torch.Tensor, w_bf: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, fp32 products and sums, fp32 bias: a @ w + b."""
    return a_bf.float() @ w_bf.float() + b


def vit_blocks_plain(x: torch.Tensor, st: Dict[str, torch.Tensor], heads: int,
                     eps: float = 1e-6) -> torch.Tensor:
    """x [N, S, D] fp32 through every stacked block -> [N, S, D] fp32."""
    n, s, d = x.shape
    hd = d // heads
    scale = 1.0 / math.sqrt(hd)
    x = x.float().reshape(n * s, d)
    for i in range(st["qkv_w"].shape[0]):
        h = layernorm(x, st["ln1_g"][i], st["ln1_b"][i], eps).to(torch.bfloat16)
        qkv = mm(h, st["qkv_w"][i], st["qkv_b"][i]).to(torch.bfloat16)
        q, k, v = qkv.float().reshape(n, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
        p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
        att = p.to(torch.bfloat16).float() @ v  # [N, heads, S, hd]
        att = att.transpose(1, 2).reshape(n * s, d).to(torch.bfloat16)
        x = x + mm(att, st["o_w"][i], st["o_b"][i])
        h = layernorm(x, st["ln2_g"][i], st["ln2_b"][i], eps).to(torch.bfloat16)
        hmid = F.gelu(mm(h, st["f1_w"][i], st["f1_b"][i]), approximate="tanh")
        x = x + mm(hmid.to(torch.bfloat16), st["f2_w"][i], st["f2_b"][i])
    return x.reshape(n, s, d)


SEQ_LENS = (64, 128)


def check_geometry(s: int, d: int, heads: int, hidden: int) -> None:
    """Raise unless the CUDA kernel takes this encoder: S in {64, 128}
    tokens per crop (32x64 and 32x128 crops), a head width of 64 and D,
    hidden multiples of 128 (ViT-S: 6 heads x 64, 384 / 1536)."""
    if s not in SEQ_LENS or d % heads or d // heads != 64 or d % 128 or hidden % 128:
        raise ValueError(f"vit_blocks takes S in {SEQ_LENS}, head width 64 and D, hidden "
                         f"multiples of 128; got S={s} D={d} heads={heads} hidden={hidden}")


def vit_blocks(x: torch.Tensor, st: Dict[str, torch.Tensor], heads: int,
               eps: float = 1e-6) -> torch.Tensor:
    """x [N, S, D] fp32 -> [N, S, D] fp32 after every stacked block. The
    CUDA kernel takes the geometries `check_geometry` accepts, with N * S a
    multiple of 128 (its GEMM tile): an even N at S = 64."""
    if not x.is_cuda:
        return vit_blocks_plain(x, st, heads, eps)
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"x: expected [N, S, D] float32, got {tuple(x.shape)} {x.dtype}")
    n, s, d = x.shape
    nb, _, hidden = st["f1_w"].shape
    check_geometry(s, d, heads, hidden)
    if (n * s) % 128:
        raise ValueError(f"vit_blocks needs N * S to be a multiple of 128; got N={n} S={s}")
    shapes = {"qkv_w": (nb, d, 3 * d), "qkv_b": (nb, 3 * d), "o_w": (nb, d, d),
              "o_b": (nb, d), "f1_w": (nb, d, hidden), "f1_b": (nb, hidden),
              "f2_w": (nb, hidden, d), "f2_b": (nb, d), "ln1_g": (nb, d),
              "ln1_b": (nb, d), "ln2_g": (nb, d), "ln2_b": (nb, d)}
    for k, shape in shapes.items():
        w = st[k]
        want = torch.bfloat16 if k.endswith("_w") else torch.float32
        if tuple(w.shape) != shape or w.dtype != want or not w.is_contiguous() \
                or w.device != x.device:
            raise ValueError(f"{k}: expected contiguous {shape} {want} on {x.device}, "
                             f"got {tuple(w.shape)} {w.dtype} on {w.device}")
    if any(st[k].data_ptr() % 16 for k in WEIGHTS):  # TMA; 16- and 8-byte vector loads
        raise ValueError("vit_blocks: weights, biases and LayerNorm parameters must be "
                         "16-byte aligned")
    m = n * s
    out = x.contiguous().clone()
    dev = x.device
    qkv = torch.empty((m, 3 * d), dtype=torch.bfloat16, device=dev)
    att = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    hmid = torch.empty((m, hidden), dtype=torch.bfloat16, device=dev)
    fn = entry("vit", "tt_vit_blocks", 16, 6, 1)
    err = fn(out.data_ptr(), qkv.data_ptr(), att.data_ptr(), hmid.data_ptr(),
             *(st[k].data_ptr() for k in WEIGHTS), nb, n, s, d, heads, hidden, float(eps),
             torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "tt_vit_blocks")
    LAUNCHES[K6] += 1
    return out
