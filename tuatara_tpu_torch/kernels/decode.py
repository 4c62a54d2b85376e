"""Fused KV-cached greedy decode, kernel K7.

`greedy_decode` launches `csrc/decode.cu` for CUDA tensors and runs
`greedy_decode_plain` for CPU tensors. It replaces the Pallas kernel
`greedy_decode_pallas` (tuatara_tpu/ops/pallas/decode.py:271) and computes
the math of its body: per step i, the position query i attends over the
content K/V of positions <= i (rows of a [T, V, D] table indexed by
(position, token)), then cross-attends the memory K/V, then the tanh-GELU
MLP, the final LayerNorm and the head; the argmax (first index on ties)
is the next token. Crops run in tiles of `tb`; a tile stops once every
crop in it has emitted EOS (id 0), and positions it never reached keep
EOS-certain logits (+30 at id 0, -30 elsewhere).

Numerics, the TPU kernel's: bf16 operands, fp32 LayerNorm and softmax,
attention probabilities rounded to bf16 before they weight V, and every
attention product (q*k and p*v, in the self- and the cross-attention)
rounded to bf16 before it is summed in fp32 (the Pallas body's bf16
`q * k` and `p_full * v`). The matmuls' products stay exact, summed in
fp32. The TPU kernel's one-hot gather matmul and segment-matmul attention
are Mosaic workarounds and are not carried over: rows are gathered and
each head's rounded products summed directly, so only the fp32 sums'
order differs from the TPU kernel's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry
from tuatara_tpu_torch.kernels.cc import _raise_on
from tuatara_tpu_torch.kernels.vit import layernorm, mm

K7 = "greedy_decode"
# Crops per tile and CTAs per tile. A tile is one thread-block cluster of
# CLUSTER CTAs that split every step's heads and product columns among
# them, so a step streams 1 / CLUSTER of the weights through each SM; fewer
# crops a tile mean fewer attention rounds a warp. `chip_smoke.py` phase 4b
# times 4, 8 and 16 crops x 4 and 6 CTAs on the latency path's slabs: 4 x 6
# is fastest on an H100 (numbers in PERF.md).
TB = 4
CLUSTER = 6
# The products' weights that the kernel streams, which the bundle holds
# tile-major ([N / 16, K, 16], see `tile_major`).
TILED = ("o_w", "cq_w", "co_w", "f1_w", "f2_w")
WEIGHTS = ("pos_q", "qh_all", "k_tab", "v_tab", "o_w", "o_b", "cq_w", "cq_b",
           "co_w", "co_b", "f1_w", "f1_b", "f2_w", "f2_b", "h_w", "h_b",
           "norm1_g", "norm1_b", "norm2_g", "norm2_b", "dec_norm_g", "dec_norm_b")


def _bf16_linear(lin: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's bf16 `linear`: bf16(bf16(x) @ bf16(w)) + bf16(b),
    the product summed in fp32 and the bias added in bf16."""
    w = lin.weight.detach().float().t().to(torch.bfloat16).float()
    y = (x.to(torch.bfloat16).float() @ w).to(torch.bfloat16)
    return (y.float() + lin.bias.detach().to(torch.bfloat16).float()).to(torch.bfloat16)


def stack_decode_weights(parseq: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The kernel's weight bundle from a `models.parseq.Parseq` with fp32
    parameters (`stack_decode_weights`, tuatara_tpu/ops/pallas/decode.py:60):
    the position queries, the token-independent self-attention queries
    (rounded to bf16), the content K/V table over every (position, token)
    pair [T, V, D] in bf16, the remaining matmul weights in bf16 ([in, out];
    the five that the kernel streams, `TILED`, packed by `tile_major`) with
    fp32 biases, and the three LayerNorms in fp32. The TPU kernel's
    head-segment matrices are not needed here."""
    cfg = parseq.cfg
    layer = parseq.dec[0]
    eps = cfg.layer_norm_eps
    D = cfg.embed_dim
    T = cfg.max_label_length + 1
    with torch.no_grad():
        pos_q = parseq.pos_queries.detach()[0, :T].float()
        qn_all = layernorm(pos_q, layer.norm_q.weight, layer.norm_q.bias, eps)
        qh_all = _bf16_linear(layer.self_attn.q, qn_all)
        pos_table = torch.cat([torch.zeros_like(pos_q[:1]), pos_q[:T - 1]], dim=0)
        e_all = (math.sqrt(D) * parseq.text_embed.detach().float())[None] + pos_table[:, None]
        cn_all = layernorm(e_all, layer.norm_c.weight, layer.norm_c.bias, eps)
        out = {"pos_q": pos_q.clone(), "qh_all": qh_all.contiguous(),
               "k_tab": _bf16_linear(layer.self_attn.k, cn_all).contiguous(),
               "v_tab": _bf16_linear(layer.self_attn.v, cn_all).contiguous()}
        for name, lin in (("o", layer.self_attn.o), ("cq", layer.cross_attn.q),
                          ("co", layer.cross_attn.o), ("f1", layer.linear1),
                          ("f2", layer.linear2), ("h", parseq.head)):
            w = lin.weight.detach().float().t().to(torch.bfloat16).contiguous()
            out[f"{name}_w"] = tile_major(w) if f"{name}_w" in TILED else w
            out[f"{name}_b"] = lin.bias.detach().float().clone()
        for name, ln in (("norm1", layer.norm1), ("norm2", layer.norm2),
                         ("dec_norm", parseq.dec_norm)):
            out[f"{name}_g"] = ln.weight.detach().float().clone()
            out[f"{name}_b"] = ln.bias.detach().float().clone()
    return out


def _rounded(prod: torch.Tensor) -> torch.Tensor:
    """fp32 products of bf16 values (exact) rounded to bf16, widened back
    for the fp32 sum."""
    return prod.to(torch.bfloat16).float()


def greedy_decode_plain(mem_k: torch.Tensor, mem_v: torch.Tensor,
                        st: Dict[str, torch.Tensor], heads: int, t: int,
                        n_classes: int, bos_id: int, eps: float = 1e-6,
                        tb: int = TB) -> torch.Tensor:
    """mem_k, mem_v [N, S, D] bf16 (the cross-attention K/V projections of
    the memory, heads not split) -> logits [N, T, C] fp32."""
    n, s, d = mem_k.shape
    hd = d // heads
    scale = 1.0 / math.sqrt(hd)
    bf = torch.bfloat16
    w = {k: untile(st[k]) for k in TILED}  # [in, out]
    out = torch.full((n, t, n_classes), -30.0, dtype=torch.float32, device=mem_k.device)
    out[..., 0] = 30.0  # EOS-certain: what positions a tile never reaches keep
    for t0 in range(0, n, tb):
        mk = mem_k[t0:t0 + tb].float().reshape(-1, s, heads, hd)
        mv = mem_v[t0:t0 + tb].float().reshape(-1, s, heads, hd)
        b = mk.shape[0]
        toks = torch.full((b, t + 1), bos_id, dtype=torch.long, device=mem_k.device)
        seen = torch.zeros(b, dtype=torch.bool, device=mem_k.device)
        for i in range(t):
            pos = torch.arange(i + 1, device=mem_k.device)
            kk = st["k_tab"][pos[None], toks[:, :i + 1]].float().reshape(b, i + 1, heads, hd)
            vv = st["v_tab"][pos[None], toks[:, :i + 1]].float().reshape(b, i + 1, heads, hd)
            q = st["qh_all"][i].float().reshape(heads, hd)
            p = torch.softmax(_rounded(kk * q).sum(-1) * scale, dim=1).to(bf).float()  # [b, i+1, H]
            attn = _rounded(p[..., None] * vv).sum(1).reshape(b, d)
            x = st["pos_q"][i] + mm(attn.to(bf), w["o_w"], st["o_b"])
            cn1 = layernorm(x, st["norm1_g"], st["norm1_b"], eps).to(bf)
            qc = mm(cn1, w["cq_w"], st["cq_b"]).to(bf).float().reshape(b, 1, heads, hd)
            p = torch.softmax(_rounded(mk * qc).sum(-1) * scale, dim=1).to(bf).float()  # [b, S, H]
            ctx = _rounded(p[..., None] * mv).sum(1).reshape(b, d)
            x = x + mm(ctx.to(bf), w["co_w"], st["co_b"])
            h2 = layernorm(x, st["norm2_g"], st["norm2_b"], eps).to(bf)
            hmid = F.gelu(mm(h2, w["f1_w"], st["f1_b"]), approximate="tanh").to(bf)
            x = x + mm(hmid, w["f2_w"], st["f2_b"])
            y = layernorm(x, st["dec_norm_g"], st["dec_norm_b"], eps).to(bf)
            logits_i = mm(y, st["h_w"], st["h_b"])
            out[t0:t0 + b, i] = logits_i
            nxt = torch.argmax(logits_i, dim=-1)
            toks[:, i + 1] = nxt
            seen |= nxt == 0
            if bool(seen.all()):
                break
    return out


def tile_major(w: torch.Tensor) -> torch.Tensor:
    """A [K, N] weight as N / 16 column tiles of [K, 16], each contiguous:
    the layout in which the kernel streams it."""
    k, n = w.shape
    return w.reshape(k, n // 16, 16).permute(1, 0, 2).contiguous()


def untile(p: torch.Tensor) -> torch.Tensor:
    """`tile_major`'s inverse: [N / 16, K, 16] -> [K, N]."""
    return p.permute(1, 0, 2).reshape(p.shape[1], -1)


def check_geometry(d: int, heads: int, t: int, s: int, hidden: int, tb: int,
                   cluster: int) -> None:
    """Raise unless the CUDA kernel takes this decoder and tiling: a head
    width of 32, T <= 32, S % 32 == 0, D <= 512, 1 <= tb <= 16 crops per
    tile, and a cluster of 1-8 CTAs that divides the heads, with D and the
    MLP width multiples of 16 x cluster and at most 512 columns of each a
    CTA (PARSEQ: 12 heads, D = 384, MLP 1536; clusters of 4 or 6)."""
    if (d % heads or d // heads != 32 or t > 32 or s % 32 or d > 512
            or not 1 <= tb <= 16):
        raise ValueError(f"greedy_decode takes head width 32, T <= 32, S % 32 == 0, "
                         f"D <= 512 and 1 <= tb <= 16; got D={d} heads={heads} T={t} "
                         f"S={s} tb={tb}")
    if (not 1 <= cluster <= 8 or heads % cluster or d % (16 * cluster)
            or hidden % (16 * cluster) or hidden // cluster > 512):
        raise ValueError(f"greedy_decode: a cluster of {cluster} CTAs must be 1-8, divide "
                         f"the {heads} heads, and split D={d} and the MLP width "
                         f"{hidden} into multiples of 16 of at most 512 columns")


def greedy_decode(mem_k: torch.Tensor, mem_v: torch.Tensor, st: Dict[str, torch.Tensor],
                  heads: int, t: int, n_classes: int, bos_id: int, eps: float = 1e-6,
                  tb: int = TB, cluster: int = CLUSTER) -> torch.Tensor:
    """mem_k, mem_v [N, S, D] bf16 -> logits [N, T, C] fp32 (see module
    doc). The CUDA kernel takes the geometries `check_geometry` accepts;
    `cluster` (CTAs per tile) changes no result, `tb` only which positions
    past a crop's first EOS keep the EOS-certain fill."""
    if not mem_k.is_cuda:
        return greedy_decode_plain(mem_k, mem_v, st, heads, t, n_classes, bos_id, eps, tb)
    for name, a in (("mem_k", mem_k), ("mem_v", mem_v)):
        if a.dim() != 3 or a.dtype != torch.bfloat16 or not a.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous [N, S, D] bfloat16 tensor, "
                             f"got {tuple(a.shape)} {a.dtype}")
    if mem_v.shape != mem_k.shape or mem_v.device != mem_k.device:
        raise ValueError("mem_k and mem_v must share shape and device")
    n, s, d = mem_k.shape
    v = st["k_tab"].shape[1]
    hidden = st["f1_b"].shape[0]
    check_geometry(d, heads, t, s, hidden, tb, cluster)
    shapes = {"pos_q": (t, d), "qh_all": (t, d), "k_tab": (t, v, d), "v_tab": (t, v, d),
              "o_w": (d, d), "o_b": (d,), "cq_w": (d, d), "cq_b": (d,),
              "co_w": (d, d), "co_b": (d,), "f1_w": (d, hidden), "f1_b": (hidden,),
              "f2_w": (hidden, d), "f2_b": (d,), "h_w": (d, n_classes), "h_b": (n_classes,),
              "norm1_g": (d,), "norm1_b": (d,), "norm2_g": (d,), "norm2_b": (d,),
              "dec_norm_g": (d,), "dec_norm_b": (d,)}
    bf16_keys = ("qh_all", "k_tab", "v_tab", "o_w", "cq_w", "co_w", "f1_w", "f2_w", "h_w")
    for k, shape in shapes.items():
        if k in TILED:
            shape = (shape[1] // 16, shape[0], 16)
        w = st[k]
        want = torch.bfloat16 if k in bf16_keys else torch.float32
        if tuple(w.shape) != shape or w.dtype != want or not w.is_contiguous() \
                or w.device != mem_k.device:
            raise ValueError(f"{k}: expected contiguous {shape} {want} on {mem_k.device}, "
                             f"got {tuple(w.shape)} {w.dtype} on {w.device}")
    if any(a.data_ptr() % 32 for a in (mem_k, mem_v, *(st[k] for k in bf16_keys))):
        raise ValueError("greedy_decode: bf16 inputs must be 32-byte aligned")
    out = torch.empty((n, t, n_classes), dtype=torch.float32, device=mem_k.device)
    fn = entry("decode", "tt_greedy_decode", 25, 11, 2)
    err = fn(mem_k.data_ptr(), mem_v.data_ptr(), *(st[k].data_ptr() for k in WEIGHTS),
             out.data_ptr(), n, s, d, heads, t, v, n_classes, hidden, bos_id, tb, cluster,
             float(eps),
             1.0 / math.sqrt(d // heads), torch.cuda.current_stream(mem_k.device).cuda_stream)
    _raise_on(err, "tt_greedy_decode")
    LAUNCHES[K7] += 1
    return out
