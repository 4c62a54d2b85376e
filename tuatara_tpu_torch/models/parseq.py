"""PARSEQ scene-text recognizer as a PyTorch module.

Port of `tuatara_tpu/models/parseq.py`. The default (XLA) lowering:

* `encode`: ViT-S encoder. Crops [N, 32, 128, 3] in [0, 1] are cut into
  4x8 patches (a reshape + one linear layer, the patch-embed conv written
  as a product), `pos_embed` is added, 12 pre-norm blocks and a final
  LayerNorm follow -> memory [N, 128, 384].

Every residual add of the eager layers (each block's two, the decoder's
three, the greedy and beam steps' three) and `patch_embed + pos_embed`
goes through the Linear before it (`Linear(x, residual=r)`): at bf16
XLA's CPU backend adds that Linear's bias in fp32 and never rounds the
sum to bf16 (`tests/probe_torch_bf16.py hlo` lists these sites from the
compiled graph), so the port adds `r + (fp32(y) + fp32(b))` in one pass,
beside K6 and K7 too, as the forced-Pallas JAX engine's graph does.
Every other bias add, the head's included, is rounded, except in the
training loss, whose log-softmax reads the head's logits in fp32
(`decode(..., fp32_logits=True)`).
* `greedy_decode`: autoregressive argmax decode with a KV cache. The
  decoder has depth 1, so the content stream's self-attention K/V are
  per-token functions of (token id, position) and are cached; each step
  runs one single-query attention over the cache, cross-attention over the
  memory, the MLP, the final norm and the head. The loop stops once every
  sequence has emitted EOS; positions never reached get EOS-certain logits
  (+30 at id 0, -30 elsewhere), as the JAX early-exit path does.
* `refine`: one cloze pass over the AR output: content [BOS, argmax[:-1]],
  each query blind to its own input position and to positions at or after
  the first EOS.

* `nar_decode`: the non-autoregressive decode, one pass with BOS as the
  whole content and every position query at once (`decode_mode="nar"`),
  followed by the cloze passes as the AR decode is.
* `beam_decode`: beam search with the beams folded into the batch (N * B
  rows), a KV-cached step a position, log-probabilities in fp32, finished
  beams proposing only EOS at no cost, one top-B a sequence over its B * C
  candidates (a stable sort: equal scores go lowest index first, as
  `jax.lax.top_k` orders them, on any device), and the best beam chosen by
  GNMT length normalisation; it returns that beam's raw log-probability.
  All T steps are issued with no host read (`decode_mode="beam"`).

With `encoder_impl="pallas"` / `decode_impl="pallas"`, `prestack` builds
the weight bundles of the fused kernels K6 (`kernels/vit.py`, the 12
blocks) and K7 (`kernels/decode.py`, the whole greedy loop) once, and
`encode` / `greedy_decode` go through them exactly where JAX's gates run
its Pallas kernels: at bf16 compute and a width that is a multiple of
128, K6 also only on a slab of a multiple of 8 crops (`fused_encoder`).
Elsewhere, and at float32, the eager lowering runs, as XLA's does in JAX.
K7 decodes greedily only: under beam and NAR its bundle is not built.
`quantize` makes the encoder int8 (JAX `quantize_parseq_encoder`: the
patch embed and every block's q/k/v/o and fc1/fc2 become `QLinear`s; the
decoder stays float); a quantized encoder never takes K6, as JAX's gate
keeps the int8 encoder on XLA.

Training (`train/`) differentiates `encode` and `decode(memory, tgt_ids,
query=..., query_mask=...)` as they are, with fp32 parameters and the
products cast by `layers.cast_products`; no kernel bundle is built.
`init_parseq` draws JAX `init_parseq_params`'s distributions from a
`torch.Generator`.

Vocabulary: [EOS=0, charset..., BOS, PAD]; the head emits charset_size + 1
classes (EOS + charset).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from tuatara_tpu_torch.config import ParseqConfig
from tuatara_tpu_torch.kernels import decode as K7
from tuatara_tpu_torch.kernels import vit as K6
from tuatara_tpu_torch.models.layers import (
    MHA, LayerNorm, Linear, PaddedLinear, QLinear, VitBlock, attention_core, init_linear,
    linear_gelu, merge_heads, trunc_normal, xavier_uniform,
)

_INV_6 = float(torch.tensor(1.0 / 6.0, dtype=torch.float32))  # XLA's `x / 6.0`


class Bundle(nn.Module):
    """A fused kernel's weight tensors as non-persistent buffers: they move
    with the module (`.to(device)`) and stay out of its state dict."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in tensors.items():
            self.register_buffer(k, v, persistent=False)

    def __getitem__(self, key: str) -> torch.Tensor:
        return getattr(self, key)


class DecoderLayer(nn.Module):
    """Query stream of PARSEQ's dual-stream decoder layer (pre-norm)."""

    def __init__(self, dim: int, heads: int, hidden: int, eps: float):
        super().__init__()
        self.norm_q = LayerNorm(dim, eps)
        self.norm_c = LayerNorm(dim, eps)
        self.self_attn = MHA(dim, heads)
        self.norm1 = LayerNorm(dim, eps)
        self.cross_attn = MHA(dim, heads)
        self.norm2 = LayerNorm(dim, eps)
        self.linear1 = Linear(dim, hidden)
        self.linear2 = Linear(hidden, dim)

    def ff(self, x: torch.Tensor) -> torch.Tensor:
        """x + linear2(gelu(linear1(norm2(x)))), the residual added inside
        linear2 in fp32 (`Linear`)."""
        h = linear_gelu(self.linear1, self.norm2(x))
        return self.linear2(h, residual=x)


class Parseq(nn.Module):
    """PARSEQ. Parameter names follow the JAX parameter tree."""

    def __init__(self, cfg: ParseqConfig = ParseqConfig()):
        super().__init__()
        if cfg.dec_depth != 1:
            # The greedy and beam decodes cache the content stream's K/V.
            raise NotImplementedError("the KV-cached decode assumes dec_depth == 1")
        self.cfg = cfg
        D = cfg.embed_dim
        eps = cfg.layer_norm_eps
        ph, pw = cfg.patch_size
        T = cfg.max_label_length + 1
        self.patch_embed = Linear(ph * pw * 3, D)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, D))
        self.enc = nn.ModuleList([
            VitBlock(D, cfg.enc_heads, cfg.enc_mlp_ratio, eps)
            for _ in range(cfg.enc_depth)
        ])
        self.enc_norm = LayerNorm(D, eps)
        self.text_embed = nn.Parameter(torch.zeros(cfg.num_tokens, D))
        self.pos_queries = nn.Parameter(torch.zeros(1, T, D))
        self.dec = nn.ModuleList([
            DecoderLayer(D, cfg.dec_heads, int(D * cfg.dec_mlp_ratio), eps)
        ])
        self.dec_norm = LayerNorm(D, eps)
        self.head = PaddedLinear(D, cfg.charset_size + 1)
        self.enc_stacked: Optional[Bundle] = None
        self.dec_stacked: Optional[Bundle] = None

    def prestack(self, compute_dtype: torch.dtype,
                 device: Optional[torch.device] = None,
                 decode_mode: str = "greedy") -> None:
        """Build the fused kernels' weight bundles from the fp32 parameters
        (before `set_compute_dtype`), as the JAX engine pre-stacks at
        construction, where JAX's gates run its Pallas kernels: K6's when
        encoder_impl == "pallas" and the encoder is not quantized, K7's when
        decode_impl == "pallas" and the decode is greedy, both only at bf16
        compute and at a width that is a multiple of 128. For a CUDA
        `device`, a geometry that K6's kernel does not take (e.g. S outside
        {64, 128}) raises here, not at the first page; on the CPU the plain
        version takes any. Once K6's bundle is built, `encode` reads the
        per-block modules only for a slab that K6 does not take, so they
        are released and rebuilt from the bundle if such a slab comes
        (`eager_blocks`).

        The eager residual sites around the fused kernels (`patch_embed +
        pos_embed`, the refine's) keep XLA's unrounded bias add, as the
        graph of the forced-Pallas JAX engine shows (`probe_torch_bf16.py
        hlo`)."""
        cfg = self.cfg
        # JAX's gates (parseq_encode, parseq_greedy_decode): bf16 compute
        # and a width that tiles to 128 lanes; the encoder's also a float
        # encoder, and a slab of a multiple of 8 crops (`fused_encoder`).
        if compute_dtype != torch.bfloat16 or cfg.embed_dim % 128:
            return
        if cfg.encoder_impl == "pallas" and not self.quantized:
            if device is not None and torch.device(device).type == "cuda":
                K6.check_geometry(cfg.seq_len, cfg.embed_dim, cfg.enc_heads,
                                  int(cfg.embed_dim * cfg.enc_mlp_ratio))
            self.enc_stacked = Bundle(K6.stack_vit_block_weights(self.enc))
            self.enc = nn.ModuleList()
        if cfg.decode_impl == "pallas" and decode_mode == "greedy":
            self.dec_stacked = Bundle(K7.stack_decode_weights(self))

    @property
    def quantized(self) -> bool:
        return isinstance(self.patch_embed, QLinear)

    def qlinears(self):
        """[(name, QLinear)] of a quantized encoder, in module order; the
        names are the '/'-joined paths of the JAX tree (`enc/0/attn/q`)."""
        return [(n.replace(".", "/"), m) for n, m in self.named_modules()
                if isinstance(m, QLinear)]

    @torch.no_grad()
    def quantize(self) -> "Parseq":
        """JAX `quantize_parseq_encoder` on the fp32 weights (call it before
        `prestack` and `set_compute_dtype`): the patch embed and each
        encoder block's attention q/k/v/o and MLP fc1/fc2 become int8
        `QLinear`s; LayerNorms and the decoder stay float. Idempotent."""
        if self.quantized:
            return self
        self.patch_embed = QLinear.from_linear(self.patch_embed)
        for blk in self.enc:
            for name in ("q", "k", "v", "o"):
                setattr(blk.attn, name, QLinear.from_linear(getattr(blk.attn, name)))
            for name in ("fc1", "fc2"):
                setattr(blk.mlp, name, QLinear.from_linear(getattr(blk.mlp, name)))
        return self

    # ---- encoder ----

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """Crops [N, H, W, 3] float in [0, 1] -> memory [N, S, D] fp32."""
        cfg = self.cfg
        if cfg.input_mean:
            mean = torch.tensor(cfg.input_mean, dtype=torch.float32, device=images.device)
            std = torch.tensor(cfg.input_std or (1.0,) * len(cfg.input_mean),
                               dtype=torch.float32, device=images.device)
            images = (images.float() - mean) / std
        n, h, w, c = images.shape
        ph, pw = cfg.patch_size
        gh, gw = h // ph, w // pw
        x = images.reshape(n, gh, ph, gw, pw, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, gh * gw, ph * pw * c)
        x = self.patch_embed(x, residual=self.pos_embed)
        if self.fused_encoder(n):
            x = K6.vit_blocks(x.float().contiguous(), self.enc_stacked, cfg.enc_heads,
                              cfg.layer_norm_eps)
        else:
            for blk in self.eager_blocks():
                x = blk(x)
        return self.enc_norm(x)

    def fused_encoder(self, n: int) -> bool:
        """Whether `encode` runs K6 on a slab of n crops: where JAX's
        `parseq_encode` runs `vit_blocks_pallas` (K6's bundle built by
        `prestack`, and n % 8 == 0)."""
        return self.enc_stacked is not None and n % 8 == 0

    def eager_blocks(self) -> nn.ModuleList:
        """The encoder's blocks as modules. Once `prestack` has built K6's
        bundle, it holds their only copy; a slab that K6 does not take
        (n % 8 != 0, which the engine's slabs never are) then gets the
        blocks rebuilt from it, once: the bundle holds the bf16 weights
        and the fp32 biases and LayerNorms from which the compute dtype's
        modules are cast, so they equal the released ones. That costs the
        encoder's weights a second time from then on (ViT-S: 21.3 M bf16
        values, 42.5 MB)."""
        if len(self.enc) or self.enc_stacked is None:
            return self.enc
        cfg, st = self.cfg, self.enc_stacked
        D = cfg.embed_dim
        blocks = []
        with torch.no_grad():
            for i in range(st["qkv_w"].shape[0]):
                blk = VitBlock(D, cfg.enc_heads, cfg.enc_mlp_ratio, cfg.layer_norm_eps)
                lins = [(blk.attn.q, st["qkv_w"][i][:, :D], st["qkv_b"][i][:D]),
                        (blk.attn.k, st["qkv_w"][i][:, D:2 * D], st["qkv_b"][i][D:2 * D]),
                        (blk.attn.v, st["qkv_w"][i][:, 2 * D:], st["qkv_b"][i][2 * D:]),
                        (blk.attn.o, st["o_w"][i], st["o_b"][i]),
                        (blk.mlp.fc1, st["f1_w"][i], st["f1_b"][i]),
                        (blk.mlp.fc2, st["f2_w"][i], st["f2_b"][i])]
                for lin, w, b in lins:
                    lin.weight.data = w.t().contiguous()
                    lin.bias.data = b.to(torch.bfloat16)
                for ln, g, b in ((blk.norm1, st["ln1_g"][i], st["ln1_b"][i]),
                                 (blk.norm2, st["ln2_g"][i], st["ln2_b"][i])):
                    ln.weight.data, ln.bias.data = g.clone(), b.clone()
                blocks.append(blk.eval().requires_grad_(False).to(st["qkv_w"].device))
        self.enc = nn.ModuleList(blocks)
        return self.enc

    # ---- decoder ----

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return math.sqrt(self.cfg.embed_dim) * self.text_embed[ids]

    def decode(self, memory: torch.Tensor, tgt_ids: torch.Tensor,
               query: Optional[torch.Tensor] = None,
               query_mask: Optional[torch.Tensor] = None,
               fp32_logits: bool = False) -> torch.Tensor:
        """Full-sequence decode: content ids [N, L] (BOS first) -> logits
        [N, Lq, C]. query_mask broadcastable to [N, heads, Lq, L].
        `fp32_logits`: the head's bias added in fp32 and never rounded (the
        training loss's form, `PaddedLinear`)."""
        layer = self.dec[0]
        N, L_ = tgt_ids.shape
        pos = self.pos_queries[0, :L_]
        pos = torch.cat([torch.zeros_like(pos[:1]), pos[: L_ - 1]], dim=0)
        content = self._embed(tgt_ids) + pos[None]
        if query is None:
            query = self.pos_queries[:, :L_].expand(N, L_, -1)
        cn = layer.norm_c(content)
        qn = layer.norm_q(query)
        q = layer.self_attn(qn, cn, query_mask, residual=query)
        q = layer.cross_attn(layer.norm1(q), memory, residual=q)
        q = layer.ff(q)
        return self.head(self.dec_norm(q), fp32_logits=fp32_logits)

    def greedy_decode(self, memory: torch.Tensor, early_exit: bool = True) -> torch.Tensor:
        """KV-cached greedy AR decode with batch early exit -> logits
        [N, T, C] fp32 (T = max_label_length + 1). `early_exit=False` runs
        all T steps (the steps after every crop's EOS then hold real
        logits, not the EOS-certain fill), as a traced module does."""
        cfg = self.cfg
        layer = self.dec[0]
        N, S, D = memory.shape
        H = cfg.dec_heads
        hd = D // H
        T = cfg.max_label_length + 1
        C = cfg.charset_size + 1
        bos_id = cfg.num_tokens - 2
        dev = memory.device

        if self.dec_stacked is not None:
            # JAX's gate: K7's bundle is built where `parseq_greedy_decode`
            # runs `greedy_decode_pallas` (`prestack`). The memory K/V
            # projections stay outside the kernel, as JAX computes them
            # outside pallas_call.
            ca = layer.cross_attn
            mem_k = ca.k(memory).to(torch.bfloat16).contiguous()
            mem_v = ca.v(memory).to(torch.bfloat16).contiguous()
            return K7.greedy_decode(mem_k, mem_v, self.dec_stacked, H, T, C, bos_id,
                                    cfg.layer_norm_eps)

        mem_k, mem_v = layer.cross_attn.kv(memory)
        pos_q = self.pos_queries[0]  # [T, D]
        # Query side of the self-attention is token-independent: all steps
        # up front.
        q_all = layer.self_attn.q(layer.norm_q(pos_q[:, None]))  # [T, 1, D]
        q_all = q_all.reshape(T, H, 1, hd)
        pos_table = torch.cat([torch.zeros_like(pos_q[:1]), pos_q[: T - 1]], dim=0)

        kv_dtype = q_all.dtype
        k_cache = torch.zeros(N, H, T, hd, dtype=kv_dtype, device=dev)
        v_cache = torch.zeros(N, H, T, hd, dtype=kv_dtype, device=dev)
        logits = torch.full((N, T, C), -30.0, dtype=torch.float32, device=dev)
        logits[:, :, 0] = 30.0
        tok = torch.full((N,), bos_id, dtype=torch.long, device=dev)
        seen_eos = torch.zeros(N, dtype=torch.bool, device=dev)
        steps = torch.arange(T, device=dev)
        for i in range(T):
            e = self._embed(tok) + pos_table[i]
            cn = layer.norm_c(e[:, None])  # [N, 1, D]
            k_cache[:, :, i] = layer.self_attn.k(cn).reshape(N, H, hd).to(kv_dtype)
            v_cache[:, :, i] = layer.self_attn.v(cn).reshape(N, H, hd).to(kv_dtype)
            qh = q_all[i][None].expand(N, H, 1, hd)
            mask = (steps <= i)[None, None, None, :]
            attn = attention_core(qh, k_cache, v_cache, mask)
            x = layer.self_attn.o(merge_heads(attn), residual=pos_q[i][None, None])
            x = layer.cross_attn.attend(layer.norm1(x), mem_k, mem_v, residual=x)
            x = layer.ff(x)
            logits_i = self.head(self.dec_norm(x))[:, 0].float()  # [N, C]
            logits[:, i] = logits_i
            tok = torch.argmax(logits_i, dim=-1)
            seen_eos |= tok == 0
            if early_exit and bool(seen_eos.all()):
                break
        return logits

    def refine(self, memory: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        """One cloze-refinement pass over AR logits."""
        N, T, _ = logits.shape
        bos_id = self.cfg.num_tokens - 2
        prev = torch.argmax(logits, dim=-1)
        tgt_in = torch.cat(
            [torch.full((N, 1), bos_id, dtype=prev.dtype, device=prev.device),
             prev[:, :-1]], dim=1)
        pad = torch.cumsum((tgt_in == 0).to(torch.int32), dim=1) > 0  # [N, T]
        mask = refine_mask(T, logits.device)[None, None] & ~pad[:, None, None, :]
        query = self.pos_queries[:, :T].expand(N, T, -1)
        return self.decode(memory, tgt_in, query=query, query_mask=mask).float()

    def nar_decode(self, memory: torch.Tensor) -> torch.Tensor:
        """Non-autoregressive decode (JAX `parseq_nar_decode`): BOS alone as
        the content, all T position queries in one pass -> logits [N, T, C]
        in the compute dtype."""
        N = memory.shape[0]
        T = self.cfg.max_label_length + 1
        bos = torch.full((N, 1), self.cfg.num_tokens - 2, dtype=torch.long,
                         device=memory.device)
        query = self.pos_queries[:, :T].expand(N, T, -1)
        return self.decode(memory, bos, query=query)

    def beam_decode(self, memory: torch.Tensor, beam_size: int = 4,
                    length_norm: float = 0.6) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam search (JAX `parseq_beam_decode`) -> (ids [N, T], the best
        beam's raw sum of token log-probabilities [N] fp32). The best beam
        is chosen by its score over ((5 + len) / 6) ** length_norm, len up
        to and including the first EOS (T when there is none). All T steps
        run, and no step reads the host."""
        cfg = self.cfg
        layer = self.dec[0]
        N, S, D = memory.shape
        H = cfg.dec_heads
        hd = D // H
        T = cfg.max_label_length + 1
        C = cfg.charset_size + 1
        B = beam_size
        NB = N * B
        dev = memory.device
        # Each crop's memory B times (an expand: repeat_interleave reads its size back).
        mem_k, mem_v = layer.cross_attn.kv(memory[:, None].expand(N, B, S, D).reshape(NB, S, D))
        pos_q = self.pos_queries[0]  # [T, D]
        pos_table = torch.cat([torch.zeros_like(pos_q[:1]), pos_q[: T - 1]], dim=0)
        kv_dtype = layer.self_attn.k.weight.dtype
        tokens = torch.full((NB, T + 1), cfg.num_tokens - 2, dtype=torch.long, device=dev)
        k_cache = torch.zeros(NB, H, T, hd, dtype=kv_dtype, device=dev)
        v_cache = torch.zeros(NB, H, T, hd, dtype=kv_dtype, device=dev)
        scores = torch.zeros(NB, dtype=torch.float32, device=dev)
        done = torch.zeros(NB, dtype=torch.bool, device=dev)
        # A finished beam proposes only EOS, at no cost (a masked fill: an
        # element assignment would copy the scalar from the host).
        frozen = torch.zeros(C, device=dev).masked_fill(torch.arange(C, device=dev) > 0,
                                                        float("-inf"))
        later = (torch.arange(NB, device=dev) % B != 0)[:, None]
        base = (torch.arange(N, device=dev) * B)[:, None]
        steps = torch.arange(T, device=dev)
        for i in range(T):
            e = self._embed(tokens[:, i]) + pos_table[i]
            cn = layer.norm_c(e[:, None])  # [NB, 1, D]
            k_cache[:, :, i] = layer.self_attn.k(cn).reshape(NB, H, hd).to(kv_dtype)
            v_cache[:, :, i] = layer.self_attn.v(cn).reshape(NB, H, hd).to(kv_dtype)
            q = pos_q[i].expand(NB, 1, D)
            mask = (steps <= i)[None, None, None, :]
            x = layer.self_attn.attend(layer.norm_q(q), k_cache, v_cache, mask, residual=q)
            x = layer.cross_attn.attend(layer.norm1(x), mem_k, mem_v, residual=x)
            x = layer.ff(x)
            logits = self.head(self.dec_norm(x))[:, 0]
            logp = torch.log_softmax(logits.float(), dim=-1)
            logp = torch.where(done[:, None], frozen, logp)
            if i == 0:  # every beam of a sequence starts equal: beam 0 proposes
                logp = logp.masked_fill(later, float("-inf"))
            cand = (scores[:, None] + logp).reshape(N, B * C)
            # Top B by a stable descending sort: equal scores keep index
            # order, as jax.lax.top_k returns them. A -inf candidate never
            # ranks above a finite one, and each sequence has at least B
            # finite ones (B * C at step 0 from beam 0; one or more a beam
            # after, a finished beam's EOS included).
            top_s, top_i = torch.sort(cand, dim=-1, descending=True, stable=True)
            top_s, top_i = top_s[:, :B], top_i[:, :B]
            parent = (base + torch.div(top_i, C, rounding_mode="floor")).reshape(-1)
            tok = (top_i % C).reshape(-1)
            tokens = tokens[parent]
            k_cache = k_cache[parent]
            v_cache = v_cache[parent]
            done = done[parent] | (tok == 0)
            tokens[:, i + 1] = tok
            scores = top_s.reshape(-1)
        ids = tokens[:, 1:].reshape(N, B, T)
        eos = ids == 0
        lengths = torch.where(eos.any(-1), torch.argmax(eos.to(torch.int32), -1) + 1,
                              torch.full_like(ids[..., 0], T)).float()
        norm = torch.pow((5.0 + lengths) * _INV_6, length_norm)
        scores = scores.reshape(N, B)
        best = torch.argmax(scores / norm, dim=1)
        rows = torch.arange(N, device=dev)
        return ids[rows, best], scores[rows, best]

    def forward(self, images: torch.Tensor, ar: bool = True,
                early_exit: bool = True) -> torch.Tensor:
        """Crops [N, 32, 128, 3] in [0, 1] -> logits [N, T, C] fp32: greedy
        AR decode (`ar=False`: the NAR decode; `early_exit=False`: every
        step of the greedy decode, JAX's `parseq_forward(...,
        early_exit=False)`), then `refine_iters` cloze passes."""
        memory = self.encode(images)
        logits = self.greedy_decode(memory, early_exit) if ar else self.nar_decode(memory)
        for _ in range(self.cfg.refine_iters):
            logits = self.refine(memory, logits)
        return logits.float()

    def recognize(self, images: torch.Tensor, mode: str = "greedy",
                  beam_size: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
        """JAX `OcrEngine._recognize_body`: crops -> (ids [N, T], conf [N]).
        Greedy and NAR: the product of the per-position max probability up
        to and including the first EOS (`confidence`). Beam: exp of the
        best beam's raw log-probability (a sequence probability too), with
        no cloze pass."""
        if mode == "beam":
            ids, logp = self.beam_decode(self.encode(images), beam_size)
            return ids, torch.exp(logp)
        logits = self(images, ar=mode != "nar")
        if self.cfg.refine_iters or mode == "nar":
            # JAX's logits in the compute dtype (the head's); fp32 after the
            # greedy decode alone, whose early-exit buffer is fp32.
            logits = logits.to(self.head.weight.dtype)
        return confidence(logits)


@torch.no_grad()
def init_parseq(cfg: ParseqConfig = ParseqConfig(),
                generator: Optional[torch.Generator] = None) -> Parseq:
    """A random `Parseq` on the CPU (JAX `init_parseq_params`): truncated
    normal (std 0.02) patch embed, position embeddings, token embeddings,
    position queries, MLPs and head; xavier-uniform attention projections;
    zero biases; unit LayerNorms. Drawn from `generator` in JAX's order."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    model = Parseq(cfg)

    def mha(m: MHA) -> None:
        for lin in (m.q, m.k, m.v, m.o):
            init_linear(lin, gen, xavier_uniform)

    init_linear(model.patch_embed, gen)
    model.pos_embed.copy_(trunc_normal(gen, tuple(model.pos_embed.shape)))
    for blk in model.enc:
        mha(blk.attn)
        init_linear(blk.mlp.fc1, gen)
        init_linear(blk.mlp.fc2, gen)
    model.text_embed.copy_(trunc_normal(gen, tuple(model.text_embed.shape)))
    model.pos_queries.copy_(trunc_normal(gen, tuple(model.pos_queries.shape)))
    for layer in model.dec:
        mha(layer.self_attn)
        mha(layer.cross_attn)
        init_linear(layer.linear1, gen)
        init_linear(layer.linear2, gen)
    init_linear(model.head, gen)
    return model


def refine_mask(T: int, device=None) -> torch.Tensor:
    """Query i may attend every content position except j == i + 1."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    return j != i + 1


def confidence(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [N, T, C] -> (ids [N, T], conf [N] fp32): conf is the product
    of the per-position max softmax probability up to and including the
    first EOS. fp32 logits: all in fp32. 16-bit logits: JAX's softmax, max
    and product at that dtype as XLA's CPU backend compiles them, each of
    its roundings kept: x - max rounded, its exp summed in fp32, the sum
    and the exp rounded before the quotient, the quotient rounded, the
    product taken in fp32 and rounded (returned widened to fp32)."""
    ids = torch.argmax(logits, dim=-1)
    dt = logits.dtype
    x = logits.float()
    if dt == torch.float32:
        pmax = torch.softmax(x, dim=-1).amax(dim=-1)
    else:
        e = torch.exp((x - x.amax(dim=-1, keepdim=True)).to(dt).float())
        total = e.sum(dim=-1, keepdim=True).to(dt).float()
        pmax = (e.to(dt).float() / total).to(dt).float().amax(dim=-1)
    eos = (ids == 0).to(torch.int32)
    before = (torch.cumsum(eos, dim=-1) - eos) == 0
    conf = torch.where(before, pmax, torch.ones_like(pmax)).prod(dim=-1)
    return ids, conf.to(dt).float()
