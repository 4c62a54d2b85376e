"""PARSeq in plain fp32 PyTorch, from the weights file alone.

Bautista and Atienza, ECCV 2022 (baudm/parseq `configs/model/parseq.yaml`,
PARSeq-S): a ViT encoder over the 32 x 128 crop in 4 x 8 patches (a
linear patch embedding plus learned positions, pre-norm blocks of
multi-head attention and an exact-GELU MLP, a final LayerNorm), and one
pre-norm decoder layer whose queries are learned position queries and
whose content is the token embeddings (scaled by sqrt(D)) plus the
position queries shifted by one, BOS first. Decoding is greedy and
autoregressive (query i sees content 0..i), then one cloze refinement:
every query sees the greedy tokens except the one at its own position and
nothing from the first EOS on.

Vocabulary: EOS = 0, the charset, BOS, PAD; the head emits EOS and the
charset. The weights come from `parseq.npz` (JAX layout: linear weights
[in, out]) read with NumPy. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from reference.quant import round_operands


class ParseqRef:
    def __init__(self, flat: Dict[str, np.ndarray], arch: Dict, device,
                 kind: Optional[str] = None):
        self.p = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                  for k, v in flat.items()}
        self.a = arch
        self.kind = kind  # every linear layer's format (quant.py; None: fp32)
        self.D = arch["embed_dim"]
        self.T = arch["max_label_length"] + 1
        self.bos = arch["charset_size"] + 1

    def lin(self, x: torch.Tensor, path: str) -> torch.Tensor:
        w = self.p[f"{path}/w"]
        if self.kind is not None:
            x, wt = round_operands(x, w.t(), self.kind)
            w = wt.t()
        return x @ w + self.p[f"{path}/b"]

    def ln(self, x: torch.Tensor, path: str) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.p[f"{path}/scale"], self.p[f"{path}/bias"],
                            self.a["layer_norm_eps"])

    def attend(self, q, k, v, heads: int, mask=None) -> torch.Tensor:
        n, lq, d = q.shape
        hd = d // heads

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], heads, hd).transpose(1, 2)

        logits = split(q) @ split(k).transpose(-1, -2) / math.sqrt(hd)
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        out = torch.softmax(logits, -1) @ split(v)
        return out.transpose(1, 2).reshape(n, lq, d)

    def mha(self, xq, xkv, path: str, heads: int, mask=None, kv=None) -> torch.Tensor:
        if kv is None:
            kv = (self.lin(xkv, f"{path}/k"), self.lin(xkv, f"{path}/v"))
        return self.lin(self.attend(self.lin(xq, f"{path}/q"), *kv, heads, mask), f"{path}/o")

    def encode(self, crops: torch.Tensor) -> torch.Tensor:
        """crops [N, 32, 128, 3] fp32 in [0, 1], RGB -> memory [N, S, D]."""
        n, h, w, c = crops.shape
        ph, pw = self.a["patch_size"]
        x = crops.reshape(n, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 2, 4, 5)
        x = self.lin(x.reshape(n, (h // ph) * (w // pw), ph * pw * c), "patch_embed")
        x = x + self.p["pos_embed"]
        for i in range(self.a["enc_depth"]):
            b = f"enc/{i}"
            hn = self.ln(x, f"{b}/norm1")
            x = x + self.mha(hn, hn, f"{b}/attn", self.a["enc_heads"])
            hn = self.ln(x, f"{b}/norm2")
            x = x + self.lin(F.gelu(self.lin(hn, f"{b}/mlp/fc1")), f"{b}/mlp/fc2")
        return self.ln(x, "enc_norm")

    def decode(self, mem_kv, content_ids: torch.Tensor, query: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Logits [N, Lq, C] of position queries [N, Lq, D] over content
        [BOS, tokens...] [N, L]; mask [N or 1, 1, Lq, L], True = attend."""
        L = content_ids.shape[1]
        pq = self.p["pos_queries"][0]
        pos = torch.cat([torch.zeros_like(pq[:1]), pq[:L - 1]], 0)
        content = math.sqrt(self.D) * self.p["text_embed"][content_ids] + pos
        d = "dec/0"
        heads = self.a["dec_heads"]
        cn = self.ln(content, f"{d}/norm_c")
        q = query + self.mha(self.ln(query, f"{d}/norm_q"), cn, f"{d}/self_attn", heads, mask)
        q = q + self.mha(self.ln(q, f"{d}/norm1"), None, f"{d}/cross_attn", heads, kv=mem_kv)
        hn = self.ln(q, f"{d}/norm2")
        q = q + self.lin(F.gelu(self.lin(hn, f"{d}/linear1")), f"{d}/linear2")
        return self.lin(self.ln(q, "dec_norm"), "head")

    def memory(self, crops: torch.Tensor):
        memory = self.encode(crops)
        return memory, (self.lin(memory, "dec/0/cross_attn/k"),
                        self.lin(memory, "dec/0/cross_attn/v"))

    def cloze(self, mem_kv, tokens: torch.Tensor) -> torch.Tensor:
        """The cloze pass's logits [N, T, C] over the tokens [N, T] (T - 1
        of them read): every query sees BOS and the tokens but the one at
        its own position, none from the first EOS on."""
        n, T = tokens.shape[0], self.T
        tgt = torch.cat([torch.full((n, 1), self.bos, dtype=torch.long, device=tokens.device),
                         tokens[:, :T - 1]], 1)
        after_eos = torch.cumsum((tgt == 0).int(), 1) > 0
        i = torch.arange(T, device=tokens.device)
        mask = (i[None, :] != i[:, None] + 1)[None, None] & ~after_eos[:, None, None, :]
        pq = self.p["pos_queries"][:, :T].expand(n, T, self.D)
        return self.decode(mem_kv, tgt, pq, mask)

    def recognize(self, crops: torch.Tensor) -> torch.Tensor:
        """crops -> the refined logits [N, T, C] fp32 (greedy decode, then
        one cloze pass over its tokens)."""
        memory, mem_kv = self.memory(crops)
        n, T = memory.shape[0], self.T
        pq = self.p["pos_queries"][:, :T].expand(n, T, self.D)
        ids = torch.full((n, 1), self.bos, dtype=torch.long, device=memory.device)
        for i in range(T):
            logit = self.decode(mem_kv, ids, pq[:, i:i + 1], None)[:, 0]
            ids = torch.cat([ids, logit.argmax(-1)[:, None]], 1)
        return self.cloze(mem_kv, ids[:, 1:])


def confidence(logits: torch.Tensor) -> torch.Tensor:
    """The product of each position's top probability up to and including
    the first EOS of the argmax."""
    ids = logits.argmax(-1)
    pmax = torch.softmax(logits, -1).amax(-1)
    eos = (ids == 0).int()
    before = (torch.cumsum(eos, -1) - eos) == 0
    return torch.where(before, pmax, torch.ones_like(pmax)).prod(-1)
