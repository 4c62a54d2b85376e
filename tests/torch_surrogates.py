"""Upstream-named torch replicas of the reference's two networks, for the
converter's tests and chip_smoke.py's conversion phase (no JAX here).

* `TorchCraft(cfg)`: clovaai-CRAFT's structure (torchvision vgg16_bn
  feature indices in `basenet.slice1-5`, `upconvN.conv`, `conv_cls`) at the
  widths of a `CraftConfig`; forward: [N, 3, H, W] -> NHWC scores.
* `TorchParseq(cfg)`: baudm-PARSEQ's names (a timm ViT with fused qkv, the
  decoder's nn.MultiheadAttention in_proj) at the widths of a
  `ParseqConfig`; forward: crops [N, 3, 32, 128] -> logits [N, T, C] by a
  greedy AR decode of all T steps and `refine_iters` cloze passes, the
  traced artifact's contract. Its Python loops unroll at a fixed shape
  when traced.
* `Normalized(inner, mean, std)`: a module that normalizes its input
  before `inner`, the case of a traced graph that normalizes internally.
* `upstream_state_dict(model, tree)`: the inverse of the converter's name
  maps, a JAX-layout tree (e.g. `evals/production_weights`) -> the
  replica's state dict.

Either package's config classes work: only their fields are read.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VGG_CONV_IDX = [0, 3, 7, 10, 14, 17, 20, 24, 27, 30, 34, 37]
VGG_NAMES = ["conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3",
             "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2"]
HEAD_IDX = [0, 2, 4, 6, 8]
IMAGENET_BGR = ((0.406, 0.456, 0.485), (0.225, 0.224, 0.229))  # ImageNet's, channels swapped
SLICES = [("slice1", range(0, 12)), ("slice2", range(12, 19)), ("slice3", range(19, 29)),
          ("slice4", range(29, 39))]


def slice_of(idx):
    return next(name for name, r in SLICES if idx in r)


class TorchCraft(nn.Module):
    """Upstream-shaped CRAFT at the widths of `cfg`. Upstream pools
    conv5_2's BatchNorm output into the fc stage before any ReLU; the JAX
    package (and so the port) applies a ReLU first (ROADMAP Queue 3, item
    16). `relu_before_fc=True` builds the engine's variant, same names."""

    def __init__(self, cfg, relu_before_fc: bool = False):
        super().__init__()
        self.relu_before_fc = relu_before_fc
        c, fc, up, head = cfg.stage_channels, cfg.fc_channels, cfg.up_channels, \
            cfg.head_channels

        def cbr(cin, cout):
            return [nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.ReLU()]

        feats = (cbr(3, c[0]) + cbr(c[0], c[0]) + [nn.MaxPool2d(2, 2)]
                 + cbr(c[0], c[1]) + cbr(c[1], c[1]) + [nn.MaxPool2d(2, 2)]
                 + cbr(c[1], c[2]) + cbr(c[2], c[2]) + cbr(c[2], c[2]) + [nn.MaxPool2d(2, 2)]
                 + cbr(c[2], c[3]) + cbr(c[3], c[3]) + cbr(c[3], c[3]) + [nn.MaxPool2d(2, 2)]
                 + cbr(c[3], c[4]) + cbr(c[4], c[4]))
        base = nn.Module()
        for name, rng in SLICES:
            seq = nn.Sequential()
            for i in rng:
                seq.add_module(str(i), feats[i])
            setattr(base, name, seq)
        base.slice5 = nn.Sequential(nn.MaxPool2d(3, 1, 1),
                                    nn.Conv2d(c[4], fc, 3, padding=6, dilation=6),
                                    nn.Conv2d(fc, fc, 1))
        self.basenet = base
        in_chs = [fc + c[4], up[0][1] + c[3], up[1][1] + c[2], up[2][1] + c[1]]
        for i, ((mid, out), cin) in enumerate(zip(up, in_chs), start=1):
            blk = nn.Module()
            blk.conv = nn.Sequential(
                nn.Conv2d(cin, mid, 1), nn.BatchNorm2d(mid), nn.ReLU(),
                nn.Conv2d(mid, out, 3, padding=1), nn.BatchNorm2d(out), nn.ReLU())
            setattr(self, f"upconv{i}", blk)
        self.conv_cls = nn.Sequential(
            nn.Conv2d(up[-1][1], head[0], 3, padding=1), nn.ReLU(),
            nn.Conv2d(head[0], head[1], 3, padding=1), nn.ReLU(),
            nn.Conv2d(head[1], head[2], 3, padding=1), nn.ReLU(),
            nn.Conv2d(head[2], head[3], 1), nn.ReLU(),
            nn.Conv2d(head[3], cfg.num_classes, 1))

    def forward(self, x):
        b = self.basenet
        h = b.slice1(x)
        f2 = h
        h = b.slice2(h)
        f3 = h
        h = b.slice3(h)
        f4 = h
        h = b.slice4(h)
        f5 = h
        if self.relu_before_fc:
            h = F.relu(h)
        h = b.slice5(h)
        y = self.upconv1.conv(torch.cat([h, f5], dim=1))
        y = F.interpolate(y, size=f4.shape[2:], mode="bilinear", align_corners=False)
        y = self.upconv2.conv(torch.cat([y, f4], dim=1))
        y = F.interpolate(y, size=f3.shape[2:], mode="bilinear", align_corners=False)
        y = self.upconv3.conv(torch.cat([y, f3], dim=1))
        y = F.interpolate(y, size=f2.shape[2:], mode="bilinear", align_corners=False)
        feat = self.upconv4.conv(torch.cat([y, f2], dim=1))
        return self.conv_cls(feat).permute(0, 2, 3, 1)


class TorchParseq(nn.Module):
    """Upstream-shaped PARSEQ at the widths of `cfg` (dec_depth 1)."""

    def __init__(self, cfg):
        super().__init__()
        D = cfg.embed_dim
        eps = cfg.layer_norm_eps
        num_tokens = cfg.charset_size + 3
        seq_len = (cfg.img_size[0] // cfg.patch_size[0]) * (cfg.img_size[1] // cfg.patch_size[1])
        self.cfg_tuple = (cfg.enc_heads, cfg.dec_heads, cfg.max_label_length,
                          cfg.refine_iters, num_tokens)
        enc = nn.Module()
        pe = nn.Module()
        pe.proj = nn.Conv2d(3, D, tuple(cfg.patch_size), stride=tuple(cfg.patch_size))
        enc.patch_embed = pe
        enc.pos_embed = nn.Parameter(torch.randn(1, seq_len, D) * 0.02)
        H = int(D * cfg.enc_mlp_ratio)
        blocks = []
        for _ in range(cfg.enc_depth):
            b = nn.Module()
            b.norm1 = nn.LayerNorm(D, eps=eps)
            b.attn = nn.Module()
            b.attn.qkv = nn.Linear(D, 3 * D)
            b.attn.proj = nn.Linear(D, D)
            b.norm2 = nn.LayerNorm(D, eps=eps)
            b.mlp = nn.Module()
            b.mlp.fc1 = nn.Linear(D, H)
            b.mlp.fc2 = nn.Linear(H, D)
            blocks.append(b)
        enc.blocks = nn.ModuleList(blocks)
        enc.norm = nn.LayerNorm(D, eps=eps)
        self.encoder = enc
        te = nn.Module()
        te.embedding = nn.Embedding(num_tokens, D)
        self.text_embed = te
        self.pos_queries = nn.Parameter(torch.randn(1, cfg.max_label_length + 1, D) * 0.02)
        Hd = int(D * cfg.dec_mlp_ratio)
        layer = nn.Module()
        layer.self_attn = nn.MultiheadAttention(D, cfg.dec_heads, batch_first=True)
        layer.cross_attn = nn.MultiheadAttention(D, cfg.dec_heads, batch_first=True)
        for name in ("norm_q", "norm_c", "norm1", "norm2"):
            setattr(layer, name, nn.LayerNorm(D, eps=eps))
        layer.linear1 = nn.Linear(D, Hd)
        layer.linear2 = nn.Linear(Hd, D)
        dec = nn.Module()
        dec.layers = nn.ModuleList([layer])
        dec.norm = nn.LayerNorm(D, eps=eps)
        self.decoder = dec
        self.head = nn.Linear(D, cfg.charset_size + 1)

    def encode(self, x):
        heads = self.cfg_tuple[0]
        h = self.encoder.patch_embed.proj(x).flatten(2).transpose(1, 2)
        h = h + self.encoder.pos_embed
        for b in self.encoder.blocks:
            q, k, v = b.attn.qkv(b.norm1(h)).chunk(3, dim=-1)

            def split(z):
                n, s, d = z.shape
                return z.view(n, s, heads, d // heads).transpose(1, 2)

            a = F.scaled_dot_product_attention(split(q), split(k), split(v))
            h = h + b.attn.proj(a.transpose(1, 2).reshape(h.shape))
            h = h + b.mlp.fc2(F.gelu(b.mlp.fc1(b.norm2(h))))
        return self.encoder.norm(h)

    def decode(self, memory, tgt, allowed):
        """allowed: bool, True = may attend; [L, L] or [N * heads, L, L]."""
        D = self.head.in_features
        L = tgt.shape[1]
        emb = math.sqrt(D) * self.text_embed.embedding(tgt)
        pos = torch.cat([torch.zeros(1, D, dtype=emb.dtype), self.pos_queries[0, : L - 1]], 0)
        content = emb + pos
        q = self.pos_queries[:, :L].expand(tgt.shape[0], -1, -1)
        layer = self.decoder.layers[0]
        cn = layer.norm_c(content)
        sa, _ = layer.self_attn(layer.norm_q(q), cn, cn, attn_mask=~allowed, need_weights=False)
        q = q + sa
        ca, _ = layer.cross_attn(layer.norm1(q), memory, memory, need_weights=False)
        q = q + ca
        q = q + layer.linear2(F.gelu(layer.linear1(layer.norm2(q))))
        return self.head(self.decoder.norm(q))

    def forward(self, x):
        _, dec_heads, max_len, refine_iters, num_tokens = self.cfg_tuple
        memory = self.encode(x)
        N = x.shape[0]
        T = max_len + 1
        bos = num_tokens - 2
        tokens = torch.full((N, T + 1), bos, dtype=torch.long)
        steps = []
        for i in range(T):
            causal = torch.ones(i + 1, i + 1, dtype=torch.bool).tril()
            li = self.decode(memory, tokens[:, : i + 1], causal)[:, -1]
            steps.append(li)
            tokens = tokens.clone()
            tokens[:, i + 1] = li.argmax(-1)
        logits = torch.stack(steps, 1)
        for _ in range(refine_iters):
            prev = logits.argmax(-1)
            tgt_in = torch.cat([torch.full((N, 1), bos, dtype=torch.long), prev[:, :-1]], 1)
            pad = (tgt_in == 0).cumsum(1) > 0
            idx = torch.arange(T)
            rmask = idx[None, :] != idx[:, None] + 1  # query i blocks content i + 1
            allowed = (rmask[None] & ~pad[:, None, :]).repeat_interleave(dec_heads, dim=0)
            logits = self.decode(memory, tgt_in, allowed)
        return logits


class Normalized(nn.Module):
    """`inner` behind an input normalization (x - mean) / std over NCHW: a
    traced graph that normalizes internally."""

    def __init__(self, inner, mean, std):
        super().__init__()
        self.inner = inner
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32)[None, :, None, None])
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32)[None, :, None, None])

    def forward(self, x):
        return self.inner((x - self.mean) / self.std)


def randomize_bn_stats(model, seed=0):
    """Non-trivial running statistics, so that inference BatchNorms matter."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.3)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return model


# ---------------------------------------------------------------------------
# The converter's name maps, inverted: JAX tree -> upstream state dict
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _conv_sd(out, prefix, p):
    out[f"{prefix}.weight"] = _t(np.transpose(p["w"], (3, 2, 0, 1)))
    out[f"{prefix}.bias"] = _t(p["b"])


def _bn_sd(out, prefix, p):
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(p["mean"])
    out[f"{prefix}.running_var"] = _t(p["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _linear_sd(out, prefix, p):
    out[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    out[f"{prefix}.bias"] = _t(p["b"])


def _ln_sd(out, prefix, p):
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def craft_upstream_state_dict(tree):
    """An unfolded CRAFT tree -> `TorchCraft`'s state dict."""
    out = {}
    for idx, name in zip(VGG_CONV_IDX, VGG_NAMES):
        _conv_sd(out, f"basenet.{slice_of(idx)}.{idx}", tree["vgg"][name]["conv"])
        _bn_sd(out, f"basenet.{slice_of(idx + 1)}.{idx + 1}", tree["vgg"][name]["bn"])
    _conv_sd(out, "basenet.slice5.1", tree["fc"]["fc6"])
    _conv_sd(out, "basenet.slice5.2", tree["fc"]["fc7"])
    for i in range(1, 5):
        blk = tree["up"][f"upconv{i}"]
        _conv_sd(out, f"upconv{i}.conv.0", blk["conv1"])
        _bn_sd(out, f"upconv{i}.conv.1", blk["bn1"])
        _conv_sd(out, f"upconv{i}.conv.3", blk["conv2"])
        _bn_sd(out, f"upconv{i}.conv.4", blk["bn2"])
    for j, idx in enumerate(HEAD_IDX, start=1):
        _conv_sd(out, f"conv_cls.{idx}", tree["head"][f"conv{j}"])
    return out


def _fused(attn):
    w = np.concatenate([np.asarray(attn[n]["w"]).T for n in ("q", "k", "v")], 0)
    b = np.concatenate([np.asarray(attn[n]["b"]) for n in ("q", "k", "v")], 0)
    return _t(w), _t(b)


def parseq_upstream_state_dict(tree, cfg):
    """A PARSEQ tree -> `TorchParseq`'s state dict."""
    D = cfg.embed_dim
    ph, pw = cfg.patch_size
    pe = np.asarray(tree["patch_embed"]["w"]).reshape(ph, pw, 3, D)
    out = {"encoder.patch_embed.proj.weight": _t(np.transpose(pe, (3, 2, 0, 1))),
           "encoder.patch_embed.proj.bias": _t(tree["patch_embed"]["b"]),
           "encoder.pos_embed": _t(tree["pos_embed"]),
           "text_embed.embedding.weight": _t(tree["text_embed"]),
           "pos_queries": _t(tree["pos_queries"])}
    _ln_sd(out, "encoder.norm", tree["enc_norm"])
    _ln_sd(out, "decoder.norm", tree["dec_norm"])
    _linear_sd(out, "head", tree["head"])
    for i, blk in enumerate(tree["enc"]):
        b = f"encoder.blocks.{i}"
        _ln_sd(out, f"{b}.norm1", blk["norm1"])
        _ln_sd(out, f"{b}.norm2", blk["norm2"])
        out[f"{b}.attn.qkv.weight"], out[f"{b}.attn.qkv.bias"] = _fused(blk["attn"])
        _linear_sd(out, f"{b}.attn.proj", blk["attn"]["o"])
        _linear_sd(out, f"{b}.mlp.fc1", blk["mlp"]["fc1"])
        _linear_sd(out, f"{b}.mlp.fc2", blk["mlp"]["fc2"])
    for i, layer in enumerate(tree["dec"]):
        b = f"decoder.layers.{i}"
        for name in ("norm_q", "norm_c", "norm1", "norm2"):
            _ln_sd(out, f"{b}.{name}", layer[name])
        for attn in ("self_attn", "cross_attn"):
            out[f"{b}.{attn}.in_proj_weight"], out[f"{b}.{attn}.in_proj_bias"] = \
                _fused(layer[attn])
            _linear_sd(out, f"{b}.{attn}.out_proj", layer[attn]["o"])
        _linear_sd(out, f"{b}.linear1", layer["linear1"])
        _linear_sd(out, f"{b}.linear2", layer["linear2"])
    return out


def upstream_replicas(craft_tree, parseq_tree, craft_cfg, parseq_cfg, relu_before_fc=False):
    """(TorchCraft, TorchParseq) in eval mode holding the two trees."""
    craft = TorchCraft(craft_cfg, relu_before_fc)
    craft.load_state_dict(craft_upstream_state_dict(craft_tree))
    parseq = TorchParseq(parseq_cfg)
    parseq.load_state_dict(parseq_upstream_state_dict(parseq_tree, parseq_cfg))
    return craft.eval(), parseq.eval()


def save_traced(ref_dir, craft, parseq, craft_shape=(1, 3, 64, 96), parseq_shape=(2, 3, 32, 128)):
    """torch.jit.trace both replicas and save them under the reference's
    artifact names in `ref_dir`."""
    import os

    os.makedirs(ref_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        tc = torch.jit.trace(craft, torch.rand(craft_shape, generator=gen))
        tp = torch.jit.trace(parseq, torch.rand(parseq_shape, generator=gen))
    torch.jit.save(tc, os.path.join(ref_dir, "craft_traced_torchscript_model.pt"))
    torch.jit.save(tp, os.path.join(ref_dir, "parseq_torchscript.bin"))
