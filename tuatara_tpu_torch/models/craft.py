"""CRAFT text detector as a PyTorch module (NCHW inside, NHWC at the edge).

Port of `tuatara_tpu/models/craft.py` (`craft_forward` / `_craft_apply`) for
serving: the weights arrive with every BatchNorm already folded into its
conv (`tuatara_tpu_torch.weights.craft_state_dict`), so the trunk is
conv -> ReLU chains. Architecture:

* VGG16-BN trunk; the skips f2..f5 are the pre-ReLU outputs of the second
  conv of stages 2-5. conv5_3 and the last pool are dropped; a stride-1 3x3
  max-pool, a rate-6 dilated 3x3 "fc6" and a 1x1 "fc7" follow.
* U-Net decoder: at each level a 1x1 conv over concat(trunk, skip) +
  ReLU and a 3x3 conv + ReLU, the trunk side arriving at the previous
  level's resolution. The 1x1 conv runs as two convs summed, one per side
  of the concat (`conv1_split`). At fp32 the trunk side is bilinearly
  upsampled (half-pixel) to the skip's size first, the reference op
  order; at a 16-bit compute dtype its conv runs at the low resolution
  and its output is upsampled, as JAX orders it (the two commute in exact
  arithmetic, not in their roundings).
* Head: 3x[3x3 conv + ReLU] -> 1x1 conv + ReLU -> 1x1 conv to 2 channels.

int8 serving (`Craft.quantize`, JAX's `quantize_craft_trunk`): every trunk
and fc conv but conv1_1, the decoder's convs and the head's three 3x3 convs
become `QConv`s; each decoder conv1 is split along cin into `conv1a` (the
trunk side) and `conv1b` (the skip side), quantized apart. At a bf16 (or
any non-fp32) compute dtype conv1a runs on the low-resolution trunk and its
output is upsampled, as JAX orders it (`tuatara_tpu/models/craft.py:
476-491`); at fp32 the trunk is upsampled first. JAX packs the head's
width for the TPU; the packed int8 conv is bit-equal to the unpacked one,
so the head runs unpacked here. At bf16 the int8 layers already round
where XLA's CPU backend rounds JAX's graph (`tests/probe_torch_bf16.py
hlo`: every dequant output is rounded to bf16 before its ReLU, pool,
abs-max, sum or the next quantization, and the scales are the divisions
JAX writes), so given one folded tree each layer's dynamic scale and int8
input equal JAX's when its input does. The float conv1_1 before them runs
as `kernels/stem.stem_conv` (kernel SC), which sums each output in XLA's
order: another order rounds a few outputs to other bf16 values, and the
int8 trunk turns those into other int8 values and, layers later, other
scales.

At a 16-bit compute dtype (bf16 by default) the port rounds where XLA's
CPU backend rounds JAX's compiled forward: each float conv's product is
rounded before its bias is added, with a second rounding
(`layers.add_bias`: one `bias_act` pass with the ReLU that follows, and
the pre-ReLU output where a skip keeps it), and the upsample contracts
one axis at a time, rounding between (`upsample_to`).

At fp32 the port rounds where XLA's CPU backend rounds JAX's compiled
forward, so that int8 CRAFT's scores equal JAX's bit for bit given one
folded tree: the 2x upsamples (`_upsample2x`), each int8 decoder level's
`ya + acc * s` as one fused multiply-add, and the head's float 1x1 convs
(`_conv1x1_xla`, for the committed weight sets' shapes).

Training (`TrainableCraft`, JAX `init_craft_params` and
`craft_forward_train`): the same network with its BatchNorms unfolded,
each a `layers.BatchNorm` (trained scale and shift, running statistics as
buffers) that normalises with batch statistics and updates its buffers, or
with the running statistics when `train_bn` is off. The forward follows
JAX's training graph: products in the compute dtype with fp32 parameters,
BatchNorm outputs (and so the skips) in fp32, the decoder's trunk side
upsampled before its 1x1 conv at fp32 and after it otherwise, the head
unpacked. At a 16-bit dtype the head's conv1-4 round their bias add
twice before the ReLU and conv5 adds its bias in fp32, as XLA compiles
JAX's loss gradient (`tests/probe_torch_bf16.py hlo`); the other sums keep
cuDNN's bias (ROADMAP Queue 3 item 19: JAX's form there moved phase 7's
bf16 parity out of its bounds or the gradients no closer). Its 2x
upsamples are sums of shifted copies (`upsample2x_train`), whose backward
is deterministic on the card, where `F.interpolate`'s is not. `fold()` gives the serving `Craft` through the
loader's own fold. None of the serving transforms (K8's packed weights,
the head's XLA rounding, int8) touches it.

`FUSED_STAGE1` gates kernel K8 (`kernels/stage1.py`), which runs conv1_2,
its ReLU and pool1 as one pass, as the JAX package's gate of the same name
does (`tuatara_tpu/models/craft.py:279-298`). K8 reads conv1_2's weights
packed for its wgmma B operand: the module holds them as the buffer
`conv1_2_packed`, packed when the weights are loaded (and moved with the
module by `.to`), so no call packs them again; likewise int8 CRAFT's SC
reads conv1_1's weights and bias packed by `quantize` (`conv1_1_packed_w`,
`conv1_1_packed_b`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tuatara_tpu_torch.config import CraftConfig
from tuatara_tpu_torch.kernels import stem
from tuatara_tpu_torch.kernels.bias_act import bias_add_f32
from tuatara_tpu_torch.kernels.stage1 import fused_conv_pool, pack_conv_pool_weights
from tuatara_tpu_torch.models.layers import BatchNorm, Conv, QConv, add_bias, dequant, init_conv
from tuatara_tpu_torch.ops.minarearect import fma
from tuatara_tpu_torch.ops.resize import resize_weights

_STAGE_COUNTS = (2, 2, 3, 3, 2)

# "off" (the default, as in JAX): conv1_2 -> ReLU -> pool1 as three calls.
# "on": K8 wherever `_fused_stage1_ok` holds (the plain version on the CPU).
# "auto": K8 on the card only, as JAX's "auto" takes it on the TPU only.
FUSED_STAGE1 = "off"


def vgg_plan(cfg: CraftConfig):
    """[(name, cin, cout, pool_before, skip_tag)] trunk table."""
    plan = []
    cin = 3
    for s, (count, cout) in enumerate(zip(_STAGE_COUNTS, cfg.stage_channels)):
        for i in range(count):
            name = f"conv{s + 1}_{i + 1}"
            skip = f"f{s + 1}" if (s >= 1 and i == 1) else None
            plan.append((name, cin, cout, s >= 1 and i == 0, skip))
            cin = cout
    return plan


def upsample_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel (align_corners=False) semantics,
    rounded as XLA's CPU backend rounds JAX's `jax.image.resize`. At fp32 a
    2x upsample (every level of the U-Net when the canvas is a multiple of
    32) takes `_upsample2x`, on either device. At a 16-bit dtype JAX's
    resize is one einsum of x with a weight matrix per axis, which
    contracts one axis, rounds to the dtype, then contracts the other: the
    axis first whose order costs fewer products (opt_einsum's choice; H
    first on a tie), each pass summing its taps in fp32 (`_resize_axis`)."""
    hi, wi = x.shape[-2:]
    if x.dtype == torch.float32:
        if (h, w) == (2 * hi, 2 * wi):
            return _upsample2x(x)
        return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    h_first = wi * h * (hi + w) <= hi * w * (wi + h)
    for dim, n in ((2, h), (3, w)) if h_first else ((3, w), (2, h)):
        x = _resize_axis(x, dim, n)
    return x


def _resize_axis(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """Resize axis `dim` (2 or 3) of a 16-bit NCHW tensor to n: each output
    sums its (at most two) bilinear taps in fp32, whose products of 16-bit
    values and weights are exact, and rounds once to x's dtype. A 2x axis
    is one `F.interpolate` pass, whose weights (0.25, 0.75; 1 at the edges)
    are JAX's; another size takes JAX's weight matrix, rounded to x's
    dtype, as an fp32 product."""
    m = x.shape[dim]
    if n == m:
        return x
    if n == 2 * m:
        size = list(x.shape[-2:])
        size[dim - 2] = n
        return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
    wm = resize_weights(m, n).to(x.dtype).to(x.device, torch.float32)
    return torch.movedim(torch.movedim(x.float(), dim, -1) @ wm, -1, dim).to(x.dtype)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """fp32 NCHW 2x bilinear upsample, rounded as XLA's CPU backend rounds
    `jax.image.resize`. JAX contracts one [n, 2n] weight matrix per axis
    (weights 0.75 and 0.25, exact; 1 at the two edge outputs): the first
    contraction is the longer axis (H when H >= W), the second the other.
    An output adds its taps in index order: 0.25 * x[k - 1] (exact), then
    0.75 * x[k], fused into one rounding in the first contraction; in the
    second only when its output width 2n falls at most 12 short of a
    multiple of 64 (XLA's dot takes another kernel there), else the
    product rounds first. Odd outputs add 0.25 * x[k + 1] last, exact
    either way. Both orders are held against XLA on the CPU by
    tests/test_torch_int8.py."""
    first, second = (3, 2) if x.shape[3] > x.shape[2] else (2, 3)
    x = _upsample2x_axis(x, first, fused=True)
    n2 = 2 * x.shape[second]
    return _upsample2x_axis(x, second, fused=(-n2) % 64 <= 12)


def _upsample2x_axis(x: torch.Tensor, dim: int, fused: bool) -> torch.Tensor:
    n = x.shape[dim]
    lo = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim) * 0.25
    hi = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim) * 0.25
    mid = x * 0.75
    even = fma(x, torch.full_like(x, 0.75), lo) if fused else mid + lo
    odd = mid + hi
    even.narrow(dim, 0, 1).copy_(x.narrow(dim, 0, 1))
    odd.narrow(dim, n - 1, 1).copy_(x.narrow(dim, n - 1, 1))
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


# XLA's CPU backend runs JAX's width-packed head 1x1 convs (`_pack4_1x1_w`:
# cin 4C, cout 4O) as dots whose reduction it splits by shape: channel c
# goes to partial sum c % lanes (a chain of fused multiply-adds in channel
# order), and the partial sums add pairwise. Measured for the committed
# weight sets' heads, (C, O) -> lanes; other shapes take cuDNN/oneDNN.
_HEAD_1X1_LANES = {(8, 8): 2, (8, 2): 4, (16, 16): 1, (16, 2): 4}


def _conv1x1_xla(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    """An fp32 head 1x1 conv over NCHW rounded as XLA's CPU backend rounds
    JAX's packed one (`_HEAD_1X1_LANES`), on either device."""
    w = conv.weight[:, :, 0, 0].double()
    lanes = _HEAD_1X1_LANES[(w.shape[1], w.shape[0])]
    parts = []
    for lane in range(lanes):
        acc = None
        for c in range(lane, w.shape[1], lanes):
            p = x[:, c:c + 1].double() * w[:, c, None, None]
            acc = p.float() if acc is None else (p + acc.double()).float()
        parts.append(acc)
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0] + conv.bias[:, None, None]


def _conv_relu(conv: nn.Module, x: torch.Tensor, keep_pre: bool = False):
    """ReLU(conv(x)), and conv(x) too with `keep_pre`: a float `Conv` at a
    16-bit dtype adds its bias and the ReLU in one pass."""
    if isinstance(conv, Conv) and conv.weight.dtype != torch.float32:
        return conv(x, relu=True, keep_pre=keep_pre)
    y = conv(x)
    return (F.relu(y), y) if keep_pre else F.relu(y)


def _qconv(conv: Conv) -> QConv:
    return QConv.from_weight(conv.weight, conv.bias, conv.dilation)


def _input_nchw(cfg: CraftConfig, x: torch.Tensor, cin: int) -> torch.Tensor:
    """[B, H, W, C] in [0, 1] -> NCHW conv1_1 input: the model contract's
    mean/std normalisation when the config has one (a gray canvas
    broadcast to its channels first), then a 1-channel canvas broadcast to
    conv1_1's input channels."""
    h = x.permute(0, 3, 1, 2)
    if cfg.input_mean:
        if h.shape[1] == 1 and len(cfg.input_mean) > 1:
            h = h.expand(-1, len(cfg.input_mean), -1, -1)
        mean = torch.tensor(cfg.input_mean, dtype=torch.float32, device=h.device)
        std = torch.tensor(cfg.input_std or (1.0,) * len(cfg.input_mean),
                           dtype=torch.float32, device=h.device)
        h = (h.float() - mean[:, None, None]) / std[:, None, None]
    if h.shape[1] == 1 and cin != 1:
        h = h.expand(-1, cin, -1, -1)
    return h


class Craft(nn.Module):
    """BN-folded CRAFT. Parameter names follow the JAX parameter tree."""

    def __init__(self, cfg: CraftConfig = CraftConfig()):
        super().__init__()
        self.cfg = cfg
        self.plan = vgg_plan(cfg)
        self.vgg = nn.ModuleDict({
            name: nn.ModuleDict({"conv": Conv(cin, cout, 3)})
            for name, cin, cout, _, _ in self.plan
        })
        s = cfg.stage_channels
        self.fc = nn.ModuleDict({
            "fc6": Conv(s[4], cfg.fc_channels, 3, dilation=6),
            "fc7": Conv(cfg.fc_channels, cfg.fc_channels, 1),
        })
        in_chs = [cfg.fc_channels + s[4], cfg.up_channels[0][1] + s[3],
                  cfg.up_channels[1][1] + s[2], cfg.up_channels[2][1] + s[1]]
        self.up = nn.ModuleDict({
            f"upconv{i}": nn.ModuleDict({"conv1": Conv(cin, mid, 1),
                                         "conv2": Conv(mid, out, 3)})
            for i, ((mid, out), cin) in enumerate(zip(cfg.up_channels, in_chs), 1)
        })
        hc = cfg.head_channels
        self.head = nn.ModuleDict({
            "conv1": Conv(cfg.up_channels[-1][1], hc[0], 3),
            "conv2": Conv(hc[0], hc[1], 3),
            "conv3": Conv(hc[1], hc[2], 3),
            "conv4": Conv(hc[2], hc[3], 1),
            "conv5": Conv(hc[3], cfg.num_classes, 1),
        })
        self.register_buffer("conv1_2_packed", None, persistent=False)
        self.register_buffer("conv1_1_packed_w", None, persistent=False)
        self.register_buffer("conv1_1_packed_b", None, persistent=False)
        self._pack_conv1_2()
        self.register_load_state_dict_post_hook(Craft._pack_conv1_2)

    def _pack_conv1_2(self, _incompatible_keys=None) -> None:
        """Pack conv1_2's weights for K8 (conv1_1's for SC once quantized);
        also the load_state_dict post-hook."""
        if self.quantized:
            self._pack_conv1_1()
        else:
            self.conv1_2_packed = pack_conv_pool_weights(self.vgg["conv1_2"]["conv"].weight)

    def _pack_conv1_1(self) -> None:
        """Pack conv1_1's weights and bias for SC (`stem.pack_stem_weights`:
        their bf16 values, which a later cast to bf16 keeps)."""
        c11 = self.vgg["conv1_1"]["conv"]
        self.conv1_1_packed_w, self.conv1_1_packed_b = stem.pack_stem_weights(c11.weight,
                                                                              c11.bias)

    @property
    def quantized(self) -> bool:
        return isinstance(self.vgg["conv1_2"]["conv"], QConv)

    def qconvs(self):
        """[(name, QConv)] of a quantized model, in module order; the names
        are the '/'-joined paths of the JAX tree (`vgg/conv1_2/conv`)."""
        return [(n.replace(".", "/"), m) for n, m in self.named_modules() if isinstance(m, QConv)]

    @torch.no_grad()
    def quantize(self) -> "Craft":
        """JAX `quantize_craft_trunk` on the fp32 BN-folded weights (call it
        before `set_compute_dtype`); idempotent."""
        if self.quantized:
            return self
        for name, blk in self.vgg.items():
            if name != "conv1_1":
                blk["conv"] = _qconv(blk["conv"])
        for name in ("fc6", "fc7"):
            self.fc[name] = _qconv(self.fc[name])
        ca = self.fc["fc7"].cout  # conv1's split: the trunk side's width
        for name, blk in self.up.items():
            w, b = blk["conv1"].weight, blk["conv1"].bias
            self.up[name] = nn.ModuleDict({
                "conv1a": QConv.from_weight(w[:, :ca], b),
                "conv1b": QConv.from_weight(w[:, ca:], None),
                "conv2": _qconv(blk["conv2"])})
            ca = self.up[name]["conv2"].cout
        for name in ("conv1", "conv2", "conv3"):
            self.head[name] = _qconv(self.head[name])
        self.conv1_2_packed = None  # K8 never runs with an int8 conv1_2
        self._pack_conv1_1()
        return self

    def _double_conv(self, block: str, y: torch.Tensor, skip: torch.Tensor
                     ) -> torch.Tensor:
        """A float decoder level (JAX `conv1_split`, then conv2): the 1x1
        conv1 as two convs summed, one a side of the concat; at fp32 the
        trunk side is upsampled first, at a 16-bit dtype its conv (with
        the bias, rounded as `Conv` rounds it) runs at the low resolution
        and its output is upsampled."""
        blk = self.up[block]
        if "conv1a" in blk:
            return self._double_conv_q(blk, y, skip)
        size = skip.shape[-2:]
        up = y.shape[-2:] != size
        c1 = blk["conv1"]
        w, ca = c1.weight, y.shape[1]
        if w.dtype == torch.float32:
            if up:
                y = upsample_to(y, *size)
            ya = F.conv2d(y, w[:, :ca], c1.bias)
        else:
            ya = add_bias(F.conv2d(y.to(w.dtype), w[:, :ca]), c1.bias)
            if up:
                ya = upsample_to(ya, *size)
        yb = F.conv2d(skip.to(w.dtype), w[:, ca:])
        return _conv_relu(blk["conv2"], F.relu(ya + yb))

    def _double_conv_q(self, blk: nn.ModuleDict, y: torch.Tensor, skip: torch.Tensor
                       ) -> torch.Tensor:
        """The int8 decoder level (JAX `conv1_split` with "conv1a"): conv1b
        quantizes the pre-ReLU skip; conv1a runs before the upsample except
        at fp32."""
        size = skip.shape[-2:]
        up = y.shape[-2:] != size
        if up and self.vgg["conv1_1"]["conv"].weight.dtype == torch.float32:
            y = upsample_to(y, *size)
            up = False
        ya = blk["conv1a"](y)
        if up:
            ya = upsample_to(ya, *size)
        if ya.dtype == torch.float32:
            # XLA fuses the skip side's dequant into the sum: ya + acc * s
            # rounds once (conv1b has no bias).
            acc, scale = blk["conv1b"].sums(skip)
            y = dequant(acc, scale, ya.permute(0, 2, 3, 1), torch.float32).permute(0, 3, 1, 2)
        else:
            y = ya + blk["conv1b"](skip)
        return F.relu(blk["conv2"](F.relu(y)))

    def _fused_stage1_ok(self, x: torch.Tensor) -> bool:
        """JAX's gate (`models/craft.py:283-298`): serving (not training), a
        folded tree (the port's always is: BatchNorms fold at load), conv1_1
        and conv1_2 not quantized (float weights), bf16 compute, and the
        canvas [B, H, W, C] with H % 16 == 0 and W % 2 == 0."""
        if FUSED_STAGE1 == "off" or self.training or self.quantized:
            return False
        w11 = self.vgg["conv1_1"]["conv"].weight
        w12 = self.vgg["conv1_2"]["conv"].weight
        ok = (w11.is_floating_point() and w12.is_floating_point()
              and w12.dtype == torch.bfloat16
              and x.shape[1] % 16 == 0 and x.shape[2] % 2 == 0)
        if FUSED_STAGE1 == "on":
            return ok
        return ok and x.is_cuda

    def _stem_ok(self) -> bool:
        """conv1_1 through `stem_conv` (XLA's summation order): int8 CRAFT
        at bf16, a 3x3 conv1_1 within the kernel's limits."""
        w = self.vgg["conv1_1"]["conv"].weight
        return (self.quantized and w.dtype == torch.bfloat16 and w.shape[2:] == (3, 3)
                and w.shape[1] <= stem.MAX_CIN and w.shape[0] % 8 == 0
                and w.shape[0] <= stem.MAX_COUT)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, H, W, C] float in [0, 1], C = 3 or 1 (gray is broadcast to
        conv1_1's input channels). Returns (scores [B, H/2, W/2, 2] fp32 —
        region, affinity — and feature [B, H/2, W/2, 32] fp32)."""
        h = _input_nchw(self.cfg, x, self.vgg["conv1_1"]["conv"].weight.shape[1])
        skips: Dict[str, torch.Tensor] = {}
        start = 0
        if self._fused_stage1_ok(x):
            # conv1_1 -> ReLU as usual, then K8 runs conv1_2 + ReLU + pool1
            # (stage 1 has no skip), so conv2_1 skips its pool. K8 reads
            # channels_last: conv1_1's input already is (the NHWC canvas or
            # its normalized copy) unless a gray canvas was broadcast to its
            # channels, and the convolution keeps its input's layout.
            h = h.contiguous(memory_format=torch.channels_last)
            h = _conv_relu(self.vgg["conv1_1"]["conv"], h)
            h = fused_conv_pool(h, self.conv1_2_packed, self.vgg["conv1_2"]["conv"].bias)
            start = 2
        for idx, (name, _, _, pool_before, skip) in enumerate(self.plan):
            if idx < start:
                continue
            if pool_before and not (start and idx == start):  # K8 pooled already
                h = F.max_pool2d(h, 2, 2)
            if skip is not None:
                h, skips[skip] = _conv_relu(self.vgg[name]["conv"], h, keep_pre=True)
            elif idx == 0 and self._stem_ok():
                c11 = self.vgg[name]["conv"]
                h = stem.stem_conv(h, c11.weight, c11.bias,
                                   (self.conv1_1_packed_w, self.conv1_1_packed_b))
            else:
                h = _conv_relu(self.vgg[name]["conv"], h)

        h = F.max_pool2d(h, 3, 1, padding=1)  # -inf padding, as in JAX
        h = self.fc["fc6"](h)
        h = self.fc["fc7"](h)

        y = self._double_conv("upconv1", h, skips["f5"])
        y = self._double_conv("upconv2", y, skips["f4"])
        y = self._double_conv("upconv3", y, skips["f3"])
        feat = self._double_conv("upconv4", y, skips["f2"])
        hd = self.head
        y = _conv_relu(hd["conv1"], feat)
        y = _conv_relu(hd["conv2"], y)
        y = _conv_relu(hd["conv3"], y)
        if self.quantized and y.dtype == torch.float32 and all(
                (hd[n].weight.shape[1], hd[n].weight.shape[0]) in _HEAD_1X1_LANES
                for n in ("conv4", "conv5")):
            # The int8 convs before are exact: round the float 1x1s as XLA
            # does and the fp32 scores equal JAX's.
            y = _conv1x1_xla(hd["conv5"], F.relu(_conv1x1_xla(hd["conv4"], y)))
        else:
            y = hd["conv5"](_conv_relu(hd["conv4"], y))
        return (y.float().permute(0, 2, 3, 1).contiguous(),
                feat.float().permute(0, 2, 3, 1).contiguous())


def upsample2x_train(x: torch.Tensor) -> torch.Tensor:
    """NCHW 2x bilinear upsample (half-pixel), taps added in fp32 and the
    result cast back to x's dtype: shifted copies, products and sums only,
    so its backward is deterministic on the card. Within fp32 rounding of
    `jax.image.resize`."""
    y = _upsample2x_axis(x.float(), 2, fused=False)
    return _upsample2x_axis(y, 3, fused=False).to(x.dtype)


def _train_conv(site: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                dt: torch.dtype, *, form: str = "fused", padding: int = 0,
                dilation: int = 1, relu: bool = False) -> torch.Tensor:
    """A training conv at compute dtype dt (w and b fp32 parameters), then
    its ReLU with `relu`. At a 16-bit dt the bias is added in `form`:
    "fused", the conv's own bias (on the card PyTorch adds it to cuDNN's
    rounded output in a second op, so two roundings; on the CPU oneDNN adds
    it inside the product, one); "rounded", the product rounded, then the
    bias with a second rounding (`add_bias`: with the ReLU, one `bias_act`
    pass); "fp32", fp32(product) + fp32(bias), never rounded
    (`bias_add_f32`). `site` names the sum (JAX `craft.py`: "vgg" :446,
    "fc" :457-458, "up_conv1" :497, "up_conv2" :508, "head" :563-566,
    "head_out" :567), for probes that wrap this function to try another
    form at a site."""
    if dt == torch.float32:
        form = "fused"
    y = F.conv2d(x.to(dt), w.to(dt), b.to(dt) if form == "fused" else None, padding=padding,
                 dilation=dilation)
    if form == "rounded":
        return add_bias(y, b, "relu" if relu else None)
    if form == "fp32":
        y = bias_add_f32(y, b, dim=1)
    return F.relu(y) if relu else y


def _train_sum(ya: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """A decoder level's ya + yb into bn1 (JAX `craft.py:501`), at the
    compute dtype; a probe wraps it to try JAX's unrounded fp32 sum."""
    return ya + yb


def _conv_dt(conv: Conv, h: torch.Tensor, dt: torch.dtype, site: str, form: str = "fused",
             relu: bool = False) -> torch.Tensor:
    return _train_conv(site, h, conv.weight, conv.bias, dt, form=form, padding=conv.padding,
                       dilation=conv.dilation, relu=relu)


class TrainableCraft(nn.Module):
    """CRAFT with unfolded BatchNorms, for training. Parameter paths follow
    the JAX tree (`vgg/conv1_1/bn/scale` is `vgg.conv1_1.bn.weight`)."""

    def __init__(self, cfg: CraftConfig = CraftConfig()):
        super().__init__()
        self.cfg = cfg
        self.plan = vgg_plan(cfg)
        eps = cfg.bn_eps
        self.vgg = nn.ModuleDict({
            name: nn.ModuleDict({"conv": Conv(cin, cout, 3), "bn": BatchNorm(cout, eps)})
            for name, cin, cout, _, _ in self.plan
        })
        s = cfg.stage_channels
        self.fc = nn.ModuleDict({
            "fc6": Conv(s[4], cfg.fc_channels, 3, dilation=6),
            "fc7": Conv(cfg.fc_channels, cfg.fc_channels, 1),
        })
        in_chs = [cfg.fc_channels + s[4], cfg.up_channels[0][1] + s[3],
                  cfg.up_channels[1][1] + s[2], cfg.up_channels[2][1] + s[1]]
        self.up = nn.ModuleDict({
            f"upconv{i}": nn.ModuleDict({"conv1": Conv(cin, mid, 1), "bn1": BatchNorm(mid, eps),
                                         "conv2": Conv(mid, out, 3), "bn2": BatchNorm(out, eps)})
            for i, ((mid, out), cin) in enumerate(zip(cfg.up_channels, in_chs), 1)
        })
        hc = cfg.head_channels
        self.head = nn.ModuleDict({
            "conv1": Conv(cfg.up_channels[-1][1], hc[0], 3),
            "conv2": Conv(hc[0], hc[1], 3),
            "conv3": Conv(hc[1], hc[2], 3),
            "conv4": Conv(hc[2], hc[3], 1),
            "conv5": Conv(hc[3], cfg.num_classes, 1),
        })

    def convs(self):
        """The convolutions in the order JAX's `init_craft_params` draws
        them: the trunk, fc6, fc7, each decoder level's conv1 and conv2,
        the head."""
        out = [self.vgg[name]["conv"] for name, *_ in self.plan]
        out += [self.fc["fc6"], self.fc["fc7"]]
        for blk in self.up.values():
            out += [blk["conv1"], blk["conv2"]]
        return out + [self.head[f"conv{i}"] for i in range(1, 6)]

    def _level(self, block: str, y: torch.Tensor, skip: torch.Tensor, dt: torch.dtype,
               train_bn: bool, momentum: float) -> torch.Tensor:
        """JAX `double_conv` over `conv1_split`: the 1x1 conv as two convs
        summed, one a side of the concat; the trunk side upsampled before
        its conv at fp32, after it at other dtypes."""
        blk = self.up[block]
        up = y.shape[-2:] != skip.shape[-2:]
        if up and dt == torch.float32:
            y, up = upsample2x_train(y), False
        c1 = blk["conv1"]
        ca = y.shape[1]
        ya = _train_conv("up_conv1", y, c1.weight[:, :ca], c1.bias, dt)
        if up:
            ya = upsample2x_train(ya)
        yb = F.conv2d(skip.to(dt), c1.weight[:, ca:].to(dt))
        y = F.relu(blk["bn1"](_train_sum(ya, yb), train_bn, momentum))
        return F.relu(blk["bn2"](_conv_dt(blk["conv2"], y, dt, "up_conv2"), train_bn, momentum))

    def forward(self, x: torch.Tensor, train_bn: bool = True,
                compute_dtype: torch.dtype = torch.bfloat16, momentum: float = 0.1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, H, W, C] in [0, 1] with H and W multiples of 32 -> (scores
        [B, H/2, W/2, 2] fp32, feature [B, H/2, W/2, 32] fp32). With
        `train_bn` the BatchNorms use batch statistics and update their
        running statistics in place (JAX `craft_forward_train`); without,
        they use the running statistics (JAX `craft_forward` on the
        unfolded tree)."""
        dt = compute_dtype
        if x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError(f"training pages must be multiples of 32 a side, got {tuple(x.shape)}")
        h = _input_nchw(self.cfg, x, self.vgg["conv1_1"]["conv"].weight.shape[1])
        skips: Dict[str, torch.Tensor] = {}
        for name, _, _, pool_before, skip in self.plan:
            if pool_before:
                h = F.max_pool2d(h, 2, 2)
            blk = self.vgg[name]
            h = blk["bn"](_conv_dt(blk["conv"], h, dt, "vgg"), train_bn, momentum)
            if skip is not None:
                skips[skip] = h  # pre-ReLU, fp32
            h = F.relu(h)
        h = F.max_pool2d(h, 3, 1, padding=1)
        h = _conv_dt(self.fc["fc7"], _conv_dt(self.fc["fc6"], h, dt, "fc"), dt, "fc")
        y = self._level("upconv1", h, skips["f5"], dt, train_bn, momentum)
        y = self._level("upconv2", y, skips["f4"], dt, train_bn, momentum)
        y = self._level("upconv3", y, skips["f3"], dt, train_bn, momentum)
        feat = self._level("upconv4", y, skips["f2"], dt, train_bn, momentum)
        hd = self.head
        y = feat
        for name in ("conv1", "conv2", "conv3", "conv4"):
            y = _conv_dt(hd[name], y, dt, "head", "rounded", relu=True)
        y = _conv_dt(hd["conv5"], y, dt, "head_out", "fp32")
        return (y.float().permute(0, 2, 3, 1).contiguous(),
                feat.float().permute(0, 2, 3, 1).contiguous())

    @torch.no_grad()
    def fold(self) -> Craft:
        """The serving `Craft` on this model's device: the weights go
        through JAX's tree and the loader's BatchNorm fold
        (`weights.craft_state_dict`), as a saved checkpoint would."""
        from tuatara_tpu_torch.weights import craft_state_dict, module_tree

        served = Craft(self.cfg)
        served.load_state_dict(craft_state_dict(module_tree(self), self.cfg.bn_eps))
        return served.to(self.vgg["conv1_1"]["conv"].weight.device)


def init_craft(cfg: CraftConfig = CraftConfig(),
               generator: Optional[torch.Generator] = None) -> TrainableCraft:
    """A random `TrainableCraft` on the CPU (JAX `init_craft_params`):
    he-normal convs with zero biases, drawn from `generator` in JAX's
    order, and identity BatchNorms."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    model = TrainableCraft(cfg)
    for conv in model.convs():
        init_conv(conv, gen)
    return model
