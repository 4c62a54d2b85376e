"""CRAFT in plain fp32 PyTorch, from the weights file alone.

Baek et al., CVPR 2019 (clovaai/CRAFT-pytorch `craft.py`): a VGG16-BN
trunk (conv5_3 dropped), a stride-1 3x3 max-pool, a rate-6 dilated 3x3
"fc6" and a 1x1 "fc7" with no activation, a U-Net decoder of four levels
(the trunk upsampled bilinearly, half-pixel, to the skip's size, concat
[trunk, skip], 1x1 conv + BN + ReLU, 3x3 conv + BN + ReLU), and a head of
three 3x3 convs, a 1x1 conv with ReLUs and a 1x1 conv to the region and
affinity maps at half the input's resolution. The skips are the pre-ReLU
outputs of conv2_2, conv3_2, conv4_2 and conv5_2.

Every BatchNorm runs as itself, in inference form, after its conv: nothing
is folded. Each conv runs in the format that `formats` gives its path
(`quant.py`): a per-output-channel scale of the unfolded weights rounds
them as that of the folded ones does, since the fold scales each output
channel. A quantized decoder level splits its 1x1 conv1 along the concat,
each side with its own scales, and runs the trunk side before the
upsample, as a quantized program does. The weights come from `craft.npz`
(the JAX layout: conv kernels HWIO) read with NumPy. Nothing here imports
the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from reference.quant import round_operands

STAGES = ((1, 2), (2, 2), (3, 3), (4, 3), (5, 2))  # (stage, convs); conv5_3 dropped
SKIPS = {"conv2_2": "f2", "conv3_2": "f3", "conv4_2": "f4", "conv5_2": "f5"}
BN_EPS = 1e-5


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class CraftRef:
    """CRAFT's forward on `device`, BatchNorms unfolded; each conv in the
    format `formats` gives its path, or its "default" (None: fp32)."""

    def __init__(self, flat: Dict[str, np.ndarray], device,
                 formats: Optional[Dict[str, Optional[str]]] = None):
        self.p = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                  for k, v in flat.items()}
        self.formats = formats or {"default": None}

    def fmt(self, path: str) -> Optional[str]:
        return self.formats.get(path, self.formats["default"])

    @property
    def batch_wide(self) -> bool:
        """Whether a page's maps depend on the pages beside it (a quantized
        conv's activation scale spans the batch)."""
        return any(v is not None for v in self.formats.values())

    def weight(self, path: str) -> torch.Tensor:
        return self.p[f"{path}/w"].permute(3, 2, 0, 1)  # HWIO -> OIHW

    @staticmethod
    def run(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], kind: Optional[str],
            dilation: int = 1) -> torch.Tensor:
        x, w = round_operands(x, w, kind)
        pad = dilation * (w.shape[-1] - 1) // 2
        return F.conv2d(x, w, b, padding=pad, dilation=dilation)

    def conv(self, x: torch.Tensor, path: str, dilation: int = 1) -> torch.Tensor:
        return self.run(x, self.weight(path), self.p[f"{path}/b"], self.fmt(path), dilation)

    def conv1(self, y: torch.Tensor, skip: torch.Tensor, path: str) -> torch.Tensor:
        """A decoder level's 1x1 conv over concat(trunk, skip), the trunk
        [B, C, h, w] at the previous level's size."""
        kind = self.fmt(path)
        up = y.shape[-2:] != skip.shape[-2:]
        if kind is None:
            if up:
                y = F.interpolate(y, size=skip.shape[-2:], mode="bilinear", align_corners=False)
            return self.conv(torch.cat([y, skip], 1), path)
        w, ca = self.weight(path), y.shape[1]
        ya = self.run(y, w[:, :ca], self.p[f"{path}/b"], kind)
        if up:
            ya = F.interpolate(ya, size=skip.shape[-2:], mode="bilinear", align_corners=False)
        return ya + self.run(skip, w[:, ca:], None, kind)

    def bn(self, x: torch.Tensor, path: str) -> torch.Tensor:
        g, b = self.p[f"{path}/scale"], self.p[f"{path}/bias"]
        m, v = self.p[f"{path}/mean"], self.p[f"{path}/var"]
        inv = g / torch.sqrt(v + BN_EPS)
        return (x - m[:, None, None]) * inv[:, None, None] + b[:, None, None]

    def forward(self, canvas: torch.Tensor) -> torch.Tensor:
        """canvas [B, H, W, 3] fp32 in [0, 1] (BGR, H and W multiples of
        32) -> scores [B, H/2, W/2, 2] (region, affinity)."""
        h = canvas.permute(0, 3, 1, 2)
        skips = {}
        for stage, count in STAGES:
            if stage > 1:
                h = F.max_pool2d(h, 2, 2)
            for i in range(1, count + 1):
                name = f"conv{stage}_{i}"
                pre = self.bn(self.conv(h, f"vgg/{name}/conv"), f"vgg/{name}/bn")
                if name in SKIPS:
                    skips[SKIPS[name]] = pre
                h = F.relu(pre)
        h = F.max_pool2d(h, 3, 1, padding=1)
        h = self.conv(h, "fc/fc6", dilation=6)
        y = self.conv(h, "fc/fc7")
        for level, skip in enumerate(("f5", "f4", "f3", "f2"), 1):
            blk = f"up/upconv{level}"
            y = F.relu(self.bn(self.conv1(y, skips[skip], f"{blk}/conv1"), f"{blk}/bn1"))
            y = F.relu(self.bn(self.conv(y, f"{blk}/conv2"), f"{blk}/bn2"))
        for name in ("conv1", "conv2", "conv3", "conv4"):
            y = F.relu(self.conv(y, f"head/{name}"))
        y = self.conv(y, "head/conv5")
        return y.permute(0, 2, 3, 1).contiguous()
