"""The plain reference of one page: canvas, CRAFT, boxes, crops, PARSeq.

Reads the weights directory with NumPy and JSON alone: `craft.npz`,
`parseq.npz` and the architecture and charset in `config.json`. Works out
everything the program derives again: the canvas, the BatchNorms (unfolded),
the int8 weight scales and the batch-wide activation scales of the convs
the configuration states in int8, the boxes, the crop windows and the
crops. Runs in fp32 with TF32 off, int8 layers in int8 (`quant.py`); as a
lower-precision control, each layer one format further down. Nothing here
imports the program.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from reference import boxes as B
from reference.craft import CraftRef, load_npz
from reference.parseq import ParseqRef, confidence
from reference.quant import layer_formats


class Reference:
    def __init__(self, weights_dir: str, det: Dict, device,
                 craft_formats: Optional[Dict[str, Optional[str]]] = None,
                 parseq_format: Optional[str] = None, block: int = 256):
        with open(os.path.join(weights_dir, "config.json")) as f:
            meta = json.load(f)
        if meta["craft"].get("input_mean") or meta["parseq"].get("input_mean"):
            raise ValueError("the reference feeds pixels / 255 with no mean or std")
        self.det = det
        self.device = torch.device(device)
        self.arch = meta["parseq"]
        self.charset = meta["charset"]
        self.block = block
        self.craft = CraftRef(load_npz(os.path.join(weights_dir, "craft.npz")), self.device,
                              craft_formats)
        self.parseq = ParseqRef(load_npz(os.path.join(weights_dir, "parseq.npz")), self.arch,
                                self.device, parseq_format)

    @classmethod
    def of_config(cls, weights_dir: str, cfg: Dict, device, control: Optional[Dict] = None
                  ) -> "Reference":
        """The reference of a configuration file (each CRAFT layer in the
        format of the precision its `precision` states), or with `control`
        (one of its `controls`) that control."""
        step = None if control is None else control["craft"]
        return cls(weights_dir, cfg["ocr"], device, layer_formats(cfg["precision"], step),
                   None if control is None else control["parseq"])

    def geometry(self, page: np.ndarray) -> Dict:
        return B.canvas_geometry(page.shape[0], page.shape[1], self.det)

    @torch.no_grad()
    def canvas(self, page: np.ndarray, g: Dict) -> torch.Tensor:
        """[h, w, 3] uint8 RGB -> [1, CH, CW, 3] fp32 BGR in [0, 1]: the page
        resized (bilinear, antialiased when it shrinks) and zero-padded."""
        x = torch.from_numpy(np.ascontiguousarray(page)).to(self.device).float()
        th, tw = g["resized"]
        if (th, tw) != page.shape[:2]:
            x = F.interpolate(x.permute(2, 0, 1)[None], size=(th, tw), mode="bilinear",
                              align_corners=False, antialias=True)[0].permute(1, 2, 0)
        ch, cw = g["canvas"]
        x = F.pad(x, (0, 0, 0, cw - tw, 0, ch - th)) / 255.0
        return x.flip(-1)[None]

    @torch.no_grad()
    def scores(self, page: np.ndarray) -> torch.Tensor:
        """CRAFT's score maps [h, w, 2] (region, affinity) of the page's canvas."""
        return self.scores_batch([page])[0]

    @torch.no_grad()
    def scores_batch(self, pages: List[np.ndarray]) -> torch.Tensor:
        """CRAFT's score maps [B, h, w, 2] of pages of one size, run as one
        batch: a quantized conv's activation scale spans them all."""
        g = self.geometry(pages[0])
        if any(p.shape != pages[0].shape for p in pages):
            raise ValueError("a batch's pages share one size")
        return self.craft.forward(torch.cat([self.canvas(p, g) for p in pages]))

    def boxes(self, page: np.ndarray, scores: torch.Tensor) -> np.ndarray:
        """-> the page's reported boxes [n, 4] int64 (x0, y0, x1, y1)."""
        g = self.geometry(page)
        s = scores.cpu().numpy()
        hm = B.heatmap_boxes(s[:, :, 0], s[:, :, 1], g["content"], self.det)
        return B.report_box(B.scale(hm, g["ratio"], self.det))

    @torch.no_grad()
    def crops(self, page: np.ndarray, bboxes: np.ndarray) -> torch.Tensor:
        """The recognizer's crops [n, 32, 128, 3] fp32 RGB in [0, 1] of the
        reported boxes: each box's window (from the heatmap box it came
        from) resampled, cv::resize INTER_LINEAR's half-pixel centres, the
        source clamped to the window."""
        g = self.geometry(page)
        h, w = page.shape[:2]
        hm = B.from_report_box(np.asarray(bboxes).reshape(-1, 4), g["ratio"], self.det)
        win = torch.from_numpy(B.crop_windows(B.scale(hm, g["ratio"], self.det), h, w))
        win = win.to(self.device)
        img = torch.from_numpy(np.ascontiguousarray(page)).to(self.device).float()
        oh, ow = self.arch["img_size"]
        x0, y0, x1, y1 = win.unbind(1)
        jj = (torch.arange(ow, device=self.device) + 0.5) / ow
        ii = (torch.arange(oh, device=self.device) + 0.5) / oh
        sx = torch.minimum(torch.maximum(x0[:, None] + jj * (x1 - x0)[:, None] - 0.5,
                                         x0[:, None]), (x1 - 1)[:, None])
        sy = torch.minimum(torch.maximum(y0[:, None] + ii * (y1 - y0)[:, None] - 0.5,
                                         y0[:, None]), (y1 - 1)[:, None])
        fy = (sy - torch.floor(sy))[..., None, None]
        ya = torch.floor(sy).long().clamp(0, h - 1)
        rows = img[ya] * (1 - fy) + img[(ya + 1).clamp(0, h - 1)] * fy   # [n, oh, w, 3]
        xa = torch.floor(sx)
        wa = torch.clamp(1 - (sx - xa).abs(), min=0)
        wb = torch.clamp(1 - (sx - xa - 1).abs(), min=0) * (xa + 1 < w)
        ia, ib = xa.long().clamp(0, w - 1), (xa.long() + 1).clamp(0, w - 1)
        n = rows.shape[0]
        ga = torch.gather(rows, 2, ia[:, None, :, None].expand(n, oh, ow, 3))
        gb = torch.gather(rows, 2, ib[:, None, :, None].expand(n, oh, ow, 3))
        return (ga * wa[:, None, :, None] + gb * wb[:, None, :, None]) / 255.0

    @torch.no_grad()
    def logits(self, page: np.ndarray, bboxes: np.ndarray) -> torch.Tensor:
        """The refined logits [n, T, C] of the crops of `bboxes`, in blocks."""
        out = []
        for i in range(0, len(bboxes), self.block):
            out.append(self.parseq.recognize(self.crops(page, bboxes[i:i + self.block])))
        if not out:
            return torch.zeros((0, self.parseq.T, self.arch["charset_size"] + 1))
        return torch.cat(out)

    def text(self, ids: List[int]) -> str:
        """Token ids -> the text up to the first EOS."""
        out = []
        for i in ids:
            if i == 0:
                break
            out.append(self.charset[i - 1])
        return "".join(out)

    @torch.no_grad()
    def read_page(self, page: np.ndarray) -> List[Dict]:
        """The whole pipeline, as the program reports a page: [{text,
        bbox, confidence}] in box order."""
        return self.read_scores(page, self.scores(page))

    @torch.no_grad()
    def read_scores(self, page: np.ndarray, scores: torch.Tensor) -> List[Dict]:
        """`read_page` from CRAFT's score maps on."""
        return self.read_boxes(page, self.boxes(page, scores))

    @torch.no_grad()
    def read_boxes(self, page: np.ndarray, bboxes: np.ndarray) -> List[Dict]:
        """What the recognizer reads in each reported box [n, 4] of the page:
        [{text, bbox, confidence}]."""
        lg = self.logits(page, bboxes)
        conf = confidence(lg).tolist() if len(lg) else []
        ids = lg.argmax(-1).tolist()
        return [{"text": self.text(i), "bbox": [float(v) for v in b], "confidence": c}
                for i, b, c in zip(ids, bboxes, conf)]
