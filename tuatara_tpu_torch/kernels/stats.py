"""Component statistics kernel K3.

`component_stats_nopeak` launches `csrc/stats.cu` for CUDA tensors and runs
the plain version below for CPU tensors. It replaces the Pallas kernel
`component_stats_nopeak` (tuatara_tpu/ops/pallas/stats.py:172).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry
from tuatara_tpu_torch.kernels.cc import _check_2d, _raise_on

K3 = "component_stats_nopeak"


def component_stats_nopeak_plain(labels: torch.Tensor, keep: torch.Tensor,
                                 roots: torch.Tensor, chunk: int = 32
                                 ) -> Tuple[torch.Tensor, ...]:
    """One-hot form, as the TPU kernel computes it: member[y, x, k] =
    labels[y, x] == roots[k]; counts are its sums over x (rows) and y
    (columns), for all pixels and for the `keep` pixels."""
    h, w = labels.shape
    k = roots.shape[0]
    outs = [torch.zeros((n, k), dtype=torch.float32, device=labels.device)
            for n in (h, w, h, w)]
    row, col, rrow, rcol = outs
    kp = keep.bool()[:, :, None]
    for s in range(0, k, chunk):
        member = labels[:, :, None] == roots[None, None, s:s + chunk]
        reduced = member & kp
        row[:, s:s + chunk] = member.sum(1, dtype=torch.float32)
        col[:, s:s + chunk] = member.sum(0, dtype=torch.float32)
        rrow[:, s:s + chunk] = reduced.sum(1, dtype=torch.float32)
        rcol[:, s:s + chunk] = reduced.sum(0, dtype=torch.float32)
    return row, col, rrow, rcol


def component_stats_nopeak(labels: torch.Tensor, keep: torch.Tensor,
                           roots: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """labels [H, W] int32, keep [H, W] bool, roots [K] int32 ->
    (row [H, K], col [W, K], rrow [H, K], rcol [W, K]) fp32 counts."""
    if not labels.is_cuda:
        return component_stats_nopeak_plain(labels, keep, roots)
    _check_2d(labels, torch.int32, "labels")
    _check_2d(keep, torch.bool, "keep")
    if roots.dim() != 1 or roots.dtype != torch.int32 or not roots.is_contiguous():
        raise ValueError(f"roots: expected a contiguous 1-D int32 tensor, got "
                         f"{tuple(roots.shape)} {roots.dtype}")
    if keep.shape != labels.shape or keep.device != labels.device \
            or roots.device != labels.device:
        raise ValueError("labels, keep and roots must share shape and device")
    h, w = labels.shape
    k = roots.shape[0]
    dev = labels.device
    row = torch.empty((h, k), dtype=torch.float32, device=dev)
    rrow = torch.empty_like(row)
    col = torch.empty((w, k), dtype=torch.float32, device=dev)
    rcol = torch.empty_like(col)
    slot = torch.empty(h * w, dtype=torch.int32, device=dev)
    fn = entry("stats", "tt_component_stats_nopeak", 8, 3)
    err = fn(labels.data_ptr(), keep.data_ptr(), roots.data_ptr(), slot.data_ptr(),
             row.data_ptr(), col.data_ptr(), rrow.data_ptr(), rcol.data_ptr(),
             h, w, k, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "tt_component_stats_nopeak")
    LAUNCHES[K3] += 1
    return row, col, rrow, rcol
