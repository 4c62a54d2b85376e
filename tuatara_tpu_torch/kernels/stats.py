"""Component statistics kernels K3 (counts) and K5 (counts + peak).

`component_stats_nopeak` and `component_stats` launch `csrc/stats.cu` for
CUDA tensors and run the plain versions below for CPU tensors. They
replace the Pallas kernels `component_stats_nopeak`
(tuatara_tpu/ops/pallas/stats.py:172) and `component_stats` (stats.py:120).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry
from tuatara_tpu_torch.kernels.cc import _check_2d, _raise_on

K3 = "component_stats_nopeak"
K5 = "component_stats"
EMPTY_PEAK = -1e30  # a slot's peak when no pixel belongs to it, as in JAX


def _stats_plain(labels: torch.Tensor, keep: torch.Tensor, roots: torch.Tensor,
                 tn: Optional[torch.Tensor], chunk: int = 32) -> Tuple[torch.Tensor, ...]:
    """One-hot form, as the TPU kernels compute it: member[y, x, k] =
    labels[y, x] == roots[k]; counts are its sums over x (rows) and y
    (columns), for all pixels and for the `keep` pixels; with `tn`, the
    peak is max(where(member, tn, -1e30)) over the image."""
    h, w = labels.shape
    k = roots.shape[0]
    outs = [torch.zeros((n, k), dtype=torch.float32, device=labels.device)
            for n in (h, w, h, w)]
    row, col, rrow, rcol = outs
    kp = keep.bool()[:, :, None]
    if tn is not None:
        peak = torch.full((k,), EMPTY_PEAK, dtype=torch.float32, device=labels.device)
    for s in range(0, k, chunk):
        member = labels[:, :, None] == roots[None, None, s:s + chunk]
        reduced = member & kp
        row[:, s:s + chunk] = member.sum(1, dtype=torch.float32)
        col[:, s:s + chunk] = member.sum(0, dtype=torch.float32)
        rrow[:, s:s + chunk] = reduced.sum(1, dtype=torch.float32)
        rcol[:, s:s + chunk] = reduced.sum(0, dtype=torch.float32)
        if tn is not None:
            vals = torch.where(member, tn.float()[:, :, None],
                               torch.full_like(member, EMPTY_PEAK, dtype=torch.float32))
            peak[s:s + chunk] = vals.amax((0, 1))
    return (row, col, rrow, rcol) if tn is None else (row, col, rrow, rcol, peak)


def component_stats_nopeak_plain(labels: torch.Tensor, keep: torch.Tensor,
                                 roots: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K3's plain version: (row, col, rrow, rcol)."""
    return _stats_plain(labels, keep, roots, None)


def component_stats_plain(labels: torch.Tensor, tn: torch.Tensor, keep: torch.Tensor,
                          roots: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K5's plain version: (row, col, rrow, rcol, peak)."""
    return _stats_plain(labels, keep, roots, tn)


def _check_inputs(labels: torch.Tensor, keep: torch.Tensor, roots: torch.Tensor) -> None:
    _check_2d(labels, torch.int32, "labels")
    _check_2d(keep, torch.bool, "keep")
    if roots.dim() != 1 or roots.dtype != torch.int32 or not roots.is_contiguous():
        raise ValueError(f"roots: expected a contiguous 1-D int32 tensor, got "
                         f"{tuple(roots.shape)} {roots.dtype}")
    if keep.shape != labels.shape or keep.device != labels.device \
            or roots.device != labels.device:
        raise ValueError("labels, keep and roots must share shape and device")


def _count_planes(labels: torch.Tensor, k: int) -> Tuple[torch.Tensor, ...]:
    """Empty (row, col, rrow, rcol) outputs and the [H*W] slot scratch."""
    h, w = labels.shape
    dev = labels.device
    row = torch.empty((h, k), dtype=torch.float32, device=dev)
    col = torch.empty((w, k), dtype=torch.float32, device=dev)
    return (row, col, torch.empty_like(row), torch.empty_like(col),
            torch.empty(h * w, dtype=torch.int32, device=dev))


def component_stats_nopeak(labels: torch.Tensor, keep: torch.Tensor,
                           roots: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """labels [H, W] int32, keep [H, W] bool, roots [K] int32 ->
    (row [H, K], col [W, K], rrow [H, K], rcol [W, K]) fp32 counts."""
    if not labels.is_cuda:
        return component_stats_nopeak_plain(labels, keep, roots)
    _check_inputs(labels, keep, roots)
    h, w = labels.shape
    k = roots.shape[0]
    row, col, rrow, rcol, slot = _count_planes(labels, k)
    fn = entry("stats", "tt_component_stats_nopeak", 8, 3)
    err = fn(labels.data_ptr(), keep.data_ptr(), roots.data_ptr(), slot.data_ptr(),
             row.data_ptr(), col.data_ptr(), rrow.data_ptr(), rcol.data_ptr(),
             h, w, k, torch.cuda.current_stream(labels.device).cuda_stream)
    _raise_on(err, "tt_component_stats_nopeak")
    LAUNCHES[K3] += 1
    return row, col, rrow, rcol


def component_stats(labels: torch.Tensor, tn: torch.Tensor, keep: torch.Tensor,
                    roots: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """labels [H, W] int32, tn [H, W] fp32, keep [H, W] bool, roots [K]
    int32 -> (row, col, rrow, rcol, peak [K]) fp32: K3's counts and the max
    of tn over each root's pixels, -1e30 where a root has none."""
    if not labels.is_cuda:
        return component_stats_plain(labels, tn, keep, roots)
    _check_inputs(labels, keep, roots)
    _check_2d(tn, torch.float32, "tn")
    if tn.shape != labels.shape or tn.device != labels.device:
        raise ValueError("labels and tn must share shape and device")
    h, w = labels.shape
    k = roots.shape[0]
    row, col, rrow, rcol, slot = _count_planes(labels, k)
    peak = torch.empty(k, dtype=torch.float32, device=labels.device)
    fn = entry("stats", "tt_component_stats", 10, 3)
    err = fn(labels.data_ptr(), tn.data_ptr(), keep.data_ptr(), roots.data_ptr(),
             slot.data_ptr(), row.data_ptr(), col.data_ptr(), rrow.data_ptr(),
             rcol.data_ptr(), peak.data_ptr(), h, w, k,
             torch.cuda.current_stream(labels.device).cuda_stream)
    _raise_on(err, "tt_component_stats")
    LAUNCHES[K5] += 1
    return row, col, rrow, rcol, peak
