"""Component statistics kernels K3 (counts) and K5 (counts + peak).

`component_stats_nopeak` and `component_stats` launch `csrc/stats.cu` for
CUDA tensors and run the plain versions below for CPU tensors. They
replace the Pallas kernels `component_stats_nopeak`
(tuatara_tpu/ops/pallas/stats.py:172) and `component_stats` (stats.py:120).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry, load
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


# The hash of csrc/stats.cu's table of roots, mirrored for the CPU model
# of the kernel and for the checks that choose colliding roots;
# `tt_stats_table_probe` gives the kernel's own answer.
HASH_MUL, STEP_MUL = 0x9E3779B1, 0x85EBCA6B


def table_bits(k: int) -> int:
    """log2 of the hash table's buckets for k roots: >= 2k, at least 256."""
    return max(8, (2 * k - 1).bit_length())


def table_probe(key: int, k: int, i: int = 0) -> int:
    """The i-th bucket a root probes in the table for k roots (i = 0: its
    home): double hashing, the top `table_bits(k)` bits of key * 2^32/phi
    plus i times an odd step from a second multiplier."""
    bits = table_bits(k)
    home = ((key * HASH_MUL) & 0xFFFFFFFF) >> (32 - bits)
    step = (((key * STEP_MUL) & 0xFFFFFFFF) >> (32 - bits)) | 1
    return (home + i * step) & ((1 << bits) - 1)


@functools.lru_cache(maxsize=64)
def _bands(h: int, w: int, k: int, peak: bool) -> int:
    """The row bands csrc/stats.cu splits an [h, w] image into for k roots
    (K5's partial rows). Raises ValueError for a k whose table and one
    column of counts do not fit one CTA's shared memory."""
    fn = load("stats").tt_component_stats_bands
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    bands = fn(h, w, k, int(peak))
    if bands < 1:
        raise ValueError(f"component stats: K = {k} roots do not fit one CTA's shared memory")
    return bands


def _outputs(labels: torch.Tensor, k: int, bands: int = 0) -> Tuple[torch.Tensor, ...]:
    """row [H, k], col [W, k], rrow, rcol and, with bands, peak [1, k] and
    K5's int32 partials [bands, k]: views of one uninitialised allocation
    (the kernel writes every entry), one allocator call a launch."""
    h, w = labels.shape
    sizes = [h, w, h, w] + ([1, bands] if bands else [])
    buf = torch.empty((sum(sizes), k), dtype=torch.float32, device=labels.device)
    return buf.split(sizes)


def component_stats_nopeak(labels: torch.Tensor, keep: torch.Tensor,
                           roots: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """labels [H, W] int32, keep [H, W] bool, roots [K] int32 ->
    (row [H, K], col [W, K], rrow [H, K], rcol [W, K]) fp32 counts. Roots
    below H*W must be unique, in any order; roots >= H*W are padding and
    count nothing."""
    if not labels.is_cuda:
        return component_stats_nopeak_plain(labels, keep, roots)
    _check_inputs(labels, keep, roots)
    h, w = labels.shape
    k = roots.shape[0]
    _bands(h, w, k, False)
    row, col, rrow, rcol = _outputs(labels, k)
    fn = entry("stats", "tt_component_stats_nopeak", 7, 3)
    err = fn(labels.data_ptr(), keep.data_ptr(), roots.data_ptr(),
             row.data_ptr(), col.data_ptr(), rrow.data_ptr(), rcol.data_ptr(),
             h, w, k, torch.cuda.current_stream(labels.device).cuda_stream)
    _raise_on(err, "tt_component_stats_nopeak")
    LAUNCHES[K3] += 1
    return row, col, rrow, rcol


def component_stats(labels: torch.Tensor, tn: torch.Tensor, keep: torch.Tensor,
                    roots: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """labels [H, W] int32, tn [H, W] fp32, keep [H, W] bool, roots [K]
    int32 -> (row, col, rrow, rcol, peak [K]) fp32: K3's counts and the max
    of tn over each root's pixels, -1e30 where a root has none. Roots as
    for `component_stats_nopeak`."""
    if not labels.is_cuda:
        return component_stats_plain(labels, tn, keep, roots)
    _check_inputs(labels, keep, roots)
    _check_2d(tn, torch.float32, "tn")
    if tn.shape != labels.shape or tn.device != labels.device:
        raise ValueError("labels and tn must share shape and device")
    h, w = labels.shape
    k = roots.shape[0]
    row, col, rrow, rcol, peak, partial = _outputs(labels, k, _bands(h, w, k, True))
    fn = entry("stats", "tt_component_stats", 10, 3)
    err = fn(labels.data_ptr(), tn.data_ptr(), keep.data_ptr(), roots.data_ptr(),
             partial.data_ptr(), row.data_ptr(), col.data_ptr(), rrow.data_ptr(),
             rcol.data_ptr(), peak.data_ptr(), h, w, k,
             torch.cuda.current_stream(labels.device).cuda_stream)
    _raise_on(err, "tt_component_stats")
    LAUNCHES[K5] += 1
    return row, col, rrow, rcol, peak[0]
