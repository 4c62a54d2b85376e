"""Connected-component kernels K1 (labels + aux min), K4 (labels only) and
K2 (area filter).

`label_components_aux`, `label_components` and `area_ok` launch
`csrc/cc.cu` for CUDA tensors and run the plain versions of
`ops/connected_components.py` for CPU tensors. They replace the Pallas
kernels `label_components_pallas_aux` (tuatara_tpu/ops/pallas/cc.py:213),
`label_components_pallas` (cc.py:89) and `area_ok_pallas` (cc.py:146).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tuatara_tpu_torch.kernels import LAUNCHES
from tuatara_tpu_torch.kernels._build import entry
from tuatara_tpu_torch.ops import connected_components as plain

K1 = "label_components_aux"
K2 = "area_ok"
K4 = "label_components"


def _check_2d(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dim() != 2 or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 2-D {dtype} tensor, "
                         f"got {tuple(t.shape)} {t.dtype}")


def _raise_on(err: int, symbol: str) -> None:
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: CUDA error {err}")


def label_components_aux(mask: torch.Tensor, aux: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask, aux [H, W] bool -> (labels, auxmin) [H, W] int32: labels are the
    component's smallest raster index (-1 background); auxmin is the smallest
    raster index of the component's aux pixels, 2**30 where there is none."""
    if not mask.is_cuda:
        return plain.label_components_aux(mask, aux)
    _check_2d(mask, torch.bool, "mask")
    _check_2d(aux, torch.bool, "aux")
    if aux.shape != mask.shape or aux.device != mask.device:
        raise ValueError("mask and aux must share shape and device")
    h, w = mask.shape
    labels = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    auxmin = torch.empty_like(labels)
    fn = entry("cc", "tt_label_components_aux", 4, 2)
    err = fn(mask.data_ptr(), aux.data_ptr(), labels.data_ptr(), auxmin.data_ptr(),
             h, w, torch.cuda.current_stream(mask.device).cuda_stream)
    _raise_on(err, "tt_label_components_aux")
    LAUNCHES[K1] += 1
    return labels, auxmin


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """mask [H, W] bool -> labels [H, W] int32: each component's smallest
    raster index, -1 on background. JAX's kernel also returns the number
    of sweeps it ran; union-find has no sweeps, so there is none here."""
    if not mask.is_cuda:
        return plain.label_components(mask)
    _check_2d(mask, torch.bool, "mask")
    h, w = mask.shape
    labels = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    fn = entry("cc", "tt_label_components", 2, 2)
    err = fn(mask.data_ptr(), labels.data_ptr(), h, w,
             torch.cuda.current_stream(mask.device).cuda_stream)
    _raise_on(err, "tt_label_components")
    LAUNCHES[K4] += 1
    return labels


MIN_AREA_RANGE = (1, 16)  # K2's window is (2m-1)^2; JAX's gate (ops/boxes.py:164)


def area_ok(labels: torch.Tensor, min_area: int) -> torch.Tensor:
    """labels [H, W] int32 -> [H, W] bool: component area >= min_area, for
    1 <= min_area <= 16 (ValueError outside: `ops/boxes.extract_boxes` takes
    the plain area count there, as JAX's XLA path does)."""
    lo, hi = MIN_AREA_RANGE
    if not lo <= min_area <= hi:
        raise ValueError(f"area_ok: min_area {min_area} outside {lo}..{hi}")
    if not labels.is_cuda:
        return plain.area_ok(labels, min_area)
    _check_2d(labels, torch.int32, "labels")
    h, w = labels.shape
    out = torch.empty((h, w), dtype=torch.bool, device=labels.device)
    fn = entry("cc", "tt_area_ok", 2, 3)
    err = fn(labels.data_ptr(), out.data_ptr(), h, w, int(min_area),
             torch.cuda.current_stream(labels.device).cuda_stream)
    _raise_on(err, "tt_area_ok")
    LAUNCHES[K2] += 1
    return out
