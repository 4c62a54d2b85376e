"""Connected components of the binarized heatmap: plain PyTorch versions.

Port of `tuatara_tpu/ops/connected_components.py`. Contract (the same as the
JAX package, and as OpenCV's `connectedComponentsWithStats(..., 4)` label
order, tuatara.cpp:142):

* 4-connectivity; a foreground pixel's label is the smallest raster index
  of its component (its "root"), background is -1;
* `auxmin`: for each pixel, the smallest raster index of the component's
  aux pixels, exactly 2**30 on background and on components without one;
* roots are the K smallest raster indices of components that pass the
  filters, ascending, padded with 2**30.

These functions are the plain versions the CUDA kernels are held against
(`tuatara_tpu_torch/kernels/cc.py`); they run on any device. Labels are
found by min-label propagation between 4-neighbours plus pointer jumping
(label <- label[label]) until nothing changes. This always reaches the true
components: there is no sweep cap as in the JAX labeler.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BIG = 2**30


def _neighbour_min(lab: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """Min of each fg pixel's own label and its fg 4-neighbours' labels."""
    big = torch.full_like(lab, BIG)
    nb = torch.where(fg, lab, big)
    out = nb.clone()
    out[:, 1:] = torch.minimum(out[:, 1:], nb[:, :-1])
    out[:, :-1] = torch.minimum(out[:, :-1], nb[:, 1:])
    out[1:, :] = torch.minimum(out[1:, :], nb[:-1, :])
    out[:-1, :] = torch.minimum(out[:-1, :], nb[1:, :])
    return torch.where(fg, out, big)


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """[H, W] bool -> labels [H, W] int32 (root raster index, -1 background)."""
    h, w = mask.shape
    n = h * w
    fg = mask.bool()
    idx = torch.arange(n, device=mask.device, dtype=torch.int64).reshape(h, w)
    lab = torch.where(fg, idx, torch.full_like(idx, BIG))
    while True:
        new = _neighbour_min(lab, fg)
        flat = new.reshape(-1)
        ptr = torch.where(fg.reshape(-1), flat, torch.zeros_like(flat))
        new = torch.where(fg.reshape(-1), flat[ptr], flat).reshape(h, w)
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(fg, lab, torch.full_like(lab, -1)).to(torch.int32)


def aux_min(labels: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """Per pixel: min raster index of its component's aux pixels (BIG if
    none, and on background)."""
    h, w = labels.shape
    n = h * w
    lab = labels.reshape(-1).to(torch.int64)
    fg = lab >= 0
    hot = fg & aux.reshape(-1).bool()
    idx = torch.arange(n, device=labels.device, dtype=torch.int64)
    per_root = torch.full((n + 1,), BIG, dtype=torch.int64, device=labels.device)
    per_root.scatter_reduce_(0, torch.where(hot, lab, torch.full_like(lab, n)),
                             torch.where(hot, idx, torch.full_like(idx, BIG)),
                             reduce="amin")
    out = torch.where(fg, per_root[lab.clamp(min=0)], torch.full_like(lab, BIG))
    return out.reshape(h, w).to(torch.int32)


def label_components_aux(mask: torch.Tensor, aux: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (labels, auxmin), both [H, W] int32 (see module docstring)."""
    labels = label_components(mask)
    return labels, aux_min(labels, aux)


def area_ok(labels: torch.Tensor, min_area: int) -> torch.Tensor:
    """[H, W] bool: the pixel's component has area >= min_area (False on
    background). One area histogram keyed by label, then a gather."""
    h, w = labels.shape
    n = h * w
    lab = labels.reshape(-1).to(torch.int64)
    fg = lab >= 0
    tgt = torch.where(fg, lab, torch.full_like(lab, n))
    area = torch.zeros(n + 1, dtype=torch.int32, device=labels.device)
    area.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))
    return (fg & (area[tgt] >= min_area)).reshape(h, w)


def _presence(tgt: torch.Tensor, pixels: torch.Tensor, n: int) -> torch.Tensor:
    """[n] bool per raster index: the component rooted there holds a pixel
    of `pixels` (a scatter-max keyed by root; background goes to slot n)."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=tgt.device)
    out.scatter_reduce_(0, tgt, pixels.to(torch.int32), reduce="amax")
    return out[:n] > 0


def component_roots_filtered(labels: torch.Tensor, max_components: int,
                             hot_min: Optional[torch.Tensor], area_ok_map: torch.Tensor,
                             hot: Optional[torch.Tensor] = None,
                             keep: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raster-first roots of the components that pass the filters.

    A component passes when its area is >= min_area (`area_ok_map`) and it
    holds a hot pixel. With `hot_min` (the aux channel of K1, the branch
    text_threshold >= low_text) that is `hot_min < 2**30`. Without it (the
    branch text_threshold < low_text, labels from K4) the component must
    hold a pixel of the `hot` mask and one of the `keep` mask, not
    necessarily the same one: the JAX package's `hot_implies_keep=False`.
    The filters run before the budget, so sub-threshold specks cannot use
    up box slots. Returns (roots [K] int32, number of raw components)."""
    h, w = labels.shape
    n = h * w
    flat = labels.reshape(-1)
    idx = torch.arange(n, device=labels.device, dtype=torch.int32)
    is_root = (flat >= 0) & (flat == idx)
    n_raw = is_root.sum()
    if hot_min is not None:
        present = hot_min.reshape(-1) < BIG
    else:
        fg = flat >= 0
        tgt = torch.where(fg, flat.long(), torch.full_like(flat, n, dtype=torch.long))
        present = (_presence(tgt, hot.reshape(-1) & fg, n)
                   & _presence(tgt, keep.reshape(-1) & fg, n))
    ok = is_root & area_ok_map.reshape(-1) & present
    scores = torch.where(ok, idx, torch.full_like(idx, BIG))
    k = min(max_components, n)
    # The k smallest passing indices, ascending: the set and order the JAX
    # package's two-stage top-k of the negated scores gives.
    roots = torch.topk(scores, k, largest=False, sorted=True).values.to(torch.int32)
    if k < max_components:
        roots = torch.cat([roots, torch.full((max_components - k,), BIG,
                                             dtype=torch.int32, device=labels.device)])
    return roots, n_raw
