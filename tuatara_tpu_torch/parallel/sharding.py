"""Sharded inference programs (port of `tuatara_tpu/parallel/sharding.py`).

Both OCR stages are parallel over their batch: under a mesh, detection
splits the page batch over 'dp' and recognition splits the crop slab over
'dp', the models replicated on every rank (`OcrEngine(..., mesh=mesh)`
does both on its serving path). These helpers expose the same programs
for direct use.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from tuatara_tpu_torch.parallel.mesh import Mesh


def shard_pages(mesh: Mesh, pages):
    """This rank's contiguous 'dp' slice of a page batch [B, ...] (B a
    multiple of the dp size, as JAX's P("dp") placement requires), on the
    mesh's device."""
    dp, r = mesh.size("dp"), mesh.rank("dp")
    b = pages.shape[0]
    if b % dp:
        raise ValueError(f"batch {b} does not divide over dp = {dp}")
    n = b // dp
    pages = pages if isinstance(pages, torch.Tensor) else torch.as_tensor(pages)
    return pages[r * n:(r + 1) * n].to(mesh.device)


def sharded_ocr_programs(engine, mesh: Mesh, batch: int, h: int, w: int,
                         channels: int = 3) -> Tuple[Callable, Callable]:
    """(detect, recognize_for) of an engine built with `mesh=mesh`.

    detect(images [B, H, W, C] uint8, the whole batch on every rank) ->
    {"bbox", "rects", "valid", "count"} of the whole batch (each rank
    detects its pages, then the small outputs are gathered);
    recognize_for(bucket)(images, det["rects"], det["valid"]) -> (ids,
    conf) of the live crops in (page, slot) order, each rank recognizing
    its rows of the slab.

    `batch` must be a multiple of the dp size (`run_pages` pads to one).
    Collective: every rank of the mesh makes the same calls."""
    if engine.mesh is not mesh:
        raise ValueError("construct the engine with mesh=mesh: the engine's stages carry "
                         "their dp sharding themselves")
    dp = mesh.size("dp")
    if batch % dp:
        raise ValueError(f"batch {batch} does not divide over dp = {dp}")

    def detect(images):
        if tuple(images.shape[:3]) != (batch, h, w):
            raise ValueError(f"images {tuple(images.shape)} are not the program's "
                             f"[{batch}, {h}, {w}, {channels}]")
        return engine.detect(engine._to_device(images))

    def recognize_for(bucket: int):
        def recognize(images, rects, valid):
            return engine.recognize_slab(engine._to_device(images), rects, valid, bucket)

        return recognize

    return detect, recognize_for
