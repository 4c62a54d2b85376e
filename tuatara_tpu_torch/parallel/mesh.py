"""Device meshes over torch.distributed (port of `tuatara_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a `jax.sharding.Mesh` with named
axes: 'dp' (data parallel: pages, crops and training batches split across
devices) and 'tp' (tensor parallel: the transformer's weights split, see
`train/trainer.py`). Here a mesh is the same grid over the ranks of an
initialized `torch.distributed` default group, one rank per device: rank r
sits at the row-major position r of the grid, and each axis has one
process group per line of ranks along it (`dist.new_group`), in which that
axis's collectives run.

Every rank builds the same mesh, in the same order, after
`torch.distributed.init_process_group` (`init_distributed` below, or
torchrun): NCCL on the card, gloo on the CPU. gloo also runs the
collectives the mesh paths use on CUDA tensors, so two ranks may share
one card (NCCL refuses that).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "tp")


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the grid: `shape` {axis: size}, its coordinate
    on each axis, the process group of each axis (None where the axis has
    size 1: nothing to communicate), and its device."""

    axis_names: Tuple[str, ...]
    devices: np.ndarray  # the grid of global ranks
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups.get(axis)


def init_distributed(rank: int, world_size: int, init_method: str,
                     backend: Optional[str] = None) -> None:
    """`dist.init_process_group` with the backend of the ranks' devices
    (None: NCCL when there is a card, gloo otherwise). `init_method` e.g.
    `tcp://localhost:29511` or `file:///path`."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    LOCAL_RANK), else its global rank."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def make_mesh(n_devices: Optional[int] = None, axes: Tuple[str, ...] = ("dp",),
              shape: Optional[Tuple[int, ...]] = None, device=None) -> Mesh:
    """A mesh over the ranks of the default process group (JAX's signature).
    With several axes and no `shape`, 'dp' takes every rank not consumed
    by the trailing axes, which default to 1. The shape's product must be
    the world size (`n_devices`, when given, must be too): ValueError
    otherwise. `device`: this rank's device (None: card `local_rank()`
    modulo the cards present; raises when there is none). Collective: every
    rank calls it with the same arguments."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed default group "
                           "(init_distributed or torchrun)")
    for a in axes:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r} (the axes are {AXES})")
    world = dist.get_world_size()
    n = n_devices or world
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name its axes {axes}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if n != world:
        raise ValueError(f"a mesh spans the whole default group: {n} devices, "
                         f"world size {world}")
    grid = np.arange(world).reshape(shape)
    me = dist.get_rank()
    pos = dict(zip(axes, (int(i) for i in np.argwhere(grid == me)[0])))
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for i, a in enumerate(axes):
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:  # every rank creates every group, in one order
            g = dist.new_group([int(r) for r in line]) if shape[i] > 1 else None
            if me in line:
                groups[a] = g
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to build a mesh on the CPU")
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return Mesh(tuple(axes), grid, pos, groups, torch.device(device))


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim` in the group's rank order
    (each rank's `t` of one shape), as one all-reduce of a zero-padded
    buffer: gloo runs all-reduce on CUDA tensors as NCCL does, and x + 0 is
    exact. bool tensors travel as uint8."""
    if group is None:
        return t
    size, r = dist.get_world_size(group), dist.get_rank(group)
    src = t.movedim(dim, 0)
    if t.dtype == torch.bool:
        src = src.to(torch.uint8)
    n = src.shape[0]
    out = src.new_zeros((size * n,) + tuple(src.shape[1:]))
    out[r * n:(r + 1) * n] = src
    dist.all_reduce(out, group=group)
    if t.dtype == torch.bool:
        out = out.bool()
    return out.movedim(0, dim)

