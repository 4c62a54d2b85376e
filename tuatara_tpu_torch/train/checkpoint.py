"""Training checkpoint and resume (port of `tuatara_tpu/train/checkpoint.py`).

A checkpoint directory holds both models as JAX's weights directory
(`craft.npz`, `parseq.npz`, and `config.json` when the configs or a
charset are given), so either package's engine serves it as it is; the
optimizer state in `optimizer.npz`, keyed by JAX's parameter paths
(`mu/<path>`, `nu/<path>` in JAX's layouts, `count`); and the step count in
`meta.npz` (`step`), as JAX writes it. JAX stores its optimizer state
positionally against an optax tree structure (`opt_state.npz`), which the
port does not rebuild; the file here is the port's own. A state on a mesh
is gathered whole and written by global rank 0 (every rank calls).

The sharded backend (JAX's Orbax one, `checkpoint.py:76-106`) saves a state
that lives on a mesh without gathering it: under `<dir>/sharded/`, the
ranks of dp coordinate 0 each write their tp shard of every tp-sharded
leaf (`tp<r>.npz`, JAX's layouts), tp rank 0 also the replicated leaves,
the step and Adam's count, grouped as JAX's step / craft / parseq / opt
(`step`, `craft/<path>`, `parseq/<path>`, `opt/mu/<model>/<path>`,
`opt/nu/...`, `opt/count`), and `meta.json` the tp size. A load assembles
each leaf from the files and slices it for the template's own layout: the
same mesh, another one (dp=2 -> tp=2), or a single device. The npz
checkpoint stays the canonical, servable format.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tuatara_tpu_torch.api import resolve_device
from tuatara_tpu_torch.train.trainer import (AdamW, TrainState, full_flat, init_train_state,
                                             leaf_spec, local_flat, moments_from_jax,
                                             moments_to_jax, param_layouts)
from tuatara_tpu_torch.utils import weights as W
from tuatara_tpu_torch.weights import from_jax, load_tree, module_leaves, module_tree

OPT_FILE = "optimizer.npz"
META_FILE = "meta.npz"


def save_checkpoint(ckpt_dir: str, state: TrainState, craft_config=None, parseq_config=None,
                    charset: "str | None" = None) -> None:
    """Write a train state; with the configs (and the charset of a
    retrained recognizer) the directory is an engine's weights_dir. A state
    on a mesh is gathered whole; global rank 0 writes, every rank calls."""
    if state.mesh is not None:
        flat = full_flat(state)
        if dist.get_rank() == 0:
            _save_flat(ckpt_dir, flat, state.step, craft_config, parseq_config, charset)
        dist.barrier()
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    W.save_weights_dir(ckpt_dir, module_tree(state.craft), module_tree(state.parseq),
                       craft_config=craft_config, parseq_config=parseq_config, charset=charset)
    layouts = param_layouts(craft=state.craft, parseq=state.parseq)
    np.savez(os.path.join(ckpt_dir, OPT_FILE), **moments_to_jax(state.opt_state, layouts))
    np.savez(os.path.join(ckpt_dir, META_FILE), step=np.asarray(state.step, np.int32))


def _save_flat(ckpt_dir, flat, step, craft_config, parseq_config, charset) -> None:
    def tree(prefix):
        return W.unflatten_tree({k[len(prefix):]: v for k, v in flat.items()
                                 if k.startswith(prefix)})

    os.makedirs(ckpt_dir, exist_ok=True)
    W.save_weights_dir(ckpt_dir, tree("craft/"), tree("parseq/"), craft_config=craft_config,
                       parseq_config=parseq_config, charset=charset)
    np.savez(os.path.join(ckpt_dir, OPT_FILE),
             **{k: v for k, v in flat.items() if k.startswith(("mu/", "nu/")) or k == "count"})
    np.savez(os.path.join(ckpt_dir, META_FILE), step=np.asarray(step, np.int32))


def load_checkpoint(ckpt_dir: str, template: Optional[TrainState] = None,
                    tx: Optional[AdamW] = None, device: Optional[str] = None) -> TrainState:
    """Restore a checkpoint into `template`'s models, in place, and return
    it. Without a template, one is built from the directory's config.json
    (the default configs where it has none) on `device` (None: the card)."""
    if template is None:
        craft_cfg, parseq_cfg, _ = W.load_configs(ckpt_dir)
        kwargs = {k: v for k, v in (("craft_cfg", craft_cfg), ("parseq_cfg", parseq_cfg))
                  if v is not None}
        template, _ = init_train_state(tx=tx, device=str(resolve_device(device)), **kwargs)
    craft_tree, parseq_tree = W.load_weights_dir(ckpt_dir)
    load_tree(template.craft, craft_tree)
    load_tree(template.parseq, parseq_tree)
    with np.load(os.path.join(ckpt_dir, OPT_FILE)) as z:
        flat = {k: z[k] for k in z.files}
    template.opt_state = moments_from_jax(flat, template.params(),
                                         param_layouts(craft=template.craft,
                                                       parseq=template.parseq))
    with np.load(os.path.join(ckpt_dir, META_FILE)) as z:
        template.step = int(z["step"])
    return template


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step a checkpoint directory was saved at, or None."""
    meta = os.path.join(ckpt_dir, META_FILE)
    if not os.path.isfile(meta):
        return None
    with np.load(meta) as z:
        return int(z["step"])


# ---------------------------------------------------------------------------
# The sharded backend
# ---------------------------------------------------------------------------

SHARDED_DIR = "sharded"


def _grouped(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """`local_flat` keys -> JAX's grouping: craft/..., parseq/..., opt/..."""
    return {(k if k.startswith(("craft/", "parseq/")) else f"opt/{k}"): v
            for k, v in flat.items()}


def save_checkpoint_sharded(ckpt_dir: str, state: TrainState) -> None:
    """Write `state`'s shards without gathering them (see the module
    docstring). Every rank of the state's mesh calls it; a state off a
    mesh is written as one shard."""
    mesh = state.mesh
    tp = 1 if mesh is None else mesh.size("tp")
    r = 0 if mesh is None else mesh.rank("tp")
    out = os.path.join(ckpt_dir, SHARDED_DIR)
    if mesh is None or mesh.rank("dp") == 0:
        os.makedirs(out, exist_ok=True)
        flat = _grouped(local_flat(state))
        mine = {k: v for k, v in flat.items() if r == 0 or "tp" in leaf_spec(k, v)}
        if r == 0:
            mine["step"] = np.asarray(state.step, np.int32)
        np.savez(os.path.join(out, f"tp{r}.npz"), **mine)
        if r == 0:
            with open(os.path.join(out, "meta.json"), "w") as f:
                json.dump({"tp": tp}, f)
    if mesh is not None:
        dist.barrier()


def load_checkpoint_sharded(ckpt_dir: str, template: TrainState) -> TrainState:
    """Restore a sharded checkpoint into `template` in place, for the
    template's own layout (its mesh, or none), and return it. Every leaf of
    the template must be in the checkpoint with its whole shape."""
    src = os.path.join(ckpt_dir, SHARDED_DIR)
    with open(os.path.join(src, "meta.json")) as f:
        tp_saved = json.load(f)["tp"]
    files = []
    for j in range(tp_saved):
        with np.load(os.path.join(src, f"tp{j}.npz")) as z:
            files.append({k: z[k] for k in z.files})
    mesh = template.mesh
    tp = 1 if mesh is None else mesh.size("tp")
    r = 0 if mesh is None else mesh.rank("tp")

    def piece(key: str) -> np.ndarray:
        if key not in files[0]:
            raise KeyError(f"sharded checkpoint has no {key!r}")
        spec = leaf_spec(key, files[0][key])
        if "tp" not in spec:
            return files[0][key]
        d = spec.index("tp")
        full = np.concatenate([f[key] for f in files], axis=d)
        n = full.shape[d] // tp
        return np.take(full, np.arange(r * n, (r + 1) * n), axis=d)

    layouts = param_layouts(craft=template.craft, parseq=template.parseq)
    with torch.no_grad():
        for name, m in (("craft", template.craft), ("parseq", template.parseq)):
            for path, t, layout in module_leaves(m):
                src_t = from_jax(piece(f"{name}/{path}"), layout)
                if tuple(src_t.shape) != tuple(t.shape):
                    raise ValueError(f"{name}/{path}: {tuple(src_t.shape)} in the checkpoint "
                                     f"for this layout, {tuple(t.shape)} in the template")
                t.copy_(src_t)
        for kind, moments in (("mu", template.opt_state.mu), ("nu", template.opt_state.nu)):
            for key, t in moments.items():
                t.copy_(from_jax(piece(f"opt/{kind}/{key}"), layouts[key]))
    template.opt_state.count = int(files[0]["opt/count"])
    template.step = int(files[0]["step"])
    return template

