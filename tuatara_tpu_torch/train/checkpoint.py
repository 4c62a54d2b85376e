"""Training checkpoint and resume (port of `tuatara_tpu/train/checkpoint.py`).

A checkpoint directory holds both models as JAX's weights directory
(`craft.npz`, `parseq.npz`, and `config.json` when the configs or a
charset are given), so either package's engine serves it as it is; the
optimizer state in `optimizer.npz`, keyed by JAX's parameter paths
(`mu/<path>`, `nu/<path>` in JAX's layouts, `count`); and the step count in
`meta.npz` (`step`), as JAX writes it. JAX stores its optimizer state
positionally against an optax tree structure (`opt_state.npz`), which the
port does not rebuild; the file here is the port's own. The Orbax backend
of the JAX package is not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from tuatara_tpu_torch.api import resolve_device
from tuatara_tpu_torch.train.trainer import (AdamW, TrainState, init_train_state,
                                             moments_from_jax, moments_to_jax, param_layouts)
from tuatara_tpu_torch.utils import weights as W
from tuatara_tpu_torch.weights import load_tree, module_tree

OPT_FILE = "optimizer.npz"
META_FILE = "meta.npz"


def save_checkpoint(ckpt_dir: str, state: TrainState, craft_config=None, parseq_config=None,
                    charset: "str | None" = None) -> None:
    """Write a train state; with the configs (and the charset of a
    retrained recognizer) the directory is an engine's weights_dir."""
    os.makedirs(ckpt_dir, exist_ok=True)
    W.save_weights_dir(ckpt_dir, module_tree(state.craft), module_tree(state.parseq),
                       craft_config=craft_config, parseq_config=parseq_config, charset=charset)
    layouts = param_layouts(craft=state.craft, parseq=state.parseq)
    np.savez(os.path.join(ckpt_dir, OPT_FILE), **moments_to_jax(state.opt_state, layouts))
    np.savez(os.path.join(ckpt_dir, META_FILE), step=np.asarray(state.step, np.int32))


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
