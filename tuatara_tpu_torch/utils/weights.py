"""Reading the committed weight directories.

Own copy of the loaders in `tuatara_tpu/utils/weights.py`: one npz per model
(`craft.npz`, `parseq.npz`) whose keys are '/'-joined parameter-tree paths
(list entries by index), plus an optional `config.json` holding the
architecture configs and the charset. The trees come back as nested dicts
and lists of numpy arrays in the JAX package's layout; `tuatara_tpu_torch.
weights` maps them onto the port's modules.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from tuatara_tpu_torch.config import CraftConfig, ParseqConfig

CRAFT_FILE = "craft.npz"
PARSEQ_FILE = "parseq.npz"
CONFIG_FILE = "config.json"


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    """'/'-joined paths -> nested dicts; integer-keyed levels become lists."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def to_lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [to_lists(node[str(i)]) for i in range(len(node))]
        return {k: to_lists(v) for k, v in node.items()}

    return to_lists(root)


def load_params(path: str) -> Any:
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def weights_available(weights_dir: str) -> bool:
    return (
        bool(weights_dir)
        and os.path.isfile(os.path.join(weights_dir, CRAFT_FILE))
        and os.path.isfile(os.path.join(weights_dir, PARSEQ_FILE))
    )


def load_weights_dir(weights_dir: str):
    """-> (craft tree, parseq tree) of numpy arrays."""
    if not weights_available(weights_dir):
        raise FileNotFoundError(
            f"weights_dir {weights_dir!r} must contain {CRAFT_FILE} and {PARSEQ_FILE}"
        )
    return (
        load_params(os.path.join(weights_dir, CRAFT_FILE)),
        load_params(os.path.join(weights_dir, PARSEQ_FILE)),
    )


def _listify(v):
    return tuple(_listify(x) for x in v) if isinstance(v, list) else v


def load_configs(weights_dir: str):
    """(CraftConfig | None, ParseqConfig | None, charset str | None) stored
    next to the weights."""
    path = os.path.join(weights_dir, CONFIG_FILE)
    if not os.path.isfile(path):
        return None, None, None
    with open(path) as f:
        meta = json.load(f)
    craft = parseq = None
    if "craft" in meta:
        craft = CraftConfig(**{k: _listify(v) for k, v in meta["craft"].items()})
    if "parseq" in meta:
        parseq = ParseqConfig(**{k: _listify(v) for k, v in meta["parseq"].items()})
    return craft, parseq, meta.get("charset")
