"""Reading the committed weight directories.

Own copy of the loaders in `tuatara_tpu/utils/weights.py`: one npz per model
(`craft.npz`, `parseq.npz`) whose keys are '/'-joined parameter-tree paths
(list entries by index), plus an optional `config.json` holding the
architecture configs and the charset. The trees come back as nested dicts
and lists of numpy arrays in the JAX package's layout; `tuatara_tpu_torch.
weights` maps them onto the port's modules.

The writers (`flatten_tree`, `save_params`, `save_weights_dir`) write the
same files from such trees, so a directory either package writes loads in
the other.

`calibration.npz` holds int8 serving's calibrated activation scales under
the JAX package's keys (`craft/vgg/conv1_2/conv/sx`,
`craft/up/upconv1/conv1a/sx`, `parseq/...`), so a file saved by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from tuatara_tpu_torch.config import CraftConfig, ParseqConfig

CRAFT_FILE = "craft.npz"
PARSEQ_FILE = "parseq.npz"
CONFIG_FILE = "config.json"
CALIB_FILE = "calibration.npz"


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists -> {'/'-joined path: array}; list entries by
    index (JAX `flatten_tree`)."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


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


def save_params(path: str, params: Any) -> None:
    np.savez(path, **flatten_tree(params))


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


def save_weights_dir(weights_dir: str, craft_params: Any, parseq_params: Any,
                     craft_config: Any = None, parseq_config: Any = None,
                     charset: "str | None" = None) -> None:
    """Write `craft.npz` and `parseq.npz` from the two trees and, when any
    is given, `config.json` with the architecture configs and the charset
    the recognizer was trained with, as JAX `save_weights_dir` writes
    them: an engine of either package then builds the matching models and
    decode table from the directory alone."""
    os.makedirs(weights_dir, exist_ok=True)
    save_params(os.path.join(weights_dir, CRAFT_FILE), craft_params)
    save_params(os.path.join(weights_dir, PARSEQ_FILE), parseq_params)
    if craft_config is None and parseq_config is None and charset is None:
        return
    meta: Dict[str, Any] = {}
    if craft_config is not None:
        meta["craft"] = dataclasses.asdict(craft_config)
    if parseq_config is not None:
        meta["parseq"] = dataclasses.asdict(parseq_config)
    if charset is not None:
        meta["charset"] = charset
    with open(os.path.join(weights_dir, CONFIG_FILE), "w") as f:
        json.dump(meta, f, indent=1)


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


def save_calibration(path: str, craft, parseq=None) -> int:
    """Write the calibrated scales of a quantized `Craft` (its QConvs' sx)
    and, when its encoder is int8, of `parseq` (its QLinears' sx) to
    `path`, under `craft/<path>/sx` and `parseq/<path>/sx` -> the number
    written. Nothing calibrated: no file is written (an empty one beside
    the weights would be loaded by every quantized engine)."""
    layers = [(f"craft/{name}", q) for name, q in craft.qconvs()]
    if parseq is not None:
        layers += [(f"parseq/{name}", q) for name, q in parseq.qlinears()]
    flat = {f"{name}/sx": np.asarray(q.sx.cpu().numpy(), np.float32)
            for name, q in layers if q.sx is not None}
    if not flat:
        return 0
    np.savez(path, **flat)
    return len(flat)


def load_calibration(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """-> ({craft path: sx}, {parseq path: sx}), paths relative to each
    model's root (`vgg/conv1_2/conv/sx`)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    craft = {k[len("craft/"):]: v for k, v in flat.items() if k.startswith("craft/")}
    parseq = {k[len("parseq/"):]: v for k, v in flat.items() if k.startswith("parseq/")}
    return craft, parseq


def apply_static_scales(model, scales: Dict[str, np.ndarray]) -> int:
    """Set each QConv's or QLinear's sx by its '/'-joined path -> the
    number set. A path that lands on no quantized layer raises KeyError:
    the file was saved under another architecture or quantization."""
    import torch

    from tuatara_tpu_torch.models.layers import QConv, QLinear

    for key, val in scales.items():
        parts = key.split("/")
        try:
            if parts[-1] != "sx":
                raise AttributeError(parts[-1])
            q = model.get_submodule(".".join(parts[:-1]))
        except AttributeError as e:
            raise KeyError(f"calibration path {key!r} not found in the quantized model "
                           f"({e})") from None
        if not isinstance(q, (QConv, QLinear)):
            raise KeyError(f"calibration path {key!r} is not a quantized layer")
        q.sx = torch.tensor(np.float32(val), device=q.wq.device)
    return len(scales)
