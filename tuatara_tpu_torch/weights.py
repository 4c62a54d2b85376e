"""Carry the JAX package's parameter trees over to the port's modules.

The committed weights (`craft.npz`, `parseq.npz`) hold the JAX layout:
conv kernels HWIO, linear weights [in, out], LayerNorm {scale, bias}, and
CRAFT's BatchNorms as separate {scale, bias, mean, var} entries. These
functions take such trees (numpy arrays) and return state dicts for
`models.craft.Craft` / `models.parseq.Parseq`. Conversion happens at load
time; no converted copy is written anywhere.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def fold_batchnorms(tree: Dict[str, Any], eps: float) -> Dict[str, Any]:
    """Fold every inference BatchNorm into its conv, as
    `tuatara_tpu/models/craft.py fold_batchnorms` does: w' = w * g and
    b' = (b - mean) * g + bias with g = scale / sqrt(var + eps), in fp32.
    Trees that are already folded come back unchanged."""
    if "bn" not in next(iter(tree["vgg"].values())):
        return tree

    def fold(conv, bn):
        g = (np.asarray(bn["scale"], np.float32)
             / np.sqrt(np.asarray(bn["var"], np.float32) + np.float32(eps)))
        w = np.asarray(conv["w"], np.float32) * g[None, None, None, :]
        b = np.asarray(conv.get("b", np.float32(0)), np.float32)
        b = (b - np.asarray(bn["mean"], np.float32)) * g + np.asarray(bn["bias"], np.float32)
        return {"w": w.astype(np.float32), "b": b.astype(np.float32)}

    out = {"fc": tree["fc"], "head": tree["head"], "vgg": {}, "up": {}}
    for name, blk in tree["vgg"].items():
        out["vgg"][name] = {"conv": fold(blk["conv"], blk["bn"])}
    for name, blk in tree["up"].items():
        out["up"][name] = {"conv1": fold(blk["conv1"], blk["bn1"]),
                           "conv2": fold(blk["conv2"], blk["bn2"])}
    return out


def _leaf(name: str, value: np.ndarray):
    """JAX leaf name + array -> (torch parameter name, tensor)."""
    a = np.asarray(value, np.float32)
    if name == "w":
        if a.ndim == 4:  # conv HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:  # linear [in, out] -> [out, in]
            a = a.T
        return "weight", torch.from_numpy(np.ascontiguousarray(a))
    if name == "b":
        return "bias", torch.from_numpy(a.copy())
    if name == "scale":  # LayerNorm gain
        return "weight", torch.from_numpy(a.copy())
    return name, torch.from_numpy(a.copy())


def _state_dict(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_state_dict(v, f"{prefix}{k}."))
        else:
            name, t = _leaf(str(k), v)
            out[prefix + name] = t
    return out


def craft_state_dict(tree: Dict[str, Any], eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """CRAFT tree (BN folded or not) -> `Craft` state dict."""
    return _state_dict(fold_batchnorms(tree, eps))


def parseq_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """PARSEQ tree -> `Parseq` state dict."""
    return _state_dict(tree)
