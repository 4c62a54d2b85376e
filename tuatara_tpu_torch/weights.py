"""Carry the JAX package's parameter trees over to the port's modules.

The committed weights (`craft.npz`, `parseq.npz`) hold the JAX layout:
conv kernels HWIO, linear weights [in, out], LayerNorm {scale, bias}, and
CRAFT's BatchNorms as separate {scale, bias, mean, var} entries. These
functions take such trees (numpy arrays) and return state dicts for
`models.craft.Craft` / `models.parseq.Parseq`. Conversion happens at load
time; no converted copy is written anywhere.

For training the carry-over runs both ways and folds nothing:
`module_leaves` lists a trainable module's leaves under their JAX paths
with their layouts, `load_tree` copies a JAX tree into the module (CRAFT's
BatchNorms as scale/bias parameters and mean/var buffers), and
`module_tree` / `module_flat` give the module back as JAX's tree, in
JAX's layouts (the recognizer head unpadded), which `utils.weights`
writes as either package's weights directory. `from_jax` / `to_jax` move
one array between the layouts, e.g. Adam's moments.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn


RSQRTPS_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                             "rsqrtps_table.npy")
_rsqrtps: List[np.ndarray] = []


def _fma32(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """fp32 a * b + c rounded once (the fp64 product of two fp32 values is
    exact; the fp64 sum can round onto a midpoint of fp32 in ~2^-29 of
    the cases, `ops.minarearect.fma`)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def xla_rsqrt(x: np.ndarray) -> np.ndarray:
    """fp32 1/sqrt(x) for positive normal x, as XLA's CPU backend computes
    `jax.lax.rsqrt` on x86: the `rsqrtps` estimate (`tests/gen_rsqrt_table.py`:
    a table of 2 x 1024 values, read by the exponent's parity and the top
    10 bits of the significand, read off an Intel CPU) and two Newton
    steps, y = fma(-y/2, fma(fp32(x * y), y, -1), y). Not correctly
    rounded (an ulp off on some inputs); bit-equal to XLA's on Intel x86
    hosts, whichever host computes it."""
    if not _rsqrtps:
        _rsqrtps.append(np.load(RSQRTPS_TABLE))
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32)
    e = (bits >> np.uint32(23)).astype(np.int64) - 127
    odd = e & 1
    y = _rsqrtps[0][odd * 1024 + ((bits >> np.uint32(13)) & np.uint32(1023))]
    y = np.ldexp(y.astype(np.float64), -((e - odd) // 2)).astype(np.float32)
    for _ in range(2):
        y = _fma32(y * np.float32(-0.5), _fma32(x * y, y, -1.0), y)
    return y


def fold_batchnorms(tree: Dict[str, Any], eps: float, xla: bool = False) -> Dict[str, Any]:
    """Fold every inference BatchNorm into its conv, as
    `tuatara_tpu/models/craft.py fold_batchnorms` does: w' = w * g and b' =
    (b - mean) * g + bias, in fp32. With `xla`, bit for bit as JAX folds on
    the CPU: g = scale * rsqrt(var + eps) by `xla_rsqrt`, and b' one fused
    multiply-add as XLA compiles it. int8 serving takes that fold: every
    int8 weight scale and every dynamic activation scale after it hangs on
    these bits (ROADMAP Queue 3 item 19). Without, g = scale / sqrt(var +
    eps) and b' two roundings, an ulp from JAX's on many channels; the
    float engines keep it (their bf16 casts drop most of that ulp, and the
    card's convolutions sum in other orders than XLA's anyway). Trees that
    are already folded come back unchanged."""
    if "bn" not in next(iter(tree["vgg"].values())):
        return tree

    def fold(conv, bn):
        scale, var = np.asarray(bn["scale"], np.float32), np.asarray(bn["var"], np.float32)
        w = np.asarray(conv["w"], np.float32)
        b = np.asarray(conv.get("b", np.float32(0)), np.float32) - np.asarray(bn["mean"],
                                                                             np.float32)
        shift = np.asarray(bn["bias"], np.float32)
        if xla:
            g = scale * xla_rsqrt(var + np.float32(eps))
            b = _fma32(b, g, shift)
        else:
            g = scale / np.sqrt(var + np.float32(eps))
            b = b * g + shift
        return {"w": (w * g[None, None, None, :]).astype(np.float32), "b": b.astype(np.float32)}

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
    if name == "w":  # conv HWIO -> OIHW, linear [in, out] -> [out, in]
        return "weight", from_jax(a, {4: "conv", 2: "linear"}.get(a.ndim, ""))
    # b -> bias, a LayerNorm's gain scale -> weight
    return {"b": "bias", "scale": "weight"}.get(name, name), from_jax(a, "")


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


def craft_state_dict(tree: Dict[str, Any], eps: float = 1e-5,
                     xla_fold: bool = False) -> Dict[str, torch.Tensor]:
    """CRAFT tree (BN folded or not) -> `Craft` state dict; `xla_fold`: fold
    as XLA does (`fold_batchnorms(xla=True)`, what int8 serving takes)."""
    return _state_dict(fold_batchnorms(tree, eps, xla_fold))


def parseq_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """PARSEQ tree -> `Parseq` state dict."""
    return _state_dict(tree)


# ---------------------------------------------------------------------------
# Trainable modules <-> JAX trees, both ways, no fold
# ---------------------------------------------------------------------------

def module_leaves(model: nn.Module) -> List[Tuple[str, torch.Tensor, str]]:
    """[(JAX path, tensor, layout)] of every leaf JAX's tree holds for
    `model`: Conv and Linear {w, b}, LayerNorm {scale, bias}, BatchNorm
    {scale, bias, mean, var}, and free parameters (`pos_embed`, ...) by
    name. Layout "conv" (OIHW here, HWIO in JAX), "linear" ([out, in]
    here, [in, out] in JAX) or "" (the same)."""
    from tuatara_tpu_torch.models.layers import BatchNorm, Conv, LayerNorm, Linear

    out: List[Tuple[str, torch.Tensor, str]] = []
    for name, m in model.named_modules():
        pre = name.replace(".", "/") + "/" if name else ""
        if isinstance(m, (Conv, Linear)):
            out += [(pre + "w", m.weight, "conv" if isinstance(m, Conv) else "linear"),
                    (pre + "b", m.bias, "")]
        elif isinstance(m, LayerNorm):
            out += [(pre + "scale", m.weight, ""), (pre + "bias", m.bias, "")]
        elif isinstance(m, BatchNorm):
            out += [(pre + "scale", m.weight, ""), (pre + "bias", m.bias, ""),
                    (pre + "mean", m.mean, ""), (pre + "var", m.var, "")]
        else:
            out += [(pre + n, p, "") for n, p in m.named_parameters(recurse=False)]
    return out


def to_jax(t: torch.Tensor, layout: str) -> np.ndarray:
    """A port tensor -> a new fp32 numpy array in JAX's layout."""
    a = t.detach().float().cpu().numpy()
    if layout == "conv":
        a = a.transpose(2, 3, 1, 0)
    elif layout == "linear":
        a = a.T
    return np.array(a, order="C")  # a copy: a CPU tensor's numpy() shares its memory


def from_jax(a: np.ndarray, layout: str) -> torch.Tensor:
    """A JAX-layout array -> a new fp32 CPU tensor in the port's layout."""
    a = np.asarray(a, np.float32)
    if layout == "conv":
        a = a.transpose(3, 2, 0, 1)
    elif layout == "linear":
        a = a.T
    return torch.from_numpy(np.array(a, order="C"))


def module_flat(model: nn.Module) -> Dict[str, np.ndarray]:
    """{JAX path: array in JAX's layout} of a trainable module."""
    return {path: to_jax(t, layout) for path, t, layout in module_leaves(model)}


def module_tree(model: nn.Module) -> Any:
    """A trainable module as JAX's nested tree of numpy arrays."""
    from tuatara_tpu_torch.utils.weights import unflatten_tree

    return unflatten_tree(module_flat(model))


@torch.no_grad()
def load_tree(model: nn.Module, tree: Any) -> nn.Module:
    """Copy a JAX tree (nested, or already flat by path) into a trainable
    module in place, folding nothing. Every leaf of the module must be in
    the tree with its shape, and the tree must hold nothing else."""
    from tuatara_tpu_torch.utils.weights import flatten_tree

    flat = flatten_tree(tree)  # a flat {path: array} comes back as it is
    leaves = module_leaves(model)
    missing = [p for p, _, _ in leaves if p not in flat]
    extra = sorted(set(flat) - {p for p, _, _ in leaves})
    if missing or extra:
        raise KeyError(f"tree does not match {type(model).__name__}: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for path, t, layout in leaves:
        src = from_jax(flat[path], layout)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)} in the tree, "
                             f"{tuple(t.shape)} in the model")
        t.copy_(src)
    return model
