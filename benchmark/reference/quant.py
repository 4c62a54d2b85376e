"""Number formats of the reference's convs and linear layers.

A layer that the configuration states in int8 runs in int8 here too, its
scales worked out again as the program's int8 path defines them; the
lower-precision control rounds each layer one format further down. Each
conv's or linear layer's operands are rounded, then multiplied in fp32.
The weights are scaled per output channel and the activation per tensor,
by its abs-max over the whole call (the batch included):

  "int8", "int4"  symmetric integers, the abs-max at 127 or 7
  "fp8"           float8 e4m3 (3 mantissa bits), the abs-max at 448
  None            fp32 as they are

int8 and fp8 stand one step below bf16, int4 one step below int8."""

from __future__ import annotations

from typing import Dict, Optional

import torch

FP8_MAX = 448.0

# The reference's format of a layer that the configuration states in a
# precision: int8 layers in int8, float layers in fp32.
PLAIN = {"int8": "int8", "bf16": None, "fp16": None, "fp32": None}


def _round(t: torch.Tensor, amax: torch.Tensor, kind: str) -> torch.Tensor:
    amax = torch.clamp(amax, min=1e-12)
    if kind == "fp8":
        s = FP8_MAX / amax
        return (t * s).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float() / s
    top = {"int8": 127, "int4": 7}[kind]
    s = amax / top
    return torch.clamp(torch.round(t / s), -top, top) * s


def round_operands(x: torch.Tensor, w: torch.Tensor, kind: Optional[str]):
    """-> (x, w) rounded to `kind` (None: as they are); w has its output
    channels first."""
    if kind is None:
        return x, w
    wa = w.abs().reshape(w.shape[0], -1).amax(1).reshape(-1, *([1] * (w.dim() - 1)))
    return _round(x, x.abs().amax(), kind), _round(w, wa, kind)


def layer_formats(precision: Dict[str, str], step: Optional[Dict] = None) -> Dict:
    """The configuration's `precision` (a layer's path, or "default", ->
    the precision it states) -> the reference's format a layer: PLAIN, or a
    control's `step` (a stated precision -> the format it runs in)."""
    table = PLAIN if step is None else step
    return {k: table[v] for k, v in precision.items()}
