"""The reference's Python binding contract on the port.

The reference's pybind11 module has one function,

    pytuatara.image_to_data(image, weights_dir, outputs_dir)
      -> [{"text": str, "bbox": [x0, y0, x1, y1]}]

and so has this module, with an optional fourth argument `device` (a torch
device name; None runs on the first CUDA card, and raises without one). As
in the reference (and the JAX package's `pytuatara.py`), the marshalling
layer is compiled: `image_to_data` calls the `_pytuatara_torch` extension
(`csrc/capi/pytuatara_ext.c`, built at the first call by `capi.py`), which
checks and copies the buffer in C and calls `_run` below for the engine.
`_image_to_data_py` is the same contract in Python, with the same checks in
the same order and the same exception types; the tests hold the compiled
path to it. `outputs_dir` is accepted and unused, as in the reference.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def _run(image, weights_dir: str, outputs_dir: str, device: Optional[str] = None
         ) -> List[Dict]:
    """The engine call that both bindings make, after checking the weights
    directory: the reference errors on weights it cannot load, so there is
    no random initialisation here. -> the engine's records (text, bbox,
    confidence)."""
    from tuatara_tpu_torch.api import image_to_data
    from tuatara_tpu_torch.utils.weights import weights_available

    if not weights_available(weights_dir):
        if os.path.isdir(weights_dir):
            raise FileNotFoundError(
                f"error loading models from {weights_dir!r}: expected craft.npz/parseq.npz")
        raise FileNotFoundError(f"weights_dir {weights_dir!r} does not exist")
    return image_to_data(image, weights_dir=weights_dir, outputs_dir=outputs_dir,
                         device=device)


def _image_to_data_py(image, weights_dir: str, outputs_dir: str,
                      device: Optional[str] = None) -> List[Dict]:
    """The binding in Python: the compiled module's checks, order and
    exception types (empty weights_dir, empty outputs_dir, the buffer
    protocol, ndim == 3, uint8), then `_run`."""
    if not weights_dir:
        raise ValueError("Please provide a value for weights_dir")
    if not outputs_dir:
        raise ValueError("Please provide a value for outputs_dir")
    try:
        view = memoryview(image)
    except TypeError:
        raise TypeError("image must support the buffer protocol "
                        "(e.g. a numpy uint8 array)") from None
    if view.ndim != 3:
        raise ValueError("Input array should have 3 dimensions")
    if view.itemsize != 1 or view.format not in ("B", "b", None):
        raise TypeError("expected a uint8 image buffer (dtype uint8)")
    results = _run(np.ascontiguousarray(image).view(np.uint8), weights_dir, outputs_dir, device)
    return [{"text": r["text"], "bbox": r["bbox"]} for r in results]


def image_to_data(image, weights_dir: str, outputs_dir: str,
                  device: Optional[str] = None) -> List[Dict]:
    """OCR a [H, W, 3] uint8 image -> [{"text", "bbox"}], through the
    compiled binding (built at the first call)."""
    from tuatara_tpu_torch.capi import load_pyext

    return load_pyext().image_to_data(image, weights_dir, outputs_dir, device)
