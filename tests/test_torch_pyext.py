"""The port's compiled binding `_pytuatara_torch`
(`tuatara_tpu_torch/csrc/capi/pytuatara_ext.c`) and its shim
`tuatara_tpu_torch.pytuatara`: the JAX package's binding contract
(`tests/test_pyext.py`'s `_assert_validation_contract`: the reference's
checks raised from C in their order) on the compiled module and on the
Python version, the compiled module equal to `_image_to_data_py` on the
golden weights (strided input too), and the shim calling the compiled
module.
"""

import sys

import numpy as np
import pytest
import torch

from tuatara_tpu_torch import capi, pytuatara

from test_pyext import _assert_validation_contract
from torch_common import GOLDEN, image, torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def compiled():
    return capi.load_pyext()


def test_compiled_module_is_the_ports(compiled):
    assert compiled.__name__ == "_pytuatara_torch"
    assert compiled.__file__.startswith(capi.BUILD_DIR)
    assert sys.modules["_pytuatara_torch"] is compiled


@pytest.mark.parametrize("impl", ["compiled", "python"])
def test_validation_contract(impl, compiled):
    fn = compiled.image_to_data if impl == "compiled" else pytuatara._image_to_data_py
    _assert_validation_contract(fn)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        fn(np.zeros((4, 4, 3), np.uint8), "/nonexistent_weights_dir", "o", "cpu")


def test_compiled_equals_python_version(compiled):
    page = image("funsd_0001129658")[:256, :256].copy()
    got = compiled.image_to_data(page, GOLDEN, "o", "cpu")
    want = pytuatara._image_to_data_py(page, GOLDEN, "o", "cpu")
    assert len(want) > 0 and got == want
    assert all(set(r) == {"text", "bbox"} for r in got)
    strided = page[:, ::2]
    assert not strided.flags["C_CONTIGUOUS"]
    assert (compiled.image_to_data(strided, GOLDEN, "o", "cpu")
            == pytuatara._image_to_data_py(np.ascontiguousarray(strided), GOLDEN, "o", "cpu"))


def test_shim_calls_the_compiled_module(compiled, monkeypatch):
    """`pytuatara.image_to_data` goes through the compiled module, which
    calls the shim's `_run`; the device argument reaches the engine, and
    none means the card."""
    calls = []
    run = pytuatara._run

    def spy(*args):
        calls.append(args[1:])
        return run(*args)

    monkeypatch.setattr(pytuatara, "_run", spy)
    page = image("resume_example")[:128, :160].copy()
    got = pytuatara.image_to_data(page, GOLDEN, "o", "cpu")
    assert calls == [(GOLDEN, "o", "cpu")]
    assert got == pytuatara._image_to_data_py(page, GOLDEN, "o", "cpu")
    with pytest.raises(TypeError, match="device"):
        pytuatara.image_to_data(page, GOLDEN, "o", 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pytuatara.image_to_data(page, GOLDEN, "o")
