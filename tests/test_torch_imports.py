"""Import rule of the port: no module of `tuatara_tpu_torch/`, and not
`chip_smoke.py`, imports `jax` or the JAX package `tuatara_tpu` (the GPU
machine has neither); CUDA builds happen at first use, not at import."""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(ROOT, "tuatara_tpu_torch", "**", "*.py"),
                         recursive=True)) + [os.path.join(ROOT, "chip_smoke.py")]
FORBIDDEN = ("jax", "jaxlib", "tuatara_tpu", "PIL", "cv2")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{os.path.relpath(path, ROOT)} imports {mod}"


def test_port_has_modules():
    names = {os.path.relpath(p, ROOT) for p in FILES}
    for want in ("tuatara_tpu_torch/api.py", "tuatara_tpu_torch/kernels/cc.py",
                 "tuatara_tpu_torch/kernels/stats.py", "tuatara_tpu_torch/ops/boxes.py",
                 "tuatara_tpu_torch/kernels/vit.py", "tuatara_tpu_torch/kernels/decode.py",
                 "tuatara_tpu_torch/kernels/stage1.py", "tuatara_tpu_torch/kernels/int8.py",
                 "tuatara_tpu_torch/models/craft.py",
                 "tuatara_tpu_torch/utils/metrics.py", "tuatara_tpu_torch/kernels/hull.py",
                 "tuatara_tpu_torch/ops/minarearect.py", "tuatara_tpu_torch/ops/tiling.py"):
        assert want in names


def test_package_imports_without_building():
    import tuatara_tpu_torch  # noqa: F401
    from tuatara_tpu_torch.kernels import _build

    assert not _build._libs
