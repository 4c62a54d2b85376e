"""Import rule of the port: no module of `tuatara_tpu_torch/` (its training
included), and not `chip_smoke.py`, imports `jax`, `optax` or the JAX
package `tuatara_tpu` (the GPU machine has none of them); CUDA builds happen
at first use, not at import. PIL and cv2 are not imported either, but for
PIL inside the functions of `utils/data.py` that render text, as the JAX
package imports it there: the card's machine needs no PIL."""

import ast
import glob
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(ROOT, "tuatara_tpu_torch", "**", "*.py"),
                         recursive=True)) + [os.path.join(ROOT, "chip_smoke.py"),
                                             os.path.join(ROOT, "tests", "torch_surrogates.py")]
FORBIDDEN = ("jax", "jaxlib", "optax", "tuatara_tpu", "PIL", "cv2")
C_SOURCES = sorted(glob.glob(os.path.join(ROOT, "tuatara_tpu_torch", "csrc", "capi", "*.c*")))
# The Python a C source runs: the string literals passed to PyImport_* and PyRun_*.
C_PYTHON = re.compile(r'(PyImport_\w+|PyRun_\w+)\s*\(\s*((?:"(?:[^"\\]|\\.)*"\s*)+)')
# jax, the JAX package (not the port), and the JAX package's shim `pytuatara`.
C_FORBIDDEN = re.compile(r"\bjax|\btuatara_tpu(?!_torch)|(?<![\w.])pytuatara\b")
RENDERING = os.path.join(ROOT, "tuatara_tpu_torch", "utils", "data.py")


def _imports(path):
    """(module, inside a function) for every absolute import of a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    funcs = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    inner = {id(n) for f in funcs for n in ast.walk(f)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in inner
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module, id(node) in inner


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    for mod, in_function in _imports(path):
        top = mod.split(".")[0]
        if top == "PIL" and in_function and path == RENDERING:
            continue
        assert top not in FORBIDDEN, f"{os.path.relpath(path, ROOT)} imports {mod}"


@pytest.mark.parametrize("path", C_SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_c_sources_import_no_jax(path):
    """The C ABI and the compiled binding import and run Python by name:
    none of those names is jax, the JAX package or its shim."""
    with open(path) as f:
        source = f.read()
    calls = C_PYTHON.findall(source)
    if "Python.h" in source:  # the C ABI and the binding
        assert calls, f"{os.path.relpath(path, ROOT)}: no PyImport_/PyRun_ call found"
    for fn, literal in calls:
        assert not C_FORBIDDEN.search(literal), f"{os.path.relpath(path, ROOT)}: {fn}({literal})"


def test_c_source_rule_catches_the_jax_package():
    """The rule above flags the JAX package's own C sources."""
    for name in ("tuatara_capi.cpp", "pytuatara_ext.c"):
        with open(os.path.join(ROOT, "native", name)) as f:
            assert any(C_FORBIDDEN.search(lit) for _, lit in C_PYTHON.findall(f.read())), name


def test_port_has_modules():
    names = {os.path.relpath(p, ROOT) for p in FILES}
    for want in ("tuatara_tpu_torch/api.py", "tuatara_tpu_torch/kernels/cc.py",
                 "tuatara_tpu_torch/kernels/stats.py", "tuatara_tpu_torch/ops/boxes.py",
                 "tuatara_tpu_torch/kernels/vit.py", "tuatara_tpu_torch/kernels/decode.py",
                 "tuatara_tpu_torch/kernels/stage1.py", "tuatara_tpu_torch/kernels/int8.py",
                 "tuatara_tpu_torch/models/craft.py",
                 "tuatara_tpu_torch/utils/metrics.py", "tuatara_tpu_torch/kernels/hull.py",
                 "tuatara_tpu_torch/ops/minarearect.py", "tuatara_tpu_torch/ops/tiling.py",
                 "tuatara_tpu_torch/cli.py", "tuatara_tpu_torch/__main__.py",
                 "tuatara_tpu_torch/ops/grouping.py", "tuatara_tpu_torch/utils/data.py",
                 "tuatara_tpu_torch/utils/image.py", "tuatara_tpu_torch/utils/weights.py",
                 "tuatara_tpu_torch/train/__init__.py", "tuatara_tpu_torch/train/losses.py",
                 "tuatara_tpu_torch/train/trainer.py", "tuatara_tpu_torch/train/checkpoint.py",
                 "tuatara_tpu_torch/train/run.py", "tuatara_tpu_torch/utils/convert.py",
                 "tuatara_tpu_torch/convert.py", "tuatara_tpu_torch/utils/profiling.py",
                 "tuatara_tpu_torch/native.py", "tuatara_tpu_torch/parallel/__init__.py",
                 "tuatara_tpu_torch/parallel/mesh.py", "tuatara_tpu_torch/parallel/sharding.py",
                 "tuatara_tpu_torch/parallel/tensor.py", "tests/torch_surrogates.py",
                 "tuatara_tpu_torch/capi.py", "tuatara_tpu_torch/pytuatara.py",
                 "tuatara_tpu_torch/examples/resume.py", "tuatara_tpu_torch/examples/table.py",
                 "tuatara_tpu_torch/examples/serve.py", "tuatara_tpu_torch/_hostbuild.py"):
        assert want in names


def test_package_imports_without_building():
    import tuatara_tpu_torch  # noqa: F401
    from tuatara_tpu_torch.kernels import _build

    assert not _build._libs


def test_training_imports_without_jax_optax_or_pil():
    """The training modules import in a fresh interpreter that cannot load
    jax, optax or PIL."""
    import subprocess
    import sys

    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'optax', 'PIL', 'tuatara_tpu'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import tuatara_tpu_torch.train.run, tuatara_tpu_torch.train.checkpoint\n"
            "import tuatara_tpu_torch.utils.data, tuatara_tpu_torch.utils.weights\n"
            "from tuatara_tpu_torch.utils.data import detection_batch\n"
            "import numpy as np\n"
            "assert detection_batch(1, np.random.default_rng(0), 64)['pages'].shape == (1, 64, 64, 3)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_slice_12_modules_import_without_jax():
    """The converter, its command line, profiling, the native binding, the
    mesh modules, the engine, training and chip_smoke.py's surrogate
    replicas import in a fresh interpreter that cannot load jax, optax,
    PIL, cv2 or the JAX package."""
    import subprocess
    import sys

    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'optax', 'PIL', 'cv2',\n"
            "                                  'tuatara_tpu'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "sys.path.insert(0, 'tests')\n"
            "import tuatara_tpu_torch.utils.convert, tuatara_tpu_torch.convert\n"
            "import tuatara_tpu_torch.utils.profiling, tuatara_tpu_torch.native\n"
            "import tuatara_tpu_torch.parallel, tuatara_tpu_torch.parallel.tensor\n"
            "import tuatara_tpu_torch.api, tuatara_tpu_torch.train.trainer\n"
            "import tuatara_tpu_torch.train.checkpoint, tuatara_tpu_torch.train.losses\n"
            "import torch_surrogates\n"
            "import tuatara_tpu_torch.capi, tuatara_tpu_torch.pytuatara\n"
            "import tuatara_tpu_torch.examples.resume, tuatara_tpu_torch.examples.table\n"
            "import tuatara_tpu_torch.examples.serve\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
