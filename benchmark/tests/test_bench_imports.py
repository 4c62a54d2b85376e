"""No module under benchmark/ imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "tuatara_tpu"}
SOURCES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_names_compared_whole():
    assert "tuatara_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax.numpy".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"tuatara_tpu_torch"})


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path[:0] = [%r]; import reference.pipeline, reference.quant; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tuatara_tpu', 'tuatara_tpu_torch'}); "
            "print(bad); sys.exit(1 if bad else 0)" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=BENCH, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
