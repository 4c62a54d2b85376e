"""Without a CUDA card the run fails and prints no result: it never falls
back to the CPU. So does a checkout that holds only the benchmark."""

import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
ARGS = ["--workload", "latency.page-mixed", "--seed", str(2**31 + 9), "--seconds", "1",
        "--trace", "0"]


def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_fails_without_a_card():
    no_card()
    out = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 3 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_fails_with_the_benchmark_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], capture_output=True,
                         text=True, cwd=tmp_path, timeout=600)
    assert out.returncode != 0 and "\"correct\"" not in out.stdout
