"""The port's example programs (`tuatara_tpu_torch/examples/`), run with
`--device cpu` on the golden weights: `resume` (the reference's argv),
`table` (its fixed `./weights`, here a link in a scratch directory) and
`serve` at `--batch 2 --batches 1`, each holding what it prints to the
engine's records; and `python -m` of one, as a user starts them. With no
card and no `--device`, an example raises.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

import tuatara_tpu_torch
from tuatara_tpu_torch.examples import resume, serve, table
from tuatara_tpu_torch.utils.image import asset_path, load_image

from torch_common import GOLDEN, ROOT, torch_threads  # noqa: F401


def printed_records(out):
    """The records an example prints (one dict a line) and its box count."""
    lines = out.strip().splitlines()
    return [ast.literal_eval(line) for line in lines[:-1]], lines[-1]


def test_resume(capsys):
    assert resume.main([asset_path("resume_example.png"), GOLDEN, "--device", "cpu"]) == 0
    records, last = printed_records(capsys.readouterr().out)
    want = tuatara_tpu_torch.image_to_data(load_image(asset_path("resume_example.png")), GOLDEN,
                                           device="cpu")
    assert len(want) > 0 and records == want
    assert last == f"{len(want)} boxes"


def test_table_reads_its_fixed_weights_path(tmp_path, monkeypatch, capsys):
    os.symlink(GOLDEN, tmp_path / "weights")
    monkeypatch.chdir(tmp_path)
    assert table.main(["--device", "cpu"]) == 0
    records, last = printed_records(capsys.readouterr().out)
    want = tuatara_tpu_torch.image_to_data(load_image(asset_path("table_english.png")), GOLDEN,
                                           device="cpu")
    assert len(want) > 0 and records == want
    assert last == f"{len(want)} boxes"


def test_serve(capsys):
    page = asset_path("funsd_0001129658.png")
    assert serve.main([page, "--weights", GOLDEN, "--batch", "2", "--batches", "1", "--lines",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "run_stream: 2 pages in" in out and "pages/sec" in out
    assert "engine.stats: {'pages': 4, 'batches': 2" in out  # the warm-up batch and the stream


def test_python_m_and_no_card():
    proc = subprocess.run([sys.executable, "-m", "tuatara_tpu_torch.examples.resume",
                           asset_path("resume_example.png"), GOLDEN, "--device", "cpu"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].endswith(" boxes")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resume.main([asset_path("resume_example.png"), GOLDEN])
