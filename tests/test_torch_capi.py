"""The port's C ABI (`tuatara_tpu_torch/csrc/capi/`, built by
`tuatara_tpu_torch/capi.py`), on the CPU through TUATARA_TORCH_DEVICE=cpu.

In process, the library joins this interpreter (ctypes) and must return
`image_to_data`'s records, 3 channels and gray, float32 as it stores them.
As a subprocess, the port's C example and the JAX package's
`native/capi_example.c` (compiled unchanged against the port's header and
library: the same ABI) start their own interpreter and print the same
lines. Without a card and without the variable, the call fails with "no
CUDA device" and does not fall back to the CPU. One live case holds the
C ABI to JAX's `image_to_data` on the golden weights.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

import tuatara_tpu_torch
from tuatara_tpu_torch import capi
from tuatara_tpu_torch.config import OcrConfig

from chip_smoke import example_lines, example_page
from torch_common import GOLDEN, ROOT, image, torch_threads  # noqa: F401

NATIVE_EXAMPLE = os.path.join(ROOT, "native", "capi_example.c")


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("TUATARA_TORCH_DEVICE", "cpu")


def as_stored(words):
    """Records as the C ABI stores them: float32 bbox and confidence."""
    return [{"text": w["text"], "bbox": [float(np.float32(v)) for v in w["bbox"]],
             "confidence": float(np.float32(w["confidence"]))} for w in words]


def test_build_names_targets_by_hash_and_reports_failures(tmp_path):
    lib, example = capi.build_library(), capi.build_example()
    assert os.path.basename(lib).startswith("libtuatara_capi-") and os.path.isfile(lib)
    assert os.path.dirname(example) == os.path.dirname(lib) == capi.BUILD_DIR
    assert capi.build_library() == lib  # reused, not rebuilt
    bad = tmp_path / "bad.c"
    bad.write_text("int main(void) { return undeclared; }\n")
    with pytest.raises(RuntimeError, match="undeclared"):
        capi.build_example(str(bad))


@pytest.mark.parametrize("channels", [3, 1])
def test_in_process_equals_image_to_data(channels, on_cpu):
    page = image("resume_example")[:200, :300].copy()
    if channels == 1:
        page = np.ascontiguousarray(page[..., 0])
        want = tuatara_tpu_torch.api.get_engine(weights_dir=GOLDEN, device="cpu").run(page)
    else:
        want = tuatara_tpu_torch.image_to_data(page, GOLDEN, device="cpu")
    got = capi.image_to_data(page, GOLDEN)
    assert len(want) > 0
    assert got == as_stored(want)


def test_null_weights_serve_random_weights(on_cpu):
    page = example_page()
    got = capi.image_to_data(page)
    assert len(got) > 0
    assert got == as_stored(tuatara_tpu_torch.image_to_data(page, device="cpu"))


def test_errors_return_minus_one(on_cpu):
    n, _ = capi.call(np.zeros((8, 8, 2), np.uint8))
    assert n == -1 and capi.last_error() == "invalid arguments"
    page, items = np.zeros((8, 8, 3), np.uint8), (capi.TuataraItem * 1)()
    n = capi.load_library().tuatara_image_to_data(
        page.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), 8, 8, 3, None, None, items, -1)
    assert n == -1 and capi.last_error() == "invalid arguments"
    n, _ = capi.call(np.zeros((64, 64, 3), np.uint8), "/nonexistent_weights_dir")
    assert n == -1 and "FileNotFoundError" in capi.last_error()
    # A good call clears the message.
    n, _ = capi.call(example_page(), GOLDEN)
    assert n >= 0 and capi.last_error() == ""


def test_no_card_and_no_device_fails(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    monkeypatch.delenv("TUATARA_TORCH_DEVICE", raising=False)
    n, _ = capi.call(example_page(), GOLDEN)
    assert n == -1
    assert "no CUDA device" in capi.last_error()


@pytest.mark.parametrize("source", ["port", "native"])
def test_example_program_prints_the_in_process_items(source, on_cpu):
    """The port's C example, and the JAX package's, unchanged, built
    against the port's header and library: a subprocess with no Python host
    prints the lines of the in-process call on the same page."""
    binary = capi.build_example(capi.EXAMPLE if source == "port" else NATIVE_EXAMPLE)
    want = example_lines(capi.image_to_data(example_page(), GOLDEN))
    proc = subprocess.run([binary, GOLDEN], env=capi.embedded_env("cpu"), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == want


def test_example_program_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    env = capi.embedded_env()
    env.pop("TUATARA_TORCH_DEVICE", None)
    proc = subprocess.run([capi.build_example(), GOLDEN], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_capi_equals_jax_image_to_data(on_cpu):
    """Live JAX: the C ABI at the default configuration (bf16) on the
    golden weights, JAX's `image_to_data` on the same page: equal words and
    bboxes."""
    import tuatara_tpu

    page = example_page()
    want = tuatara_tpu.image_to_data(page, GOLDEN)
    got = capi.image_to_data(page, GOLDEN)
    assert len(want) > 0
    assert [(w["text"], w["bbox"]) for w in got] == [(w["text"], w["bbox"]) for w in want]


def test_bf16_agrees_with_jax_within_rounding_fp32_exactly():
    """The default configuration computes in bf16. On a dense crop, fp32
    gives JAX's heatmaps within 1e-5 and all its words and bboxes; bf16,
    where the port rounds where XLA rounds JAX's forward on the CPU (the
    bias after the product's rounding, the decoder's conv before its
    upsample, the upsample's two contractions; ROADMAP Queue 3 item 19),
    gives heatmaps within 1/64 of JAX's (mean 1e-4; the fp32 sums run in
    their own orders), no pixel on the other side of text_threshold,
    low_text or link_threshold, and all 13 words and bboxes
    (`tests/probe_torch_bf16.py` prints the figures)."""
    from probe_torch_bf16 import compare

    page = image("resume_example")[:200, :300].copy()
    fp32 = compare(page, GOLDEN, "float32")
    assert max(fp32["max_abs"].values()) < 1e-5
    assert not any(px for _, px in fp32["flips"].values())
    assert [len(r) for r in fp32["records"]] == [13, 13] and fp32["same"] == 13
    bf16 = compare(page, GOLDEN, "bfloat16")
    assert max(bf16["max_abs"].values()) <= 1 / 64 and bf16["mean_abs"] <= 1e-4
    assert not any(px for _, px in bf16["flips"].values())
    assert [len(r) for r in bf16["records"]] == [13, 13] and bf16["same"] == 13
