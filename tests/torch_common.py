"""Shared pieces of the port's tests (`tests/test_torch_*.py`).

`torch_threads` caps torch's intra-op threads while a port test module
runs, and restores the old count after. The test workers run side by side
on the host's cores, and torch's CPU pool defaults to all of them in every
worker, so uncapped pools oversubscribe the cores several times over. A
module takes it by importing it: `from torch_common import torch_threads
# noqa: F401`.
"""

import os

import numpy as np
import pytest
import torch

from tuatara_tpu_torch.utils.image import load_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_weights")
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(old)


def image(name, keep_gray=False):
    """A reference page under images/, read by the port's PNG reader."""
    return load_image(os.path.join(ROOT, "images", f"{name}.png"), keep_gray=keep_gray)


def words(result):
    """A page's results as a JAX record holds them."""
    return [{"text": w["text"], "bbox": w["bbox"], "confidence": w["confidence"]}
            for w in result]


def assert_same_words(got, want, atol=1e-4):
    """Equal bboxes and transcripts, in order; confidences within atol."""
    assert len(want) > 0
    assert [w["bbox"] for w in got] == [w["bbox"] for w in want]
    assert [w["text"] for w in got] == [w["text"] for w in want]
    np.testing.assert_allclose([w["confidence"] for w in got],
                               [w["confidence"] for w in want], rtol=0, atol=atol)
