"""The gradient sketch of phase 7's CRAFT gradient measure
(`chip_smoke.grad_sketch`, the record `tests/gen_torch_train.py --part
craft_grads`), on the CPU at the tiny config: JAX's bf16 CRAFT loss
gradient from the tiny record's start and the port's (`TrainableCraft` at
bf16, the shipped forms), each leaf's relative L2 error estimated from the
sketches against the exact one.

With 64 buckets (so that most of the tiny leaves are sketched) the norm of
a sketch estimates a leaf's norm with a relative standard deviation of at
most sqrt(1 / (2 * 64)) = 8.8%: every estimate is held within 5 of those
of the exact error, and their median within 2. Leaves of at most 64
elements are stored whole, and their estimate is the exact error (the
record's fp32 storage aside). The sketch is linear, its hash a function of
the leaf's path alone.
"""

import os
import sys

import numpy as np
import pytest
import torch

import probe_torch_bf16 as probe
from gen_torch_train import craft_grad_record
from torch_common import torch_threads  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import craft_grad_errors, grad_sketch  # noqa: E402

BUCKETS = 64
SIGMA = (1 / (2 * BUCKETS)) ** 0.5


@pytest.fixture(scope="module")
def tiny_grads(torch_threads):
    cfg, flat, pages, heat = probe.craft_grad_inputs("tiny")
    want = probe.jax_craft_grads(cfg, flat, pages, heat)
    got = probe.port_craft_grads(cfg, flat, pages, heat, probe.SHIPPED_SITES)
    keys = sorted(k for k in want if not probe.CRAFT_ZERO_GRAD.search(k)
                  and not k.endswith(("/mean", "/var")))
    return want, got, keys


def test_sketch_estimates_the_relative_error(tiny_grads):
    want, got, keys = tiny_grads
    rec = craft_grad_record(want, keys, BUCKETS)
    est = craft_grad_errors({k: torch.from_numpy(got[k]) for k in keys}, rec, BUCKETS)
    assert sorted(est) == keys
    ratios = []
    for k in keys:
        exact = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        if want[k].size <= BUCKETS:
            assert est[k] == pytest.approx(exact, rel=1e-5, abs=1e-7), k
        else:
            ratios.append(est[k] / exact - 1)
    assert len(ratios) >= 10
    assert np.abs(ratios).max() <= 5 * SIGMA, ratios
    assert abs(np.median(ratios)) <= 2 * SIGMA, ratios


def test_sketch_is_linear_and_keyed_by_path():
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal((3, 3, 16, 32))) for _ in range(2))
    lhs = grad_sketch(a, "up/upconv1/conv2/w") - grad_sketch(b, "up/upconv1/conv2/w")
    torch.testing.assert_close(lhs, grad_sketch(a - b, "up/upconv1/conv2/w"), rtol=0, atol=1e-12)
    torch.testing.assert_close(grad_sketch(a, "x"), grad_sketch(a.clone(), "x"), rtol=0, atol=0)
    assert not torch.equal(grad_sketch(a, "x"), grad_sketch(a, "y"))
    small = torch.from_numpy(rng.standard_normal(40))
    assert torch.equal(grad_sketch(small, "x"), small.double())
