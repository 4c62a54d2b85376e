"""Kernel K8 (fused conv3x3 + bias + ReLU + 2x2 max-pool) and the
FUSED_STAGE1 gate on the CPU, against the JAX package.

* `fused_conv_pool_plain` against `fused_conv_pool(..., interpret=True)` at
  the shapes of tests/test_stage1_kernel.py and its zero-edge case, the
  weights carried from JAX's [3, 3, C, O] to the port's [O, C, 3, 3], packed
  by `pack_conv_pool_weights` (the plain version unpacks them), and the
  NHWC input viewed as the port's channels_last [B, C, H, W]. Both take bf16
  inputs and weights with fp32 sums; only the order of the sums differs, so
  every output is within one bf16 step of JAX's (relative 2**-7).
* `pack_conv_pool_weights` round-trips, and lays each tap out as the
  128-byte swizzled K-major block the CUDA kernel's wgmma reads.
* CRAFT's forward at bf16 with FUSED_STAGE1 = "on" in both packages, on the
  committed golden weights: heatmaps and features within a relative
  (Frobenius) error of 3e-2 (tests/test_stage1_kernel.py's tolerance). The
  two packages' bf16 convolutions round at other places: their unfused
  forwards differ by 1.7-1.8e-2 (heatmaps) and 5.6-5.9e-3 (features) on
  these inputs, and a few heatmap pixels by 4e-2, so an elementwise bound
  would test the unfused trunk rather than the fusion.
  K8 gets its input channels_last, the one layout the CUDA kernel takes,
  from an RGB canvas and from a gray one broadcast to conv1_1's channels.
* The gate mirrors JAX's conditions.

The CUDA kernel runs only on the card (`chip_smoke.py` holds it against
the plain version there); here the wrapper must take the plain path and
count no launch.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tuatara_tpu.models import craft as jax_craft
from tuatara_tpu.ops.pallas.stage1 import fused_conv_pool as jax_fused_conv_pool
from tuatara_tpu.utils import weights as jax_weights
from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
from tuatara_tpu_torch.kernels.stage1 import (
    fused_conv_pool, pack_conv_pool_weights, unpack_conv_pool_weights,
)
from tuatara_tpu_torch.models import craft as t_craft
from tuatara_tpu_torch.models.layers import set_compute_dtype
from tuatara_tpu_torch.utils import weights as t_weights
from tuatara_tpu_torch.weights import craft_state_dict

from torch_common import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_weights")
BF16_STEP = 2.0 ** -7
CRAFT_TOL = 3e-2


def _port_conv_pool(x, wk, b):
    """NHWC fp32 x, HWIO wk -> the port's wrapper (channels_last, the
    layout the CUDA kernel takes) -> NHWC fp32."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(wk).permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
    reset_launches()
    got = fused_conv_pool(xt, pack_conv_pool_weights(wt), torch.from_numpy(b))
    assert LAUNCHES["fused_conv_pool"] == 0  # CPU tensor: the plain version
    assert got.dtype == torch.bfloat16
    return got.float().permute(0, 2, 3, 1).numpy()


def _assert_within_one_step(got, want):
    np.testing.assert_array_less(np.abs(got - want), BF16_STEP * np.abs(want) + 1e-6)


@pytest.mark.parametrize("c,o,h,w", [
    (16, 16, 32, 130),
    (8, 16, 16, 64),
    (64, 64, 32, 128),
])
def test_plain_matches_pallas_interpret(c, o, h, w):
    rng = np.random.default_rng(c + o + h + w)
    x = rng.random((2, h, w, c), np.float32)
    wk = (rng.standard_normal((3, 3, c, o)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(o) * 0.1).astype(np.float32)
    want = np.asarray(jax_fused_conv_pool(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b),
                                          interpret=True), np.float32)
    got = _port_conv_pool(x, wk, b)
    assert got.shape == want.shape == (2, h // 2, w // 2, o)
    _assert_within_one_step(got, want)


def test_plain_zero_padding_edges():
    """Mass only at two corners: SAME zero padding at every border."""
    rng = np.random.default_rng(7)
    x = np.zeros((1, 16, 64, 8), np.float32)
    x[0, 0, 0] = 1.0
    x[0, -1, -1] = 1.0
    wk = (rng.standard_normal((3, 3, 8, 8)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(8) * 0.1).astype(np.float32)
    want = np.asarray(jax_fused_conv_pool(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b),
                                          interpret=True), np.float32)
    _assert_within_one_step(_port_conv_pool(x, wk, b), want)


@pytest.mark.parametrize("o,c", [(64, 64), (8, 8), (16, 80)])
def test_pack_conv_pool_weights_round_trip(o, c):
    """Unpacking gives the bf16 weights back exactly; each tap is an O x
    128-byte block per 64-channel chunk whose 16-byte chunk q of row o
    holds channels 8 (q ^ (o % 8)) .. + 8, zero past C."""
    w = torch.from_numpy(np.random.default_rng(o + c).standard_normal((o, c, 3, 3),
                                                                       np.float32))
    packed = pack_conv_pool_weights(w)
    n_chunks = -(-c // 64)
    assert packed.shape == (9, n_chunks, o, 64) and packed.dtype == torch.bfloat16
    assert packed.is_contiguous()
    assert torch.equal(unpack_conv_pool_weights(packed, c), w.to(torch.bfloat16))
    wb = w.to(torch.bfloat16)
    for tap in (0, 4, 8):
        ky, kx = divmod(tap, 3)
        for row in (0, 5, o - 1):
            for q in range(8):
                ch = 8 * (q ^ (row % 8))
                want = torch.zeros(8, dtype=torch.bfloat16)
                have = wb[row, ch:min(ch + 8, c), ky, kx]
                want[:have.numel()] = have
                assert torch.equal(packed[tap, 0, row, 8 * q:8 * q + 8], want)


def test_craft_holds_packed_conv1_2(golden_craft):
    """The CRAFT module keeps conv1_2's packed weights as a buffer, packed
    at load (not per call) and left out of the state dict."""
    m, _, _ = golden_craft
    w = m.vgg["conv1_2"]["conv"].weight
    assert torch.equal(m.conv1_2_packed, pack_conv_pool_weights(w))
    assert "conv1_2_packed" not in m.state_dict()
    assert any(b is m.conv1_2_packed for b in m.buffers())


@pytest.fixture(scope="module")
def golden_craft():
    cc, _, _ = t_weights.load_configs(GOLDEN)
    ct, _ = t_weights.load_weights_dir(GOLDEN)
    jcc, _, _ = jax_weights.load_configs(GOLDEN)
    jct, _ = jax_weights.load_weights_dir(GOLDEN)
    m = t_craft.Craft(cc).eval()
    m.load_state_dict(craft_state_dict(ct, cc.bn_eps))
    set_compute_dtype(m, torch.bfloat16)
    return m, jax_craft.fold_batchnorms(jct, jcc.bn_eps), jcc


@pytest.mark.parametrize("channels", [3, 1], ids=["rgb", "gray"])
def test_craft_fused_forward_matches_jax(golden_craft, channels, monkeypatch):
    """Both packages with FUSED_STAGE1 = "on" at bf16: the port's gate
    takes K8 (its plain version here) and the outputs stay within 3e-2
    (relative) of JAX's forward through its Pallas kernel (interpret).
    K8's input is channels_last, the layout its CUDA kernel requires, for
    the gray canvas (expanded to conv1_1's channels) too."""
    m, jparams, jcfg = golden_craft
    x = np.random.default_rng(channels).random((1, 64, 96, channels), np.float32)
    calls = []

    def spy(*args):
        calls.append((args[0].shape, args[0].is_contiguous(memory_format=torch.channels_last)))
        return fused_conv_pool(*args)

    monkeypatch.setattr(t_craft, "FUSED_STAGE1", "on")
    monkeypatch.setattr(t_craft, "fused_conv_pool", spy)
    old = jax_craft.FUSED_STAGE1
    jax_craft.FUSED_STAGE1 = "on"
    try:
        want, want_feat = jax_craft.craft_forward(jparams, jnp.asarray(x), jcfg,
                                                  compute_dtype=jnp.bfloat16)
    finally:
        jax_craft.FUSED_STAGE1 = old
    with torch.no_grad():
        got, feat = m(torch.from_numpy(x))
    assert calls == [((1, jcfg.stage_channels[0], 64, 96), True)]
    for a, b in ((got, want), (feat, want_feat)):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape and np.isfinite(a.numpy()).all()
        assert np.linalg.norm(a.numpy() - b) / np.linalg.norm(b) <= CRAFT_TOL


def test_fused_stage1_gate(golden_craft, monkeypatch):
    """JAX's conditions: off by default; "on" needs serving mode, bf16
    weights and H % 16 == 0, W % 2 == 0; "auto" takes the card only."""
    m, _, _ = golden_craft
    x = torch.zeros(1, 64, 96, 3)
    assert t_craft.FUSED_STAGE1 == "off" and not m._fused_stage1_ok(x)
    monkeypatch.setattr(t_craft, "FUSED_STAGE1", "on")
    assert m._fused_stage1_ok(x)
    assert not m._fused_stage1_ok(torch.zeros(1, 56, 96, 3))
    assert not m._fused_stage1_ok(torch.zeros(1, 64, 95, 3))
    m.train()
    try:
        assert not m._fused_stage1_ok(x)
    finally:
        m.eval()
    f32 = t_craft.Craft(m.cfg).eval()
    assert not f32._fused_stage1_ok(x)  # float32 compute
    monkeypatch.setattr(t_craft, "FUSED_STAGE1", "auto")
    assert not m._fused_stage1_ok(x)  # a CPU tensor
