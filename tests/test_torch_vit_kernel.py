"""Kernel K6 (fused ViT encoder blocks) on the CPU: the port's weight
stacking and plain version against the JAX package's Pallas kernel.

* `stack_vit_block_weights` equals the JAX bundle bit for bit (casts and
  concatenations only).
* `vit_blocks_plain` against `vit_blocks_pallas(..., interpret=True)` at
  d = 128, S = 128 and S = 64 (32x64 crops), 4 heads, N = 16, 2 and 3
  blocks, as
  tests/test_pallas_vit.py runs it. Both use the tanh GELU and round at the
  same places; what differs is the order of fp32 sums, and a bf16 rounding
  that this flips grows through the blocks: max abs err <= 1e-2 and mean
  relative err <= 1e-3 (that test allows 5e-2 / 5e-3 against the erf chain).
* `Parseq.encode` with encoder_impl="pallas" against JAX `parseq_encode`
  at bf16 with the Pallas kernel in interpret mode, same tolerance.

The CUDA kernel runs only on the card (`chip_smoke.py` holds it against
`vit_blocks_plain` there); here the wrapper must take the plain path and
count no launch.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tuatara_tpu.config import ParseqConfig as JaxParseqConfig
from tuatara_tpu.models import layers as L
from tuatara_tpu.models.parseq import init_parseq_params, parseq_encode
from tuatara_tpu.ops.pallas.vit import stack_vit_block_weights as jax_stack
from tuatara_tpu.ops.pallas.vit import vit_blocks_pallas
from tuatara_tpu_torch.config import ParseqConfig
from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
from tuatara_tpu_torch.kernels.vit import check_geometry, stack_vit_block_weights, vit_blocks
from tuatara_tpu_torch.models.parseq import Parseq
from tuatara_tpu_torch.weights import parseq_state_dict

from torch_common import torch_threads  # noqa: F401

MAX_ABS = 1e-2
MEAN_REL = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _port_parseq(params, cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxParseqConfig)}
    m = Parseq(ParseqConfig(**kw)).eval()
    m.load_state_dict(parseq_state_dict(_np_tree(params)))
    return m


def _to_torch(st):
    return {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in st.items()}


def _assert_close(got, want):
    err = np.abs(got - want)
    assert float(err.max()) <= MAX_ABS, f"max abs err {err.max()}"
    rel = float((err / (np.abs(want) + 1)).mean())
    assert rel <= MEAN_REL, f"mean rel err {rel}"


def test_stack_equals_jax_bundle():
    cfg = JaxParseqConfig(embed_dim=128, enc_depth=3, enc_heads=4, max_label_length=7)
    params = init_parseq_params(jax.random.PRNGKey(4), cfg)
    want = jax_stack(params["enc"])
    got = stack_vit_block_weights(_port_parseq(params, cfg).enc)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == (torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(v.astype(jnp.float32)), err_msg=k)


@pytest.mark.parametrize("n_blocks,tb", [(2, 4), (3, 8)])
def test_plain_matches_pallas_interpret(n_blocks, tb, s=128):
    d, heads, n = 128, 4, 16
    blocks = [L.init_vit_block(k, d, 4.0) for k in jax.random.split(jax.random.PRNGKey(0), n_blocks)]
    x = np.random.default_rng(n_blocks).standard_normal((n, s, d)).astype(np.float32)
    st = jax_stack(blocks)
    want = np.asarray(vit_blocks_pallas(jnp.asarray(x), st, heads, tb=tb, blocks_per_call=2,
                                        interpret=True))
    reset_launches()
    got = vit_blocks(torch.from_numpy(x), _to_torch(st), heads)
    assert LAUNCHES["vit_blocks"] == 0  # CPU tensor: the plain version
    _assert_close(got.numpy(), want)


def test_plain_matches_pallas_interpret_64_tokens():
    """32x64 crops: 64 tokens per crop."""
    test_plain_matches_pallas_interpret(2, 4, s=64)


def test_encode_pallas_matches_jax():
    cfg = JaxParseqConfig(embed_dim=128, enc_depth=2, enc_heads=4, max_label_length=7,
                          encoder_impl="pallas")
    params = init_parseq_params(jax.random.PRNGKey(2), cfg)
    crops = np.random.default_rng(5).random((16, 32, 128, 3), np.float32)
    want = np.asarray(parseq_encode(params, jnp.asarray(crops), cfg, jnp.bfloat16,
                                    _pallas_interpret=True))
    m = _port_parseq(params, cfg)
    m.prestack(torch.bfloat16)
    assert m.enc_stacked is not None and m.dec_stacked is None
    from tuatara_tpu_torch.models.layers import set_compute_dtype

    set_compute_dtype(m, torch.bfloat16)
    with torch.no_grad():
        got = m.encode(torch.from_numpy(crops)).numpy()
    _assert_close(got, want)


def test_prestack_gates():
    """No bundle at float32 compute or with the default lowering."""
    cfg = JaxParseqConfig(embed_dim=64, enc_depth=1, enc_heads=4, dec_heads=4,
                          max_label_length=7)
    params = init_parseq_params(jax.random.PRNGKey(1), cfg)
    m = _port_parseq(params, cfg)
    m.prestack(torch.bfloat16)
    assert m.enc_stacked is None and m.dec_stacked is None
    m = _port_parseq(params, dataclasses.replace(cfg, encoder_impl="pallas",
                                                 decode_impl="pallas"))
    m.prestack(torch.float32)
    assert m.enc_stacked is None and m.dec_stacked is None
    m.prestack(torch.bfloat16)
    assert m.enc_stacked is not None and m.dec_stacked is not None
    assert not any(k.startswith(("enc_stacked", "dec_stacked")) for k in m.state_dict())
    # The per-block encoder modules are released once K6's bundle holds them.
    assert len(m.enc) == 0 and not any(k.startswith("enc.") for k in m.state_dict())


def test_kernel_geometry_checks():
    """K6's CUDA kernel takes 64 or 128 tokens per crop (head width 64, D and
    the MLP width multiples of 128); the check runs in the wrapper and, for
    an engine on the card, when `prestack` builds the bundle."""
    for s in (64, 128):
        check_geometry(s, 384, 6, 1536)
    for s in (32, 96, 256):
        with pytest.raises(ValueError, match="S in"):
            check_geometry(s, 384, 6, 1536)
    with pytest.raises(ValueError, match="head width 64"):
        check_geometry(128, 384, 12, 1536)

    def port(width):
        cfg = JaxParseqConfig(embed_dim=128, enc_depth=1, enc_heads=2, dec_heads=4,
                              max_label_length=7, img_size=(32, width),
                              encoder_impl="pallas")
        return _port_parseq(init_parseq_params(jax.random.PRNGKey(3), cfg), cfg)

    for width in (64, 128):
        m = port(width)
        m.prestack(torch.bfloat16, torch.device("cuda"))
        assert m.enc_stacked is not None
    with pytest.raises(ValueError, match="S in"):
        port(96).prestack(torch.bfloat16, torch.device("cuda"))
    m = port(96)
    m.prestack(torch.bfloat16, torch.device("cpu"))  # the plain version takes any S
    assert m.enc_stacked is not None
