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
* JAX's gates: the port's `recognize` runs K6 and K7 exactly where JAX's
  recognizer runs its Pallas kernels (width a multiple of 128; K6 also a
  slab of a multiple of 8 crops), and rebuilds the released encoder blocks
  from K6's bundle, bit for bit, for a slab that K6 does not take.

The CUDA kernel runs only on the card (`chip_smoke.py` holds it against
`vit_blocks_plain` there); here the wrapper must take the plain path and
count no launch.
"""

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch import nn

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
    """No bundle at float32 compute, with the default lowering, or at a
    width that is not a multiple of 128 (JAX's gates)."""
    cfg = JaxParseqConfig(embed_dim=128, enc_depth=1, enc_heads=4, dec_heads=4,
                          max_label_length=7)
    params = init_parseq_params(jax.random.PRNGKey(1), cfg)
    m = _port_parseq(params, cfg)
    m.prestack(torch.bfloat16)
    assert m.enc_stacked is None and m.dec_stacked is None
    pallas = dict(encoder_impl="pallas", decode_impl="pallas")
    narrow = dataclasses.replace(cfg, embed_dim=64, **pallas)
    m = _port_parseq(init_parseq_params(jax.random.PRNGKey(1), narrow), narrow)
    m.prestack(torch.bfloat16)
    assert m.enc_stacked is None and m.dec_stacked is None
    m = _port_parseq(params, dataclasses.replace(cfg, **pallas))
    m.prestack(torch.float32)
    assert m.enc_stacked is None and m.dec_stacked is None
    m.prestack(torch.bfloat16)
    assert m.enc_stacked is not None and m.dec_stacked is not None
    assert not any(k.startswith(("enc_stacked", "dec_stacked")) for k in m.state_dict())
    # The per-block encoder modules are released once K6's bundle holds them.
    assert len(m.enc) == 0 and not any(k.startswith("enc.") for k in m.state_dict())


@pytest.mark.parametrize("n", [12, 16])
@pytest.mark.parametrize("d", [32, 128])
def test_kernels_run_where_jax_gates_run(d, n, monkeypatch):
    """`Parseq.recognize` (latency()'s lowering, bf16) runs K6 and K7 exactly
    where JAX's `_recognize_body` runs `vit_blocks_pallas` and
    `greedy_decode_pallas`: K7 at D = 128, K6 at D = 128 on a slab of a
    multiple of 8 crops, neither at D = 32. JAX's calls are recorded while
    it traces; the port's wrappers are wrapped to record theirs. At N = 12
    the port rebuilds the released blocks from K6's bundle
    (`eager_blocks`), equal to the modules it released."""
    import tuatara_tpu.ops.pallas.decode as pallas_decode
    import tuatara_tpu.ops.pallas.vit as pallas_vit
    from tuatara_tpu.api import OcrEngine as JaxEngine
    from tuatara_tpu.config import OcrConfig as JaxOcrConfig
    from tuatara_tpu_torch.kernels import decode as K7
    from tuatara_tpu_torch.kernels import vit as K6
    from tuatara_tpu_torch.models.layers import set_compute_dtype

    cfg = JaxParseqConfig(embed_dim=d, enc_depth=2, enc_heads=4, dec_heads=4,
                          max_label_length=7, encoder_impl="pallas", decode_impl="pallas")
    params = init_parseq_params(jax.random.PRNGKey(d), cfg)
    crops = np.random.default_rng(n).random((n, 32, 128, 3), np.float32)
    ran = {"jax": set(), "port": set()}
    T, C = cfg.max_label_length + 1, cfg.charset_size + 1

    def jax_k6(x, *a, **k):
        ran["jax"].add("K6")
        return x

    def jax_k7(mem_k, *a, **k):
        ran["jax"].add("K7")
        return jnp.zeros((mem_k.shape[0], T, C), jnp.float32)

    monkeypatch.setattr(pallas_vit, "vit_blocks_pallas", jax_k6)
    monkeypatch.setattr(pallas_decode, "greedy_decode_pallas", jax_k7)
    eng = SimpleNamespace(parseq_config=cfg, config=JaxOcrConfig(), mesh=None)
    jax.jit(lambda p, x: JaxEngine._recognize_body(eng, p, x)).lower(params, crops)

    for name, mod, fn in (("K6", K6, "vit_blocks"), ("K7", K7, "greedy_decode")):
        def record(*a, _name=name, _fn=getattr(mod, fn), **k):
            ran["port"].add(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, fn, record)
    m = _port_parseq(params, cfg)
    eager = [copy.deepcopy(blk) for blk in m.enc]
    m.prestack(torch.bfloat16)
    set_compute_dtype(m, torch.bfloat16)
    with torch.no_grad():
        ids, conf = m.recognize(torch.from_numpy(crops))
    assert ids.shape == (n, T) and torch.isfinite(conf).all()
    want = {"K7"} if d == 128 else set()
    if d == 128 and n % 8 == 0:
        want.add("K6")
    assert ran["jax"] == ran["port"] == want
    if d == 128 and n % 8:
        set_compute_dtype(nn.ModuleList(eager), torch.bfloat16)
        got = m.eager_blocks().state_dict()
        want_sd = nn.ModuleList(eager).state_dict()
        assert set(got) == set(want_sd)
        for k, v in want_sd.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


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
