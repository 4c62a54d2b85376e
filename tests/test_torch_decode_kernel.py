"""Kernel K7 (fused greedy decode) on the CPU: the port's weight bundle and
plain version against the JAX package.

* `stack_decode_weights` against the JAX bundle on the keys both hold (the
  port leaves out the TPU kernel's head-segment matrices `seg`/`segT`):
  cast keys bit for bit; the three computed keys (`qh_all`, `k_tab`,
  `v_tab`: LayerNorm -> bf16 linear) bit for bit on at least 99% of their
  values and within one bf16 step of a unit-scale value (2^-8 abs, 2^-7
  rel) on the rest, because XLA's CPU reductions and rsqrt differ from
  PyTorch's in the last fp32 bit and a bf16 rounding near a tie (of the
  product, before the bias is added in bf16) can then go the other way.
* `greedy_decode_plain` against the JAX kernel's math. Pallas interpret
  mode produces spurious NaNs for this kernel (tests/test_pallas_decode.py
  module doc), and compiled by XLA's CPU backend it drops the kernel's
  bf16 rounding of the attention products, so the reference is that
  file's jnp transcription `_simulate_kernel`, run eagerly. Both round
  every q*k and p*v product to bf16 and sum in fp32, so the ids up to each
  crop's first EOS are equal on every crop, and the logits of those steps
  differ only by the order of fp32 sums: within STEP_ATOL (6e-8 measured;
  2e-2 and 90% of the ids while the port kept the products exact).
* Tile early exit: positions past a tile's stop hold EOS-certain logits,
  and transcripts do not depend on the tile size.
* The tile size changes no result: with tiles of 1, 4, 16 and 32 crops
  (the JAX engine decodes in tiles of 32, tuatara_tpu/models/parseq.py:375;
  the port's kernel in tiles of `TB`), the ids up to each crop's first EOS
  are equal, and after the cloze refine and the confidence, as the
  latency path applies them, so are the transcripts and confidences: the
  refine masks every key after the first EOS, so the EOS-certain fill
  that a tile's early stop leaves is never read.
* The CUDA kernel's geometry refusals (`check_geometry`): head width,
  steps, memory length, crops per tile and CTAs per cluster; and the
  tile-major packing of the weights it streams.

The CUDA kernel runs only on the card (`chip_smoke.py` holds it against
`greedy_decode_plain` there); here the wrapper takes the plain path.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_pallas_decode import _simulate_kernel
from tuatara_tpu.config import ParseqConfig as JaxParseqConfig
from tuatara_tpu.models import layers as L
from tuatara_tpu.models.parseq import init_parseq_params, parseq_encode
from tuatara_tpu.ops.pallas.decode import stack_decode_weights as jax_stack
from tuatara_tpu_torch.config import ParseqConfig
from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
from tuatara_tpu_torch.kernels.decode import (TILED, check_geometry, greedy_decode,
                                              stack_decode_weights, tile_major, untile)
from tuatara_tpu_torch.models.parseq import Parseq, confidence
from tuatara_tpu_torch.tokenizer import Tokenizer
from tuatara_tpu_torch.weights import parseq_state_dict

from torch_common import torch_threads  # noqa: F401

CFG = JaxParseqConfig(embed_dim=64, enc_depth=1, enc_heads=4, dec_heads=4, max_label_length=7)
COMPUTED = ("qh_all", "k_tab", "v_tab")
# The plain version against `_simulate_kernel`: the same roundings, the fp32
# sums in other orders (logits of unit scale).
STEP_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    params = init_parseq_params(jax.random.PRNGKey(0), CFG)
    crops = jnp.asarray(np.random.default_rng(0).random((24, 32, 128, 3)), jnp.float32)
    memory = parseq_encode(params, crops, CFG, jnp.bfloat16)
    ca = params["dec"][0]["cross_attn"]
    mem_k = L.linear(ca["k"], memory, jnp.bfloat16).astype(jnp.bfloat16)
    mem_v = L.linear(ca["v"], memory, jnp.bfloat16).astype(jnp.bfloat16)
    kw = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(JaxParseqConfig)}
    m = Parseq(ParseqConfig(**kw)).eval()
    m.load_state_dict(parseq_state_dict(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)))
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
    return {"params": params, "jst": jax_stack(params, CFG), "st": stack_decode_weights(m),
            "mem_k": mem_k, "mem_v": mem_v, "t_mem_k": to_t(mem_k), "t_mem_v": to_t(mem_v),
            "model": m, "memory": torch.from_numpy(np.array(memory.astype(jnp.float32)))}


def _decode(s, st=None, tb=16):
    T = CFG.max_label_length + 1
    return greedy_decode(s["t_mem_k"], s["t_mem_v"], st or s["st"], CFG.dec_heads, T,
                         CFG.charset_size + 1, CFG.num_tokens - 2, CFG.layer_norm_eps, tb)


def _upto_first_eos(ids):
    """[N, T] bool: positions up to and including each row's first EOS."""
    eos = ids == 0
    return (np.cumsum(eos, axis=1) - eos) == 0


def test_bundle_matches_jax(setup):
    got, want = setup["st"], setup["jst"]
    assert set(got) == set(want) - {"seg", "segT"}
    for k, t in got.items():
        ref = np.asarray(want[k].astype(jnp.float32))
        if k in TILED:  # the streamed weights are held tile-major
            assert t.shape == (ref.shape[1] // 16, ref.shape[0], 16), k
            t = untile(t)
        val = t.float().numpy()
        assert val.shape == ref.shape, k
        if k not in COMPUTED:
            np.testing.assert_array_equal(val, ref, err_msg=k)
            continue
        assert t.dtype == torch.bfloat16, k
        assert float((val == ref).mean()) >= 0.99, k
        np.testing.assert_allclose(val, ref, rtol=2.0**-7, atol=2.0**-8, err_msg=k)


def test_plain_matches_kernel_math(setup):
    T = CFG.max_label_length + 1
    want = np.asarray(_simulate_kernel(setup["jst"], setup["mem_k"], setup["mem_v"], CFG, T))
    reset_launches()
    got = _decode(setup).numpy()
    assert LAUNCHES["greedy_decode"] == 0  # CPU tensors: the plain version
    assert np.isfinite(got).all()
    ref_ids = want.argmax(-1)
    upto = _upto_first_eos(ref_ids)
    np.testing.assert_array_equal(got.argmax(-1)[upto], ref_ids[upto])
    np.testing.assert_allclose(got[upto], want[upto], rtol=0, atol=STEP_ATOL)


def test_tile_early_exit_and_tile_size(setup):
    """Raise the EOS bias so crops end at different steps: every position
    after the step at which a crop's whole tile had ended holds the
    EOS-certain logits, and the ids up to each crop's first EOS are the same
    for tiles of 16, 5 and 1."""
    T = CFG.max_label_length + 1
    st = dict(setup["st"])
    h_b = st["h_b"].clone()
    logits0 = _decode(setup).numpy()
    margin = logits0.max(-1) - logits0[..., 0]
    h_b[0] += float(np.median(margin[:, 1]))  # about half the crops end at step 1
    st["h_b"] = h_b
    runs = {tb: _decode(setup, st, tb).numpy() for tb in (16, 5, 1)}
    certain = np.full(CFG.charset_size + 1, -30.0, np.float32)
    certain[0] = 30.0
    for tb, out in runs.items():
        ids = out.argmax(-1)
        ended = np.cumsum(ids == 0, axis=1) > 0
        for t0 in range(0, out.shape[0], tb):
            tile_ended = ended[t0:t0 + tb].all(0)
            stop = int(np.argmax(tile_ended)) if tile_ended.any() else T - 1
            np.testing.assert_array_equal(out[t0:t0 + tb, stop + 1:],
                                          np.broadcast_to(certain, out[t0:t0 + tb, stop + 1:].shape))
    assert runs[1][:, 1:].max() == 30.0  # some crops did stop early
    ref = runs[16].argmax(-1)
    upto = _upto_first_eos(ref)
    for tb in (5, 1):
        np.testing.assert_array_equal(runs[tb].argmax(-1)[upto], ref[upto])


def test_results_do_not_depend_on_tile_size(setup):
    """Tiles of 1, 4, 16 and 32 crops, with the EOS bias raised so that
    crops end at different steps and tiles stop at different steps: equal
    ids up to each crop's first EOS, then equal transcripts and
    confidences after the refine and the confidence."""
    st = dict(setup["st"])
    logits0 = _decode(setup).numpy()
    h_b = st["h_b"].clone()
    h_b[0] += float(np.median(logits0.max(-1)[:, 1] - logits0[:, 1, 0]))
    st["h_b"] = h_b
    runs = {tb: _decode(setup, st, tb) for tb in (1, 4, 16, 32)}
    ref = runs[32].argmax(-1).numpy()
    upto = _upto_first_eos(ref)
    assert upto.sum(1).min() < upto.sum(1).max()  # crops end at different steps
    assert (runs[1].numpy() != runs[32].numpy()).any()  # so the tiles' fills differ
    m, tok = setup["model"], Tokenizer()
    out = {}
    with torch.no_grad():
        for tb, logits in runs.items():
            np.testing.assert_array_equal(logits.argmax(-1).numpy()[upto], ref[upto], err_msg=tb)
            ids, conf = confidence(m.refine(setup["memory"], logits))
            out[tb] = (tok.decode_ids(ids.numpy()), conf.numpy())
    assert len(set(map(tuple, (t for t, _ in out.values())))) == 1
    for tb, (_, conf) in out.items():
        np.testing.assert_array_equal(conf, out[32][1], err_msg=tb)


@pytest.mark.parametrize("kw,match", [
    ({"heads": 6}, "head width 32"),          # D = 384 over 6 heads: width 64
    ({"t": 33}, "T <= 32"),
    ({"s": 100}, "S % 32"),
    ({"tb": 0}, "tb <= 16"),
    ({"tb": 17}, "tb <= 16"),
    ({"cluster": 5}, "cluster of 5"),         # does not divide the 12 heads
    ({"cluster": 9}, "cluster of 9"),
    ({"cluster": 2}, "cluster of 2"),         # 768 MLP columns a CTA
])
def test_kernel_geometry_checks(kw, match):
    """The CUDA kernel's refusals; PARSEQ's decoder (12 heads, D = 384, MLP
    1536, T = 26, S = 128 or 64) is taken at 4 or 6 CTAs per cluster and 1
    to 16 crops per tile."""
    base = {"d": 384, "heads": 12, "t": 26, "s": 128, "hidden": 1536, "tb": 4, "cluster": 6}
    for cluster in (4, 6):
        for tb in (1, 4, 16):
            check_geometry(**dict(base, tb=tb, cluster=cluster))
    check_geometry(**dict(base, s=64))
    with pytest.raises(ValueError, match=match):
        check_geometry(**dict(base, **kw))


def test_tile_major_packing():
    """The streamed weights as N / 16 column tiles of [K, 16], which
    `untile` turns back into [K, N]."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((48, 64), np.float32))
    w = w.to(torch.bfloat16)
    p = tile_major(w)
    assert p.shape == (4, 48, 16) and p.is_contiguous()
    for t in range(4):
        assert torch.equal(p[t], w[:, 16 * t:16 * t + 16])
    assert torch.equal(untile(p), w)
