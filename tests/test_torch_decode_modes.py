"""The port's beam and NAR decodes (`decode_mode` "beam" and "nar") on the
CPU against the JAX package.

* `Parseq.beam_decode` against `parseq_beam_decode` and the NAR forward
  against `parseq_forward(ar=False)` at a small size: seeded JAX
  parameters (2 encoder blocks, width 32, the head scaled up so that the
  beams' log-probabilities are far apart) carried over by the weight
  function, fp32; beam ids equal and raw scores within 1e-5, NAR logits
  within 1e-5 with equal ids.
* A crafted tie: a zero head makes every candidate equal at every step,
  so the top-B must keep index order (`jax.lax.top_k`'s); the port sorts
  stably, on any device, and gives JAX's ids.
* The beam steps read nothing back to the host (no `.item()`, no tensor
  truth value, no copy to the CPU).
* The engine under each mode on `tests/fixtures/golden_weights` at fp32,
  over the reference pages, against the JAX record
  tests/fixtures/torch_decode_modes_golden.json (written by
  `tests/gen_torch_decode_modes.py`): bboxes and transcripts equal,
  confidences within 1e-4; one live JAX case shows a stale record.
* Under latency() the beam and NAR engines build K6's bundle and not K7's.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tuatara_tpu.api import OcrEngine as JaxEngine
from tuatara_tpu.config import OcrConfig as JaxOcrConfig
from tuatara_tpu.config import ParseqConfig as JaxParseqConfig
from tuatara_tpu.models import parseq as jparseq
import tuatara_tpu_torch
from tuatara_tpu_torch.config import OcrConfig, ParseqConfig
from tuatara_tpu_torch.models.parseq import Parseq
from tuatara_tpu_torch.weights import parseq_state_dict

from torch_common import GOLDEN, ROOT, assert_same_words, image, torch_threads, words  # noqa: F401

RECORD = os.path.join(ROOT, "tests", "fixtures", "torch_decode_modes_golden.json")
SMALL = dict(embed_dim=32, enc_depth=2, enc_heads=4, dec_heads=4, max_label_length=7)
SCORE_ATOL = 1e-5
LOGIT_ATOL = 1e-5


def _small(seed=0, head_scale=40.0):
    """(JAX params, the port's Parseq on them, JAX config): seeded, fp32."""
    jcfg = JaxParseqConfig(**SMALL)
    params = jparseq.init_parseq_params(jax.random.PRNGKey(seed), jcfg)
    params["head"]["w"] = params["head"]["w"] * head_scale
    params = jax.tree_util.tree_map(np.asarray, params)
    m = Parseq(ParseqConfig(**SMALL))
    m.load_state_dict(parseq_state_dict(params))
    return jax.tree_util.tree_map(jnp.asarray, params), m.eval(), jcfg


def _crops(n=6, seed=0):
    return np.random.default_rng(seed).random((n, 32, 128, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def small():
    params, m, jcfg = _small()
    crops = _crops()
    memory = jax.jit(lambda p, x: jparseq.parseq_encode(p, x, jcfg, compute_dtype=jnp.float32))(
        params, crops)
    return params, m, jcfg, crops, np.asarray(memory)


@pytest.mark.parametrize("beam", [2, 4])
def test_beam_decode_matches_jax(small, beam):
    params, m, jcfg, _, memory = small
    ids, scores = jax.jit(lambda p, x: jparseq.parseq_beam_decode(
        p, x, jcfg, beam, compute_dtype=jnp.float32))(params, memory)
    with torch.no_grad():
        got_ids, got_scores = m.beam_decode(torch.from_numpy(memory.copy()), beam)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(scores), rtol=0, atol=SCORE_ATOL)


def test_nar_matches_jax(small):
    params, m, jcfg, crops, memory = small
    want = jax.jit(lambda p, x: jparseq.parseq_forward(
        p, x, jcfg, compute_dtype=jnp.float32, ar=False))(params, crops)
    one = jax.jit(lambda p, x: jparseq.parseq_nar_decode(
        p, x, jcfg, compute_dtype=jnp.float32))(params, memory)
    with torch.no_grad():
        got = m(torch.from_numpy(crops), ar=False)
        got_one = m.nar_decode(torch.from_numpy(memory.copy()))
    np.testing.assert_allclose(got_one.numpy(), np.asarray(one), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))


def test_beam_ties_keep_index_order():
    """A zero head: every token has log-probability -log(C) at every step,
    so each top-B is all ties. JAX's top_k takes the lowest indices; the
    port's stable sort must give the same beams, scores and ids."""
    params, m, jcfg = _small(seed=1, head_scale=0.0)
    params["head"]["b"] = jnp.zeros_like(params["head"]["b"])
    m.head.bias.data.zero_()
    memory = np.asarray(jax.jit(lambda p, x: jparseq.parseq_encode(
        p, x, jcfg, compute_dtype=jnp.float32))(params, _crops(3, seed=1)))
    for beam in (2, 3, 4):
        ids, scores = jax.jit(lambda p, x: jparseq.parseq_beam_decode(
            p, x, jcfg, beam, compute_dtype=jnp.float32))(params, memory)
        with torch.no_grad():
            got_ids, got_scores = m.beam_decode(torch.from_numpy(memory.copy()), beam)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
        np.testing.assert_allclose(got_scores.numpy(), np.asarray(scores), rtol=0,
                                   atol=SCORE_ATOL)
        # Step 0 ties over beam 0's tokens: EOS (index 0) comes first, so
        # the winner is the one-token sequence.
        assert (got_ids.numpy()[:, 0] == 0).all()


def test_beam_steps_read_nothing_to_the_host(small, monkeypatch):
    """No host read in the T steps: every way a tensor reaches Python is
    made to raise while the decode runs."""
    _, m, _, _, memory = small

    def refuse(*_a, **_k):
        raise AssertionError("beam_decode read a tensor back to the host")

    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    with torch.no_grad():
        ids, scores = m.beam_decode(torch.from_numpy(memory.copy()), 4)
    monkeypatch.undo()
    assert ids.shape == (memory.shape[0], SMALL["max_label_length"] + 1)
    assert torch.isfinite(scores).all()


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def engines(record):
    return {name: tuatara_tpu_torch.OcrEngine(OcrConfig(**record["config"], **mode["overrides"]),
                                              weights_dir=GOLDEN, device="cpu")
            for name, mode in record["modes"].items()}


def _cases():
    with open(RECORD) as f:
        modes = json.load(f)["modes"]
    return [(name, page) for name, mode in modes.items() for page in mode["pages"]]


@pytest.mark.parametrize("mode,name", _cases())
def test_engine_matches_jax_fp32(engines, record, mode, name):
    assert_same_words(engines[mode].run(image(name)), record["modes"][mode]["pages"][name])


def test_decode_modes_record_is_live_jax(record):
    """The JAX engine under beam, run live on one page, equals its record."""
    assert record["config"] == {"max_label_length": 7, "compute_dtype": "float32"}
    mode = record["modes"]["beam"]
    jax_engine = JaxEngine(JaxOcrConfig(**record["config"], **mode["overrides"]),
                           weights_dir=GOLDEN)
    assert_same_words(words(jax_engine.run(image("rotated_text"))),
                      mode["pages"]["rotated_text"], atol=1e-6)


@pytest.mark.parametrize("mode", ["beam", "nar", "greedy"])
def test_latency_bundles_by_mode(mode):
    """latency() at bf16: K6's bundle in every mode, K7's only for the
    greedy decode (JAX's decode_impl affects greedy alone), where JAX's gates
    run the Pallas kernels: at PARSEQ's width, 384 (random weights), not at
    the golden weights' 32. The golden engine serves."""
    full = tuatara_tpu_torch.OcrEngine(OcrConfig.latency(decode_mode=mode), device="cpu",
                                       seed=0)
    assert full.parseq.enc_stacked is not None
    assert (full.parseq.dec_stacked is not None) == (mode == "greedy")
    engine = tuatara_tpu_torch.OcrEngine(
        OcrConfig.latency(decode_mode=mode, max_label_length=7), weights_dir=GOLDEN,
        device="cpu")
    assert engine.parseq.enc_stacked is None and engine.parseq.dec_stacked is None
    got = engine.run(image("rotated_text"))
    assert got and all(0.0 <= w["confidence"] <= 1.0 for w in got)
