"""The port's int8 recognizer encoder (`Parseq.quantize`, `QLinear`,
`kernels/int8.int8_linear`) on the CPU against the JAX package
(`quantize_parseq_encoder`, `quantize_linear`, `linear_q`).

* `quantize_linear`: every quantized layer's int8 weights, scales and bias
  bit-equal to JAX's on the golden weights (patch embed, each block's
  q/k/v/o and fc1/fc2; the decoder stays float);
* `QLinear` equal to JAX's compiled `linear_q` bit for bit, dynamic and
  static scales, fp32 and bf16 outputs: the int32 sums are exact (the
  plain float64 product here; the card's `torch._int_mm` route is held by
  chip_smoke.py) and the dequant is one fused multiply-add;
* the quantized encoder's memory on real crops within MEMORY_ATOL of
  JAX's (its float parts, LayerNorm, softmax and GELU, differ by ulps,
  which int8 rounding can grow by a quantization step);
* the engine under `OcrConfig(quantized_serving=True)` and
  `production(encoder_impl="xla")`, and the first after `calibrate`, on
  the golden pages (CRAFT's tree folded by JAX) against the JAX record
  tests/fixtures/torch_int8_encoder_golden.json (written by
  `tests/gen_torch_int8_encoder.py`): every page's words equal, in order,
  with confidences within 1e-4; one live JAX case;
* `calibrate`'s scales, detector and encoder, within 1e-5 of JAX's saved
  file, and the file cross-loading both ways;
* the serving loop with the dynamic int8 encoder: JAX's `run_stream`
  equals its `run_pages` loop on the serving batches (its record), and the
  port's both equal it (dynamic scales span the slab, so this is what the
  port must follow slab for slab);
* K6 is off under the int8 encoder (no bundle), as JAX's gate keeps the
  quantized encoder on XLA.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tuatara_tpu.api import OcrEngine as JaxEngine
from tuatara_tpu.config import OcrConfig as JaxOcrConfig
from tuatara_tpu.config import ParseqConfig as JaxParseqConfig
from tuatara_tpu.models import layers as JL
from tuatara_tpu.models import parseq as jparseq
from tuatara_tpu.utils import weights as JW
import tuatara_tpu_torch
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
from tuatara_tpu_torch.kernels.int8 import int8_linear, int8_linear_plain
from tuatara_tpu_torch.models import layers as TL
from tuatara_tpu_torch.models.parseq import Parseq
from tuatara_tpu_torch.utils import weights as W
from tuatara_tpu_torch.weights import parseq_state_dict

from gen_torch_serving import stream_batches
from test_torch_int8 import folded  # noqa: F401  (the JAX-folded golden weights)
from torch_common import GOLDEN, ROOT, assert_same_words, image, torch_threads, words  # noqa: F401

RECORD = os.path.join(ROOT, "tests", "fixtures", "torch_int8_encoder_golden.json")
JAX_CALIBRATION = os.path.join(ROOT, "tests", "fixtures", "torch_int8_encoder_calibration.npz")
MEMORY_ATOL = {"float32": 2e-2, "bfloat16": 1e-1}
CALIB_RTOL = 1e-5


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def golden_parseq():
    """(the golden PARSEQ tree, JAX's quantized tree, the config)."""
    pcfg = W.load_configs(GOLDEN)[1]
    tree = W.load_weights_dir(GOLDEN)[1]
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    return tree, jparseq.quantize_parseq_encoder(jtree), pcfg


def _port(tree, pcfg, dtype=torch.float32):
    m = Parseq(pcfg)
    m.load_state_dict(parseq_state_dict(tree))
    m.eval().quantize()
    return TL.set_compute_dtype(m, dtype)


def _node(tree, path):
    for p in path.split("/"):
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


def test_quantized_layers_match_jax(golden_parseq):
    """The layers JAX quantizes, and only those; int8 weights, scales and
    biases bit-equal; idempotent."""
    tree, jq, pcfg = golden_parseq
    m = _port(tree, pcfg)
    names = [n for n, _ in m.qlinears()]
    want = ["patch_embed"] + [f"enc/{i}/{g}/{k}" for i in range(pcfg.enc_depth)
                              for g, ks in (("attn", "qkvo"), ("mlp", ("fc1", "fc2")))
                              for k in ks]
    assert names == want
    for name, q in m.qlinears():
        node = _node(jq, name)
        np.testing.assert_array_equal(q.wq.numpy(), np.asarray(node["wq"]))
        np.testing.assert_array_equal(q.sw.numpy(), np.asarray(node["sw"]))
        np.testing.assert_array_equal(q.bias.numpy(), np.asarray(node["b"]))
    first = dict(m.qlinears())
    m.quantize()
    assert dict(m.qlinears()) == first
    assert not any(isinstance(x, TL.QLinear) for x in m.dec.modules())


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qlinear_matches_linear_q(dtype, static):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    node = JL.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    lin = TL.Linear(96, 40)
    lin.weight.data, lin.bias.data = torch.from_numpy(w.T.copy()), torch.from_numpy(b)
    q = TL.QLinear.from_linear(lin)
    q.out_dtype = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((3, 7, 96)).astype(np.float32) * 2)
    x.view(-1)[:6] = torch.tensor([0.5, -0.5, 1.5, 2.5, 0.0, -2.5])  # ties and zero
    x = x.to(getattr(torch, dtype))
    if static:
        sx = TL.static_scale(3.3, 1.1)
        q.sx = torch.tensor(sx)
        node = {**node, "sx": jnp.float32(sx)}
    want = jax.jit(lambda p, v: JL.linear_q(p, v, out_dtype=getattr(jnp, dtype)))(
        node, jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype)))
    reset_launches()
    got = q(x)
    assert LAUNCHES["int8_linear"] == 0  # the plain version on the CPU
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    xq, _ = q.quantize_input(x)
    np.testing.assert_array_equal(int8_linear(xq, q.wmat).numpy(),
                                  int8_linear_plain(xq, q.wmat).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_memory_matches_jax(golden_parseq, dtype):
    """Crops of a reference page through the quantized encoder, both
    packages."""
    tree, jq, pcfg = golden_parseq
    m = _port(tree, pcfg, getattr(torch, dtype))
    page = image("resume_example").astype(np.float32) / 255.0
    crops = np.stack([page[y:y + 32, x:x + 128] for y in range(0, 320, 64)
                      for x in range(0, 384, 128)])
    jcfg = JaxParseqConfig(**dataclasses.asdict(pcfg))
    want = jax.jit(lambda p, v: jparseq.parseq_encode(
        p, v, jcfg, compute_dtype=getattr(jnp, dtype)))(jq, crops)
    with torch.no_grad():
        got = m.encode(torch.from_numpy(crops))
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= MEMORY_ATOL[dtype], f"max abs err {err}"


CONFIGS = {
    "quantized": lambda **k: OcrConfig(quantized_serving=True, **k),
    "production_xla": lambda **k: OcrConfig.production(encoder_impl="xla", **k),
}


@pytest.fixture(scope="module")
def engines(folded, record):  # noqa: F811
    return {name: tuatara_tpu_torch.OcrEngine(make(**record["config"]), weights_dir=folded[0],
                                              device="cpu")
            for name, make in CONFIGS.items()}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_matches_jax_fp32(engines, record, config):
    engine = engines[config]
    assert engine.parseq.quantized and engine.craft.quantized
    assert engine.parseq.enc_stacked is None
    for name, want in record[config].items():
        assert_same_words(engine.run(image(name)), want)


def test_calibration_matches_jax_and_files_cross_load(engines, record, folded, tmp_path):  # noqa: F811
    """calibrate the int8 encoder engine on the record's two pages: JAX's
    scales for CRAFT and the encoder; then its words; the JAX engine's file
    loads into the port and the port's into JAX's quantized trees."""
    engine = tuatara_tpu_torch.OcrEngine(CONFIGS["quantized"](**record["config"]),
                                         weights_dir=folded[0], device="cpu")
    pages = [image(n)[None] for n in record["calibration"]["pages"]]
    n_craft, n_enc = len(engine.craft.qconvs()), len(engine.parseq.qlinears())
    assert engine.calibrate(pages) == record["calibration"]["layers"] == n_craft + n_enc
    for name, want in record["calibrated"].items():
        assert_same_words(engine.run(image(name)), want)
    ppath = str(tmp_path / "port.npz")
    assert engine.save_calibration(ppath) == ppath
    jz, pz = dict(np.load(JAX_CALIBRATION)), dict(np.load(ppath))
    assert sorted(pz) == sorted(jz)
    assert sum(k.startswith("parseq/") for k in jz) == n_enc
    for k in jz:
        np.testing.assert_allclose(pz[k], jz[k], rtol=CALIB_RTOL, atol=0)
    craft_sx, parseq_sx = W.load_calibration(JAX_CALIBRATION)
    W.apply_static_scales(engine.parseq, parseq_sx)
    for name, q in engine.parseq.qlinears():
        assert float(q.sx) == float(jz[f"parseq/{name}/sx"])
    jtree = jparseq.quantize_parseq_encoder(
        jax.tree_util.tree_map(jnp.asarray, W.load_weights_dir(GOLDEN)[1]))
    assert JW.apply_static_scales(jtree, JW.load_calibration(ppath)[1]) == n_enc
    for name, _ in engine.parseq.qlinears():
        assert float(_node(jtree, name)["sx"]) == float(pz[f"parseq/{name}/sx"])
    wdir = tmp_path / "weights"
    shutil.copytree(folded[0], wdir)
    shutil.copy(JAX_CALIBRATION, wdir / W.CALIB_FILE)
    loaded = tuatara_tpu_torch.OcrEngine(CONFIGS["quantized"](max_label_length=7),
                                         weights_dir=str(wdir), device="cpu")
    for name, q in loaded.parseq.qlinears():
        assert float(q.sx) == float(jz[f"parseq/{name}/sx"])
    # Under the K6 encoder the recognizer stays float: its scales are
    # ignored, the detector's applied.
    composed = tuatara_tpu_torch.OcrEngine(OcrConfig.production(max_label_length=7),
                                           weights_dir=str(wdir), device="cpu")
    assert not composed.parseq.quantized and not composed.parseq.qlinears()
    assert all(q.sx is not None for _, q in composed.craft.qconvs())


def test_engine_record_is_live_jax(record, folded):  # noqa: F811
    """The JAX engine with the int8 encoder, live on one page, equals its
    record."""
    assert record["config"] == {"compute_dtype": "float32", "max_label_length": 7}
    jax_engine = JaxEngine(JaxOcrConfig(quantized_serving=True, **record["config"]),
                           weights_dir=folded[0])
    assert_same_words(words(jax_engine.run(image("rotated_text"))),
                      record["quantized"]["rotated_text"], atol=1e-6)


def test_serving_with_dynamic_int8_encoder(record, folded):  # noqa: F811
    """Dynamic scales span the slab. On the serving batches JAX's stream
    equals its run_pages loop (its record); the port's stream and loop,
    each from a fresh engine, equal JAX's."""
    serving = record["serving"]
    assert serving["stream_results"] == serving["loop_results"]
    cfg = dict(serving["config"], rec_buckets=tuple(serving["config"]["rec_buckets"]))

    def fresh():
        return tuatara_tpu_torch.OcrEngine(OcrConfig(**cfg), weights_dir=folded[0], device="cpu")

    stream = fresh().run_stream(stream_batches(), prefetch=2, depth=1)
    engine = fresh()
    loop = [engine.run_pages(b) for b in stream_batches()]
    for got_s, got_l, want in zip(stream, loop, serving["stream_results"]):
        for s, lp, w in zip(got_s, got_l, want):
            assert [x["text"] for x in s] == [x["text"] for x in lp]
            if w:
                assert_same_words(s, w)
                assert_same_words(lp, w)
            else:
                assert s == lp == []
