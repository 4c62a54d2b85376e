"""Engines with no weights: the port draws its models at random from a seed
(`api.random_trees`, JAX's `OcrEngine(seed=)`).

The draws need not equal JAX's (another generator), so the tests hold
what JAX's initialisers promise: the trees' keys and shapes (against
`init_craft_params` / `init_parseq_params`, by `jax.eval_shape`, at a small
configuration and at full width), the deterministic leaves exactly, each
random leaf's spread within STD_RTOL of its distribution's and its bounds
(truncation at 2 std, xavier's limit), and determinism in the seed. One
live case serves the port's draws through JAX's engine: equal words and
bboxes at fp32. Then served runs with no weights: the default, int8, the
extended charset and the command line.
"""

import dataclasses
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import tuatara_tpu_torch
from tuatara_tpu_torch.api import random_trees
from tuatara_tpu_torch.config import CraftConfig, OcrConfig, ParseqConfig
from tuatara_tpu_torch.tokenizer import EXTENDED_CHARSET
from tuatara_tpu_torch.utils.image import save_image
from tuatara_tpu_torch.utils.weights import flatten_tree, save_weights_dir

from chip_smoke import example_page
from torch_common import ROOT, torch_threads  # noqa: F401

SMALL_CRAFT = CraftConfig(stage_channels=(8, 16, 16, 16, 16), fc_channels=16,
                          up_channels=((16, 16), (16, 16), (16, 8), (8, 8)),
                          head_channels=(8, 8, 8, 8))
SMALL_PARSEQ = ParseqConfig(embed_dim=32, enc_depth=1, enc_heads=4, dec_heads=4,
                            max_label_length=7)
CONFIGS = {"small": (SMALL_CRAFT, SMALL_PARSEQ), "full": (CraftConfig(), ParseqConfig())}
STD_RTOL = 0.05  # a leaf's std against its distribution's, on leaves of >= MOMENT_MIN
MOMENT_MIN = 10_000
TRUNC_STD = 0.02 * 0.8796256610342398  # std 0.02 times that of N(0, 1) cut at +-2


@pytest.fixture(scope="module")
def full_trees():
    return tuple(flatten_tree(t) for t in random_trees(CraftConfig(), ParseqConfig(), 0))


def _jax_shapes(craft_cfg, parseq_cfg):
    from tuatara_tpu.config import CraftConfig as JC, ParseqConfig as JP
    from tuatara_tpu.models.craft import init_craft_params
    from tuatara_tpu.models.parseq import init_parseq_params

    jc = JC(**dataclasses.asdict(craft_cfg))
    jp = JP(**dataclasses.asdict(parseq_cfg))
    key = jax.random.PRNGKey(0)
    out = []
    for init, cfg in ((init_craft_params, jc), (init_parseq_params, jp)):
        tree = jax.eval_shape(lambda k, f=init, c=cfg: f(k, c), key)
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        out.append({"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
                    tuple(leaf.shape) for path, leaf in leaves})
    return out


@pytest.mark.parametrize("size", sorted(CONFIGS))
def test_random_trees_have_jax_keys_and_shapes(size, full_trees):
    craft_cfg, parseq_cfg = CONFIGS[size]
    trees = (full_trees if size == "full"
             else tuple(flatten_tree(t) for t in random_trees(craft_cfg, parseq_cfg, 0)))
    for got, want in zip(trees, _jax_shapes(craft_cfg, parseq_cfg)):
        assert {k: v.shape for k, v in got.items()} == want
        assert all(v.dtype == np.float32 for v in got.values())


def _distribution(tree: str, path: str, shape):
    """(kind, std, bound) of a leaf as JAX draws it: "zeros", "ones", or a
    random leaf with its std and its bound (None: unbounded)."""
    name = path.split("/")[-1]
    if name in ("b", "bias", "mean"):
        return "zeros", 0.0, None
    if name in ("scale", "var"):
        return "ones", 0.0, None
    if tree == "craft":  # he-normal convs, HWIO
        kh, kw, cin, _ = shape
        return "random", math.sqrt(2.0 / (kh * kw * cin)), None
    if "attn/" in path:  # xavier-uniform projections [in, out]
        limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
        return "random", limit / math.sqrt(3.0), limit
    return "random", TRUNC_STD, 2 * 0.02


def test_random_leaves_follow_jax_distributions(full_trees):
    """Full width: zero biases and BN means, unit LayerNorm / BN scales and
    BN variances exactly; every random leaf within its bound, and its std
    within STD_RTOL of the distribution's on leaves of MOMENT_MIN or more
    elements, its mean near 0."""
    checked = 0
    for tree, flat in zip(("craft", "parseq"), full_trees):
        for path, a in flat.items():
            kind, std, bound = _distribution(tree, path, a.shape)
            if kind == "zeros":
                assert not a.any(), path
            elif kind == "ones":
                assert (a == 1).all(), path
            else:
                if bound is not None:
                    assert np.abs(a).max() <= bound * (1 + 1e-6), path
                if a.size >= MOMENT_MIN:
                    assert abs(a.std() / std - 1) < STD_RTOL, (path, a.std(), std)
                    assert abs(a.mean()) < 5 * std / math.sqrt(a.size), path
                    checked += 1
    assert checked > 50


def _state(engine):
    return {**{f"craft.{k}": v for k, v in engine.craft.state_dict().items()},
            **{f"parseq.{k}": v for k, v in engine.parseq.state_dict().items()}}


def test_seed_gives_bit_equal_weights():
    cfg = OcrConfig(max_label_length=7)

    def state(seed):
        return _state(tuatara_tpu_torch.OcrEngine(cfg, SMALL_CRAFT, SMALL_PARSEQ, seed=seed,
                                                  device="cpu"))

    a, b, c = state(3), state(3), state(4)
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a if a[k].is_floating_point())


def test_jax_serves_the_port_draws_equally(tmp_path):
    """The port's random engine at fp32, and JAX's engine on the trees the
    port drew (saved as a weights directory), give equal words and bboxes."""
    from tuatara_tpu.api import OcrEngine as JaxEngine
    from tuatara_tpu.config import OcrConfig as JaxConfig

    seed, page = 5, example_page()
    save_weights_dir(str(tmp_path), *random_trees(SMALL_CRAFT, SMALL_PARSEQ, seed),
                     SMALL_CRAFT, SMALL_PARSEQ)
    port = tuatara_tpu_torch.OcrEngine(OcrConfig(compute_dtype="float32", max_label_length=7),
                                       SMALL_CRAFT, SMALL_PARSEQ, seed=seed, device="cpu")
    got = port.run(page)
    want = JaxEngine(JaxConfig(compute_dtype="float32", max_label_length=7),
                     weights_dir=str(tmp_path)).run(page)
    assert len(want) > 0
    assert [(w["text"], w["bbox"]) for w in got] == [(w["text"], w["bbox"]) for w in want]
    np.testing.assert_allclose([w["confidence"] for w in got],
                               [w["confidence"] for w in want], rtol=1e-4, atol=1e-30)


@pytest.mark.parametrize("variant", ["default", "quantized", "extended_charset"])
def test_engine_with_no_weights_serves(variant, caplog):
    """Full width, no weights_dir: the engine draws its models, warns, and
    serves a page; int8 quantizes the drawn fp32 weights; the extended
    charset takes a 95-class head."""
    parseq_cfg = None
    cfg = OcrConfig()
    if variant == "quantized":
        cfg = OcrConfig(quantized_serving=True)
    elif variant == "extended_charset":
        cfg, parseq_cfg = OcrConfig(charset=EXTENDED_CHARSET), ParseqConfig(charset_size=95)
    with caplog.at_level("WARNING", logger="tuatara_tpu_torch"):
        engine = tuatara_tpu_torch.OcrEngine(cfg, parseq_config=parseq_cfg, device="cpu")
    assert "RANDOM weights" in caplog.text
    assert engine.weights_dir is None
    if variant == "quantized":
        assert engine.craft.quantized and engine.parseq.quantized
    if variant == "extended_charset":
        assert engine.parseq_config.charset_size == 95
        assert engine.parseq_config.num_tokens == engine.tokenizer.vocab_size
    words = engine.run(example_page())
    assert len(words) > 0
    assert all(set(w) == {"text", "bbox", "confidence"} for w in words)
    # The module-level entry point serves the same weights (seed 0).
    if variant == "default":
        assert tuatara_tpu_torch.image_to_data(example_page(), device="cpu") == words


def test_cli_with_no_weights(tmp_path):
    path = os.path.join(tmp_path, "page.png")
    save_image(path, example_page())
    proc = subprocess.run([sys.executable, "-m", "tuatara_tpu_torch", path, "--device", "cpu"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "RANDOM weights" in proc.stderr
    assert len([line for line in proc.stdout.splitlines() if line.startswith("{")]) > 0
