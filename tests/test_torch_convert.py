"""The port's weight converter (`tuatara_tpu_torch/utils/convert.py`) and its
command line against the JAX package's.

The reference's TorchScript artifacts are not in the repository, so the
artifacts here are surrogates with the upstream naming
(`tests/torch_surrogates.py`), traced with `torch.jit.trace` and saved
under the reference's file names, as `tests/test_torchscript_roundtrip.py`
builds them:

* live JAX: the committed golden weights, mapped back to upstream names and
  traced, converted by both packages: every npz leaf bit-equal (dtype,
  shape, values) and equal to the golden tree, config.json equal, the
  probe's verdicts equal;
* artifacts whose traced graphs normalize inside (CRAFT behind ImageNet's
  mean/std, PARSEQ behind 2x-1, and ImageNet's statistics in BGR order):
  the port's verdicts equal JAX's (live), the transform is baked into the
  saved configs, and an engine built on the directory applies it;
* the engine's CRAFT (JAX's and the port's) pools after a ReLU that
  upstream CRAFT does not apply (ROADMAP Queue 3, item 16): the port
  equals JAX and a replica with that ReLU, not upstream's;
* the converted directory served by the port at fp32 on the CPU gives JAX's
  engine's words and bboxes on `funsd_0001129658` and `rotated_text` (JAX's
  record `tests/fixtures/torch_engine_golden.json`);
* the name maps' robustness, ported from `tests/test_convert.py`: wrapper
  prefixes stripped, the nearest-key KeyError, plain / wrapped / pickled
  checkpoints, an unreadable file; a checkpoint with no graph is converted
  with the probe "skipped";
* `python -m tuatara_tpu_torch.convert` on full-width surrogates with
  `--device cpu`.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tuatara_tpu.config import CraftConfig as JaxCraftConfig, ParseqConfig as JaxParseqConfig
from tuatara_tpu.utils import convert as JC
import tuatara_tpu_torch
from tuatara_tpu_torch.config import CraftConfig, OcrConfig, ParseqConfig
from tuatara_tpu_torch.utils import convert as C
from tuatara_tpu_torch.utils import weights as W

from torch_common import GOLDEN, ROOT, assert_same_words, image, torch_threads  # noqa: F401
from torch_surrogates import (IMAGENET_BGR, Normalized, TorchCraft, TorchParseq,
                              randomize_bn_stats, save_traced, upstream_replicas)

RECORD = os.path.join(ROOT, "tests", "fixtures", "torch_engine_golden.json")
PAGES = ("funsd_0001129658", "rotated_text")
IMAGENET = (C.IMAGENET_MEAN, C.IMAGENET_STD)
PM1 = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))


def golden():
    craft_cfg, parseq_cfg, _ = W.load_configs(GOLDEN)
    craft_tree, parseq_tree = W.load_weights_dir(GOLDEN)
    return craft_cfg, parseq_cfg, craft_tree, parseq_tree


def jax_configs(craft_cfg, parseq_cfg):
    def to_jax(cls, cfg):
        return cls(**{k: v for k, v in dataclasses.asdict(cfg).items()
                      if k in cls.__dataclass_fields__})

    return to_jax(JaxCraftConfig, craft_cfg), to_jax(JaxParseqConfig, parseq_cfg)


def npz_equal(a_path, b_path):
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Golden weights -> upstream replicas -> traced artifacts -> converted
    by both packages. -> (reference dir, port dir, JAX dir, verdicts port,
    verdicts JAX)."""
    craft_cfg, parseq_cfg, craft_tree, parseq_tree = golden()
    ref = str(tmp_path_factory.mktemp("reference"))
    save_traced(ref, *upstream_replicas(craft_tree, parseq_tree, craft_cfg, parseq_cfg))
    port, jax_dir = str(tmp_path_factory.mktemp("port")), str(tmp_path_factory.mktemp("jax"))
    v_port = C.convert_torchscript_weights(ref, port, craft_cfg, parseq_cfg, device="cpu")
    v_jax = JC.convert_torchscript_weights(ref, jax_dir, *jax_configs(craft_cfg, parseq_cfg))
    return ref, port, jax_dir, v_port, v_jax


@pytest.fixture(scope="module")
def normalized(tmp_path_factory):
    """Artifacts whose graphs normalize inside: CRAFT behind ImageNet's
    statistics and PARSEQ behind 2x-1 (set "a"); CRAFT behind ImageNet's in
    BGR order and PARSEQ behind ImageNet's (set "b"). -> {set: (port dir,
    port verdicts, JAX verdicts)}."""
    craft_cfg, parseq_cfg, craft_tree, parseq_tree = golden()
    craft, parseq = upstream_replicas(craft_tree, parseq_tree, craft_cfg, parseq_cfg)
    sets = {"a": (IMAGENET, PM1), "b": (IMAGENET_BGR, IMAGENET)}
    out = {}
    for name, (cn, pn) in sets.items():
        ref = str(tmp_path_factory.mktemp(f"reference_{name}"))
        save_traced(ref, Normalized(craft, *cn).eval(), Normalized(parseq, *pn).eval())
        port = str(tmp_path_factory.mktemp(f"port_{name}"))
        v_port = C.convert_torchscript_weights(ref, port, craft_cfg, parseq_cfg, device="cpu")
        v_jax = JC.convert_torchscript_weights(ref, str(tmp_path_factory.mktemp(f"jax_{name}")),
                                               *jax_configs(craft_cfg, parseq_cfg))
        out[name] = (port, v_port, v_jax)
    return out


@pytest.mark.parametrize("fname", [W.CRAFT_FILE, W.PARSEQ_FILE])
def test_converted_leaves_bit_equal_to_jax(converted, fname):
    _, port, jax_dir, _, _ = converted
    npz_equal(os.path.join(port, fname), os.path.join(jax_dir, fname))
    npz_equal(os.path.join(port, fname), os.path.join(GOLDEN, fname))


def test_converted_config_equal_to_jax(converted):
    _, port, jax_dir, v_port, v_jax = converted
    with open(os.path.join(port, W.CONFIG_FILE)) as a, \
            open(os.path.join(jax_dir, W.CONFIG_FILE)) as b:
        assert json.load(a) == json.load(b)
    assert v_port == v_jax == {"craft": "identity", "parseq": "identity"}


@pytest.mark.parametrize("name,want", [("a", {"craft": "imagenet", "parseq": "pm1"}),
                                       ("b", {"craft": "imagenet_bgr", "parseq": "imagenet"})])
def test_probe_verdicts_equal_jax_and_are_baked(normalized, name, want):
    port, v_port, v_jax = normalized[name]
    assert v_port == v_jax == want
    craft_cfg, parseq_cfg, _ = W.load_configs(port)
    for cfg, verdict in ((craft_cfg, want["craft"]), (parseq_cfg, want["parseq"])):
        mean, std = C.NORM_CANDIDATES[verdict]
        assert tuple(cfg.input_mean) == tuple(mean) and tuple(cfg.input_std) == tuple(std)


def test_baked_normalization_is_served(normalized):
    """The port's forward on a directory with a baked transform equals the
    normalizing traced graph (PARSEQ's logits, fp32)."""
    port, _, _ = normalized["a"]
    craft_cfg, parseq_cfg, craft_tree, parseq_tree = golden()
    _, inner = upstream_replicas(craft_tree, parseq_tree, craft_cfg, parseq_cfg)
    traced = Normalized(inner, *PM1).eval()
    eng = tuatara_tpu_torch.OcrEngine(OcrConfig(max_label_length=7, compute_dtype="float32"),
                                      weights_dir=port, device="cpu")
    x = np.random.default_rng(1).random((3, 32, 128, 3)).astype(np.float32)
    with torch.no_grad():
        want = traced(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
        got = eng.parseq(torch.from_numpy(x), early_exit=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_probe_unknown_on_other_transform_and_shape():
    craft_cfg, parseq_cfg, craft_tree, parseq_tree = golden()
    craft, parseq = upstream_replicas(craft_tree, parseq_tree, craft_cfg, parseq_cfg)
    odd = Normalized(parseq, (0.2, 0.9, 0.1), (3.0, 0.1, 7.0)).eval()
    tree = C.convert_parseq_state_dict({k: v.numpy() for k, v in parseq.state_dict().items()},
                                       parseq_cfg)
    assert C.probe_input_normalization(odd, tree, "parseq", parseq_cfg, device="cpu") == "unknown"

    class Trimmed(torch.nn.Module):  # an output of another shape
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x):
            return self.inner(x)[:, :-1]

    assert C.probe_input_normalization(Trimmed(parseq), tree, "parseq", parseq_cfg,
                                       device="cpu") == "unknown"
    with pytest.raises(ValueError, match="model"):
        C.probe_input_normalization(craft, tree, "vgg", craft_cfg, device="cpu")


def test_engine_craft_pools_after_a_relu_unlike_upstream():
    """ROADMAP Queue 3, item 16: the JAX package's CRAFT, and so the port's,
    applies a ReLU to conv5_2's BatchNorm output before the fc stage's 3x3
    max pool; upstream CRAFT pools the BatchNorm output itself. On the
    golden weights at fp32 the port equals JAX and the replica with that
    ReLU within 1e-5, and upstream's replica is 4.5e-3 away (max abs)."""
    import jax
    import jax.numpy as jnp

    from tuatara_tpu.models.craft import craft_forward

    craft_cfg, parseq_cfg, craft_tree, parseq_tree = golden()
    x = np.random.default_rng(0).random((1, 64, 96, 3)).astype(np.float32)
    port = C._port_forward("craft", craft_tree, craft_cfg, torch.device("cpu"))(x)
    want = np.asarray(craft_forward(jax.tree.map(jnp.asarray, craft_tree), jnp.asarray(x),
                                    jax_configs(craft_cfg, parseq_cfg)[0],
                                    compute_dtype=jnp.float32)[0])
    np.testing.assert_allclose(port, want, rtol=0, atol=1e-5)
    out = {}
    for relu in (False, True):
        craft, _ = upstream_replicas(craft_tree, parseq_tree, craft_cfg, parseq_cfg,
                                     relu_before_fc=relu)
        with torch.no_grad():
            out[relu] = craft(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert np.abs(out[True] - port).max() < 1e-5
    assert np.abs(out[False] - port).max() > 1e-3


@pytest.mark.parametrize("name", PAGES)
def test_converted_weights_serve_jax_words(converted, name):
    _, port, _, _, _ = converted
    with open(RECORD) as f:
        record = json.load(f)
    engine = tuatara_tpu_torch.OcrEngine(OcrConfig(**record["config"]), weights_dir=port,
                                         device="cpu")
    assert_same_words(engine.run(image(name)), record["default"][name])


def test_craft_conversion_strips_wrapper_prefix():
    class Wrapper(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.net = inner

    craft_cfg, _, _, _ = golden()
    torch.manual_seed(0)
    m = randomize_bn_stats(TorchCraft(craft_cfg).eval())
    plain = W.flatten_tree(C.convert_craft_state_dict(
        {k: v.numpy() for k, v in m.state_dict().items()}, craft_cfg))
    wrapped_sd = {k: v.numpy() for k, v in Wrapper(m).state_dict().items()}
    assert all(k.startswith("net.") for k in wrapped_sd)
    wrapped = W.flatten_tree(C.convert_craft_state_dict(wrapped_sd, craft_cfg))
    assert plain.keys() == wrapped.keys()
    for k in plain:
        np.testing.assert_array_equal(plain[k], wrapped[k])


def _parseq_sd():
    _, parseq_cfg, _, _ = golden()
    torch.manual_seed(0)
    return {k: v.numpy() for k, v in TorchParseq(parseq_cfg).state_dict().items()}, parseq_cfg


def test_parseq_conversion_strips_wrapper_prefix():
    sd, cfg = _parseq_sd()
    plain = W.flatten_tree(C.convert_parseq_state_dict(sd, cfg))
    wrapped = W.flatten_tree(C.convert_parseq_state_dict(
        {f"system.model.{k}": v for k, v in sd.items()}, cfg))
    jax_plain = W.flatten_tree(JC.convert_parseq_state_dict(sd, jax_configs(*golden()[:2])[1]))
    assert plain.keys() == wrapped.keys() == jax_plain.keys()
    for k in plain:
        np.testing.assert_array_equal(plain[k], wrapped[k])
        np.testing.assert_array_equal(plain[k], jax_plain[k])


def test_missing_key_lists_nearest_actual_keys():
    sd, cfg = _parseq_sd()
    renamed = {k.replace("encoder.norm.", "encoder.final_norm."): v for k, v in sd.items()}
    with pytest.raises(KeyError) as ei:
        C.convert_parseq_state_dict(renamed, cfg)
    assert "encoder.norm.weight" in str(ei.value)
    assert "final_norm" in str(ei.value)


def test_load_torch_state_dict_accepts_plain_checkpoints(tmp_path):
    sd = {"a.weight": torch.tensor([[1.0, 2.0]]), "a.bias": torch.tensor([3.0])}
    p1 = str(tmp_path / "bare.pt")
    torch.save(sd, p1)
    np.testing.assert_array_equal(C._load_torch_state_dict(p1)["a.weight"], [[1.0, 2.0]])
    p2 = str(tmp_path / "wrapped.pt")
    torch.save({"epoch": 7, "state_dict": sd}, p2)
    np.testing.assert_array_equal(C._load_torch_state_dict(p2)["a.bias"], [3.0])
    p3 = str(tmp_path / "module.pt")
    torch.save({"model": torch.nn.Conv2d(3, 4, 3)}, p3)
    got = C._load_torch_state_dict(p3)
    assert set(got) == {"weight", "bias"} and got["weight"].shape == (4, 3, 3, 3)
    p4 = str(tmp_path / "garbage.pt")
    with open(p4, "wb") as f:
        f.write(b"not a torch file")
    with pytest.raises(ValueError, match="neither"):
        C._load_torch_state_dict(p4)


def test_plain_checkpoints_convert_with_probe_skipped(tmp_path, converted):
    """State dicts saved with torch.save under the reference names convert
    to the same leaves; there is no graph to probe."""
    craft_cfg, parseq_cfg, craft_tree, parseq_tree = golden()
    craft, parseq = upstream_replicas(craft_tree, parseq_tree, craft_cfg, parseq_cfg)
    ref = tmp_path / "ref"
    ref.mkdir()
    torch.save({"state_dict": craft.state_dict()}, str(ref / C.CRAFT_ARTIFACT))
    torch.save(parseq.state_dict(), str(ref / C.PARSEQ_ARTIFACT))
    out = str(tmp_path / "out")
    assert C.convert_torchscript_weights(str(ref), out, craft_cfg, parseq_cfg, device="cpu") \
        == {"craft": "skipped", "parseq": "skipped"}
    for fname in (W.CRAFT_FILE, W.PARSEQ_FILE):
        npz_equal(os.path.join(out, fname), os.path.join(converted[1], fname))


def test_convert_cli_full_width(tmp_path, capsys):
    """`python -m tuatara_tpu_torch.convert ref out --device cpu` at the
    default (full) widths."""
    from tuatara_tpu_torch import convert as cli

    torch.manual_seed(2)
    ref, out = str(tmp_path / "ref"), str(tmp_path / "out")
    save_traced(ref, TorchCraft(CraftConfig()).eval(), TorchParseq(ParseqConfig()).eval())
    assert cli.main([ref, out, "--device", "cpu"]) == 0
    assert "craft identity, parseq identity" in capsys.readouterr().out
    craft_tree, parseq_tree = W.load_weights_dir(out)
    assert craft_tree["vgg"]["conv5_2"]["conv"]["w"].shape == (3, 3, 512, 512)
    assert parseq_tree["patch_embed"]["w"].shape == (4 * 8 * 3, 384)
    assert len(parseq_tree["enc"]) == 12
    assert W.load_configs(out)[1] == ParseqConfig()
