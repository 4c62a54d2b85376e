"""Checkpoints of the port's training (`train/checkpoint.py`) and the
weights directories either package writes.

* On the CPU, save after step 1, load into a fresh state (drawn from
  another seed), take step 2: parameters, running statistics, Adam's state
  and the metrics bit-identical to two straight steps, as JAX's
  `test_checkpoint_resume_bit_identical` holds JAX's.
* A port checkpoint loads in JAX's `load_weights_dir` / `load_configs` with
  the arrays equal to the port's (JAX's layout, the head unpadded) and
  `config.json` equal to the one JAX's `save_weights_dir` writes; a
  directory JAX's `save_weights_dir` writes loads in the port's trainable
  modules with the arrays equal.
* The optimizer file is keyed by JAX's parameter paths, in JAX's layouts;
  it holds no moment for a running statistic.
* A step-0 checkpoint of the golden weights (loaded into the trainable
  modules and saved back) is bit-equal to them, file for file.
* A checkpoint the port trained (one fp32 step from the golden weights)
  gives the same words on a reference page in the port's
  `OcrEngine(device="cpu")` and JAX's `OcrEngine` (live), at fp32.
"""

import json
import os

import numpy as np
import pytest
import torch

from gen_torch_train import TINY, jax_tiny_params, load_record, tiny_batch, tiny_configs
from torch_common import GOLDEN, assert_same_words, image, torch_threads, words  # noqa: F401
import tuatara_tpu.utils.weights as JW
from tuatara_tpu.config import CraftConfig as JCraftConfig, ParseqConfig as JParseqConfig
import tuatara_tpu_torch
from tuatara_tpu_torch.config import CraftConfig, OcrConfig, ParseqConfig
from tuatara_tpu_torch.tokenizer import Tokenizer
from tuatara_tpu_torch.train.checkpoint import (META_FILE, OPT_FILE, latest_step,
                                                load_checkpoint, save_checkpoint)
from tuatara_tpu_torch.train.trainer import AdamW, init_train_state, train_step
from tuatara_tpu_torch.utils import weights as W
from tuatara_tpu_torch.utils.data import detection_batch
from tuatara_tpu_torch.weights import load_tree, module_flat

TC, TP = tiny_configs(CraftConfig, ParseqConfig)


def batch():
    return {k: torch.from_numpy(v) for k, v in tiny_batch(detection_batch, Tokenizer()).items()}


def perms():
    return torch.from_numpy(load_record(TINY)["perms"]).long()


def state_flat(state):
    out = {f"craft/{k}": v for k, v in module_flat(state.craft).items()}
    out.update({f"parseq/{k}": v for k, v in module_flat(state.parseq).items()})
    return out


def test_resume_is_bit_identical(tmp_path):
    b, p = batch(), perms()
    a, tx = init_train_state(craft_cfg=TC, parseq_cfg=TP, device="cpu", params=jax_tiny_params())
    a, _ = train_step(a, b, tx, perms=p)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, a, craft_config=TC, parseq_config=TP)
    assert latest_step(ckpt) == 1
    assert latest_step(str(tmp_path / "none")) is None
    a, ma = train_step(a, b, tx, perms=p)

    template, _ = init_train_state(torch.Generator().manual_seed(42), TC, TP, tx=tx,
                                   device="cpu")
    r = load_checkpoint(ckpt, template)
    assert r is template and r.step == 1 and r.opt_state.count == 1
    r, mr = train_step(r, b, tx, perms=p)
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mr.items()}
    fa, fr = state_flat(a), state_flat(r)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fr[k], err_msg=k)
    for k in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[k], r.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], r.opt_state.nu[k]), k
    # Without a template the directory's config.json builds the models.
    s = load_checkpoint(ckpt, device="cpu")
    assert s.craft.cfg == TC and s.parseq.cfg == TP and s.step == 1


def test_optimizer_file_is_keyed_by_jax_paths(tmp_path):
    state, tx = init_train_state(craft_cfg=TC, parseq_cfg=TP, device="cpu",
                                 params=jax_tiny_params())
    state, _ = train_step(state, batch(), tx, perms=perms())
    save_checkpoint(str(tmp_path), state)
    with np.load(os.path.join(tmp_path, OPT_FILE)) as z:
        keys = set(z.files)
        w = z["mu/craft/vgg/conv1_1/conv/w"]
        q = z["nu/parseq/enc/0/attn/q/w"]
        assert int(z["count"]) == 1
    assert w.shape == (3, 3, 3, 8)  # HWIO, as JAX holds it
    assert q.shape == (32, 32)
    np.testing.assert_array_equal(
        q, state.opt_state.nu["parseq/enc/0/attn/q/w"].t().numpy())
    assert not any(k.endswith(("/mean", "/var")) for k in keys)
    assert {k[3:] for k in keys if k.startswith("mu/")} == set(state.params())
    with np.load(os.path.join(tmp_path, META_FILE)) as z:
        assert int(z["step"]) == 1


def test_directories_cross_load(tmp_path):
    state, tx = init_train_state(craft_cfg=TC, parseq_cfg=TP, device="cpu",
                                 params=jax_tiny_params())
    state, _ = train_step(state, batch(), tx, perms=perms())
    port_dir = str(tmp_path / "port")
    save_checkpoint(port_dir, state, craft_config=TC, parseq_config=TP,
                    charset=Tokenizer().charset)
    craft, parseq = JW.load_weights_dir(port_dir)
    got = {**{f"craft/{k}": v for k, v in JW.flatten_tree(craft).items()},
           **{f"parseq/{k}": v for k, v in JW.flatten_tree(parseq).items()}}
    want = state_flat(state)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["parseq/head/w"].shape == (32, 95)
    jc, jp, charset = JW.load_configs(port_dir)
    jtc, jtp = tiny_configs(JCraftConfig, JParseqConfig)
    assert (jc, jp, charset) == (jtc, jtp, Tokenizer().charset)
    jax_dir = str(tmp_path / "jax")
    JW.save_weights_dir(jax_dir, craft, parseq, craft_config=jtc, parseq_config=jtp,
                        charset=Tokenizer().charset)
    with open(os.path.join(port_dir, W.CONFIG_FILE)) as f, \
            open(os.path.join(jax_dir, W.CONFIG_FILE)) as g:
        assert json.load(f) == json.load(g)
    # and back: JAX's directory into fresh trainable modules
    ct, pt = W.load_weights_dir(jax_dir)
    fresh, _ = init_train_state(torch.Generator().manual_seed(3), TC, TP, device="cpu")
    load_tree(fresh.craft, ct)
    load_tree(fresh.parseq, pt)
    back = state_flat(fresh)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_step0_checkpoint_is_the_golden_weights(tmp_path):
    craft_cfg, parseq_cfg, _ = W.load_configs(GOLDEN)
    state, _ = init_train_state(craft_cfg=craft_cfg, parseq_cfg=parseq_cfg, device="cpu",
                                params=W.load_weights_dir(GOLDEN))
    ckpt = str(tmp_path / "step0")
    save_checkpoint(ckpt, state, craft_config=craft_cfg, parseq_config=parseq_cfg)
    for name in (W.CRAFT_FILE, W.PARSEQ_FILE):
        with np.load(os.path.join(GOLDEN, name)) as want, np.load(os.path.join(ckpt, name)) as got:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One fp32 joint step (lr 1e-4) from the golden weights, saved."""
    craft_cfg, parseq_cfg, _ = W.load_configs(GOLDEN)
    state, tx = init_train_state(craft_cfg=craft_cfg, parseq_cfg=parseq_cfg, device="cpu",
                                 params=W.load_weights_dir(GOLDEN), tx=AdamW(lr=1e-4))
    state, _ = train_step(state, batch(), tx, perms=perms(), compute_dtype=torch.float32)
    ckpt = str(tmp_path_factory.mktemp("trained"))
    save_checkpoint(ckpt, state, craft_config=craft_cfg, parseq_config=parseq_cfg)
    return ckpt


def test_trained_checkpoint_serves_the_same_words_in_both_engines(trained):
    from tuatara_tpu.api import OcrEngine as JaxEngine
    from tuatara_tpu.config import OcrConfig as JaxOcrConfig

    cfg = {"max_label_length": 7, "compute_dtype": "float32"}
    page = image("rotated_text")
    want = words(JaxEngine(JaxOcrConfig(**cfg), weights_dir=trained).run(page))
    got = tuatara_tpu_torch.OcrEngine(OcrConfig(**cfg), weights_dir=trained,
                                      device="cpu").run(page)
    assert_same_words(got, want)
