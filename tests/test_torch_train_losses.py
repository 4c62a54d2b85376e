"""The port's training losses, initialisers and batch-statistics BatchNorm
against the JAX package.

* `perm_attention_masks` equal to JAX's (live) for the left-to-right order,
  its mirror and random orders, one at a time and batched;
  `gen_permutations`' rows 0-1 equal to JAX's and the row structure held;
* OHEM: the kept set and the loss equal to JAX's `craft_loss` (live; its
  forward replaced by a given prediction so that the mining alone is
  compared; the kept set read from the gradient), with random errors, with
  errors tied at the threshold (JAX keeps every tie: not an exact top-k),
  with no positive pixel, with fewer negatives than `n_neg`, and with a
  per-pixel confidence; a non-finite error is never kept;
* at fp32, JAX's parameters and JAX's permutations (k_perms 6): `craft_loss`
  and `parseq_plm_loss` within 1e-5 relative of the tiny record's, every
  gradient leaf within 1e-4 relative L2 of JAX's (measured at most 4e-5),
  but the leaves whose gradient is zero in exact arithmetic (see
  test_torch_train_step.py), which hold rounding noise in both;
* `BatchNorm` in training mode against JAX's `batchnorm_train` (live):
  output within 1e-5, the running mean and variance (the variance from
  the unbiased estimate) within 1e-6; in eval mode against `batchnorm`;
* the initialisers: the trees' paths and shapes equal to JAX's
  `init_craft_params` / `init_parseq_params`, the distributions' moments
  and bounds (the bits differ: torch.Generator is not jax.random), and a
  fixed generator gives the same model twice;
* `TrainableCraft.fold()` equals the serving `Craft` the loader builds
  from the same tree, and its eval-mode forward the served one's.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tuatara_tpu.train.losses as JL
from gen_torch_train import (TINY, jax_tiny_params, load_record, record_flat, tiny_batch,
                             tiny_configs)
from torch_common import torch_threads  # noqa: F401
from tuatara_tpu.models import layers as JLayers
from tuatara_tpu_torch.config import CraftConfig, ParseqConfig
from tuatara_tpu_torch.models.craft import Craft, TrainableCraft, init_craft
from tuatara_tpu_torch.models.layers import BatchNorm
from tuatara_tpu_torch.models.parseq import Parseq, init_parseq
from tuatara_tpu_torch.tokenizer import Tokenizer
from tuatara_tpu_torch.train.losses import (craft_loss, gen_permutations, ohem_keep,
                                            parseq_plm_loss, perm_attention_masks)
from tuatara_tpu_torch.train.trainer import param_layouts
from tuatara_tpu_torch.utils.data import detection_batch
from tuatara_tpu_torch.utils.weights import unflatten_tree
from tuatara_tpu_torch.weights import craft_state_dict, load_tree, module_tree, to_jax

TC, TP = tiny_configs(CraftConfig, ParseqConfig)
ZERO_GRAD = re.compile(r"craft/(vgg/conv\d_\d/conv|up/upconv\d/conv\d|fc/fc\d)/b$|attn/k/b$")


@pytest.mark.parametrize("max_len", [7, 25])
def test_perm_attention_masks_equal_jax(max_len):
    rng = np.random.default_rng(max_len)
    lr = np.arange(1, max_len + 1)
    perms = np.stack([lr, lr[::-1]] + [rng.permutation(lr) for _ in range(4)])
    want = np.stack([np.asarray(JL.perm_attention_masks(jnp.asarray(p), max_len))
                     for p in perms])
    got = perm_attention_masks(torch.from_numpy(perms), max_len).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(perm_attention_masks(torch.from_numpy(perms[3]), max_len)
                                  .numpy(), want[3])


def test_gen_permutations_rows():
    want = np.asarray(JL.gen_permutations(jax.random.PRNGKey(1), 25, 6))
    g = torch.Generator().manual_seed(5)
    got = gen_permutations(25, 6, g).numpy()
    np.testing.assert_array_equal(got[:2], want[:2])
    for r in range(1, 6, 2):
        np.testing.assert_array_equal(got[r], got[r - 1][::-1])
    for r in got:
        assert sorted(r) == list(range(1, 26))
    again = gen_permutations(25, 6, torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_array_equal(got, again)
    assert gen_permutations(25, 1, g).tolist() == [list(range(1, 26))]


def errors(case, rng, shape=(2, 16, 16, 2)):
    """(pred, target, confidence or None) for an OHEM case."""
    tgt = np.where(rng.random(shape) < 0.15, rng.random(shape), 0.0).astype(np.float32)
    conf = None
    if case == "tied":
        # Errors take four levels, so that n_neg falls inside a tie group.
        pred = tgt + rng.integers(1, 5, shape).astype(np.float32) * 0.125
    elif case == "no_pos":
        tgt = np.zeros(shape, np.float32)
        pred = rng.random(shape).astype(np.float32)
    elif case == "few_negs":
        tgt = np.where(rng.random(shape) < 0.9, 0.5, 0.0).astype(np.float32)
        pred = rng.random(shape).astype(np.float32)
    else:
        pred = rng.random(shape).astype(np.float32)
        if case == "confidence":
            conf = rng.random(shape[:3]).astype(np.float32)
    return pred, tgt, conf


@pytest.mark.parametrize("case", ["random", "tied", "no_pos", "few_negs", "confidence"])
def test_ohem_matches_jax(monkeypatch, case):
    rng = np.random.default_rng(7)
    pred, tgt, conf = errors(case, rng)
    monkeypatch.setattr(JL, "craft_forward_train", lambda p, images, cfg: (p, None, None))

    def jax_loss(p):
        return JL.craft_loss(p, None, jnp.asarray(tgt),
                             None if conf is None else jnp.asarray(conf))[0]

    want_loss, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(pred))
    kept_jax = np.asarray(want_grad) != 0

    tpred = torch.tensor(pred, requires_grad=True)
    loss, _ = craft_loss(lambda images, train_bn, compute_dtype: (tpred, None), None,
                         torch.from_numpy(tgt), None if conf is None else torch.from_numpy(conf))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    np.testing.assert_array_equal(tpred.grad.numpy() != 0, kept_jax)
    # The kept set itself, channel by channel (every error here is nonzero,
    # so the gradient marks it).
    err = (torch.from_numpy(pred) - torch.from_numpy(tgt)) ** 2
    if conf is not None:
        err = err * torch.from_numpy(conf)[..., None]
    for c in range(2):
        pos = torch.from_numpy(tgt[..., c]) > 0.1
        keep = ohem_keep(err[..., c], pos, 3.0) | pos
        np.testing.assert_array_equal(keep.numpy(), kept_jax[..., c])
    if case == "tied":
        e = err[..., 0][~torch.from_numpy(tgt[..., 0] > 0.1)]
        n_neg = min(int(3.0 * int((tgt[..., 0] > 0.1).sum())), e.numel())
        kept = int(ohem_keep(err[..., 0], torch.from_numpy(tgt[..., 0]) > 0.1, 3.0).sum())
        assert kept > n_neg  # ties at the threshold are all kept


def test_ohem_never_keeps_non_finite():
    """n_pos 1 -> n_neg 3. JAX's descending sort (numpy's ascending order,
    NaN last, reversed) puts NaN and inf first, so the third largest is
    2.0; the non-finite errors above it are not kept."""
    err = torch.tensor([[5.0, float("inf"), 1.0, float("nan"), 2.0, 0.5]])
    pos = torch.tensor([[True, False, False, False, False, False]])
    want = np.sort(np.where(pos.numpy(), -np.inf, err.numpy()).ravel())[::-1]
    assert want[2] == 2.0
    keep = ohem_keep(err, pos, 3.0)
    assert keep.tolist() == [[False, False, False, False, True, False]]


@pytest.fixture(scope="module")
def rec():
    return load_record(TINY)


def models():
    craft, parseq = jax_tiny_params()
    return load_tree(TrainableCraft(TC), craft), load_tree(Parseq(TP), parseq)


def test_losses_and_gradients_match_jax(rec):
    craft, parseq = models()
    b = {k: torch.from_numpy(v) for k, v in tiny_batch(detection_batch, Tokenizer()).items()}
    lc, mc = craft_loss(craft, b["pages"], b["heat"], compute_dtype=torch.float32)
    lp, mp = parseq_plm_loss(parseq, b["crops"], b["labels"], b["lengths"],
                             perms=torch.from_numpy(rec["perms"]), compute_dtype=torch.float32)
    np.testing.assert_allclose(float(lc), float(rec["fp32/m1/loss_craft"]), rtol=1e-5)
    np.testing.assert_allclose(float(lp), float(rec["fp32/m1/loss_parseq"]), rtol=1e-5)
    np.testing.assert_allclose(float(mc["craft_pos"]), float(rec["fp32/m1/craft_pos"]), rtol=1e-5)
    assert int(mc["craft_n_pos"]) == int(rec["fp32/m1/craft_n_pos"])
    (lc + lp).backward()
    grad = record_flat(rec, "fp32/grad")
    layouts = param_layouts(craft=craft, parseq=parseq)
    named = {**{f"craft/{k}": p for k, p in craft.named_parameters()},
             **{f"parseq/{k}": p for k, p in parseq.named_parameters()}}
    from tuatara_tpu_torch.train.trainer import trainable_params

    params = trainable_params(craft=craft, parseq=parseq)
    assert len(params) == len(named)
    checked = 0
    for k, p in params.items():
        if ZERO_GRAD.search(k):
            continue
        want = grad[k].astype(np.float64)
        got = to_jax(p.grad, layouts[k]).astype(np.float64)
        n = np.linalg.norm(want)
        assert np.linalg.norm(got - want) <= 1e-4 * n, k
        checked += 1
    assert checked == len(params) - 25


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_train_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 7, 8)) * 2 + 0.5).astype(np.float32)
    params = {"scale": rng.random(8).astype(np.float32) + 0.5,
              "bias": rng.standard_normal(8).astype(np.float32),
              "mean": rng.standard_normal(8).astype(np.float32) * 0.1,
              "var": rng.random(8).astype(np.float32) + 0.5}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    y, new = JLayers.batchnorm_train({k: jnp.asarray(v) for k, v in params.items()}, xj)
    bn = BatchNorm(8)
    load_tree(bn, params)
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    got = bn(xt, train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(new["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(new["var"]), rtol=1e-6, atol=1e-6)
    # eval mode: JAX `batchnorm` on the running statistics, buffers untouched
    want = JLayers.batchnorm(new, xj)
    got = bn(xt, train=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(new["mean"]), rtol=1e-6, atol=1e-6)


def shapes(tree):
    from tuatara_tpu.utils.weights import flatten_tree

    return {k: np.shape(v) for k, v in flatten_tree(tree).items()}


def test_init_trees_match_jax_layout():
    jcraft, jparseq = jax_tiny_params()
    g = torch.Generator().manual_seed(0)
    craft, parseq = init_craft(TC, g), init_parseq(TP, g)
    assert shapes(module_tree(craft)) == shapes(jcraft)
    assert shapes(module_tree(parseq)) == shapes(jparseq)


def test_init_distributions():
    cfg = ParseqConfig(embed_dim=64, enc_depth=2, enc_heads=4, dec_heads=4)
    craft = init_craft(CraftConfig(stage_channels=(16, 32, 32, 64, 64), fc_channels=64,
                                   up_channels=((32, 32), (32, 16), (16, 16), (16, 16)),
                                   head_channels=(16, 16, 8, 8)),
                       torch.Generator().manual_seed(1))
    parseq = init_parseq(cfg, torch.Generator().manual_seed(2))
    w = craft.vgg["conv4_1"]["conv"].weight
    fan_in = w.shape[1] * 9
    assert abs(float(w.std()) / np.sqrt(2.0 / fan_in) - 1) < 0.05
    assert float(craft.vgg["conv4_1"]["conv"].bias.abs().max()) == 0
    bn = craft.vgg["conv4_1"]["bn"]
    assert torch.equal(bn.weight, torch.ones_like(bn.weight)) and torch.equal(bn.var, torch.ones_like(bn.var))
    # trunc_normal(std 0.02): bounded at 2 sigma, std 0.02 * 0.8796
    t = parseq.text_embed
    assert float(t.abs().max()) <= 0.04 + 1e-7
    assert abs(float(t.std()) / (0.02 * 0.87962566) - 1) < 0.05
    # xavier_uniform: bounded at sqrt(6 / (fan_in + fan_out)), std limit / sqrt(3)
    q = parseq.enc[0].attn.q.weight
    limit = np.sqrt(6.0 / (2 * 64))
    assert float(q.abs().max()) <= limit
    assert abs(float(q.std()) / (limit / np.sqrt(3)) - 1) < 0.05
    assert float(parseq.head.bias.abs().max()) == 0
    assert torch.equal(parseq.enc_norm.weight, torch.ones(64))
    a = init_parseq(cfg, torch.Generator().manual_seed(2))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  parseq.state_dict().values()))


def test_fold_equals_the_served_craft():
    craft_tree = unflatten_tree(dict(jax_tiny_params()[0]))
    rng = np.random.default_rng(4)
    for blk in list(craft_tree["vgg"].values()) + list(craft_tree["up"].values()):
        for k, bn in blk.items():
            if k.startswith("bn"):
                bn["mean"] = rng.standard_normal(bn["mean"].shape).astype(np.float32) * 0.1
                bn["var"] = rng.random(bn["var"].shape).astype(np.float32) + 0.5
    model = load_tree(TrainableCraft(TC), craft_tree)
    served = Craft(TC)
    served.load_state_dict(craft_state_dict(craft_tree, TC.bn_eps))
    folded = model.fold()
    for (k, a), (_, b) in zip(folded.state_dict().items(), served.state_dict().items()):
        assert torch.equal(a, b), k
    x = torch.from_numpy(rng.random((1, 64, 96, 3)).astype(np.float32))
    with torch.no_grad():
        want, _ = served(x)
        got, _ = model(x, train_bn=False, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
