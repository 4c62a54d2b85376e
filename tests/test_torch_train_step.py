"""The port's joint training step and optimizer against JAX's.

The tiny JAX record (`tests/fixtures/torch_train_tiny.npz`, written by
`tests/gen_torch_train.py --part tiny`) holds two JAX `train_step`s from
`init_train_state(PRNGKey(0))` at the test configs, with JAX's permutations.
The port starts from the same parameters (JAX's init, drawn live here and
carried over) and takes the same steps:

* fp32 losses and metrics within 1e-5 relative of JAX's; the gradients'
  global norm within 1e-5 (the clip is active: it is ~50 and ~34 against
  the clip at 1.0);
* each leaf's update (after step 1 and after step 2) within 1e-3 of JAX's
  update's L2 norm, compared by L2. Left out of the comparison are the
  leaves whose gradient is zero in exact arithmetic, where both packages
  hold rounding noise (~1e-8) and Adam's first step, about lr * sign(g),
  moves each element by up to lr in either direction: a conv bias that
  reaches a batch-statistics BatchNorm through linear ops only (its mean
  subtraction cancels the bias) and the key bias of every attention
  (softmax ignores a shift of a whole row of logits); their gradients are
  held to be that small in both packages. Within the other leaves, the
  elements whose JAX gradient is nonzero but below 1e-3 of the leaf's
  largest are left out for the same reason (after the clip divides by ~50,
  their Adam step is set by eps = 1e-8 and by rounding: JAX's exact zeros
  among them are ~5e-9 here, and the reverse), and held to under 3% of the
  elements; so are the exact zeros of rows the batch never reaches (token
  embeddings of absent characters), where the gradient test holds both
  packages' gradients. Running statistics (JAX splices the train
  forward's over the optimizer's output; the port's forward updates its
  buffers) are compared by L2 whole: the means after step 1, and after
  step 2 in the resumed run below (a running mean absorbs its conv's bias,
  one of the leaves left out);
* with weight decay 0.01, the two-step update within the same bound;
* from JAX's optimizer state after step 1 (Adam's moments and count
  carried over, BatchNorm statistics' moments dropped), the port's step 2
  matches JAX's step 2 under the same bounds;
* at bf16, JAX's shipped precision, the losses within 2e-2 relative: the
  largest gap measured on this record is loss_craft at step 2, 1.07e-2 at
  2 torch threads and 8.0e-3 at 4 (bf16 products round differently in the
  two packages' kernels, and in torch's with the thread count; OHEM then
  keeps another set of negatives). Each leaf's first update norm within
  2e-2 relative (measured at most 6.6e-3; norms are robust to the sign
  flips above). The second step's update mixes two bf16 gradients whose
  small elements change sign between the packages, so a 16-element
  BatchNorm leaf's update norm moves by up to 33%: it is held per model,
  all leaves together, within 1e-2 (measured at most 3.1e-3);
* `train_bn=False`: the first step's fp32 metrics within 1e-5, the
  running statistics untouched. (JAX's optimizer also moves mean/var
  under train_bn=False, as ordinary leaves with nonzero gradients; the
  port keeps them frozen, the contract JAX's docstring states.)
* the optimizer's pieces against optax live: the clipping rule at a norm
  below and above the limit, a schedule's learning rate read at the
  0-based update count, adamw's decay of every leaf.
"""

import re

import numpy as np
import optax
import pytest
import torch
import jax.numpy as jnp

from gen_torch_train import (TINY, jax_tiny_params, load_record, record_flat, tiny_batch,
                             tiny_configs)
from torch_common import torch_threads  # noqa: F401
from tuatara_tpu.utils.weights import flatten_tree
from tuatara_tpu_torch.config import CraftConfig, ParseqConfig
from tuatara_tpu_torch.tokenizer import Tokenizer
from tuatara_tpu_torch.train.trainer import (AdamW, init_train_state, make_optimizer,
                                             moments_from_jax, param_layouts, train_step)
from tuatara_tpu_torch.utils.data import detection_batch
from tuatara_tpu_torch.weights import module_flat

TC, TP = tiny_configs(CraftConfig, ParseqConfig)
ZERO_GRAD = re.compile(r"craft/(vgg/conv\d_\d/conv|up/upconv\d/conv\d|fc/fc\d)/b$|attn/k/b$")
METRICS = ("loss", "loss_craft", "loss_parseq", "craft_pos", "craft_n_pos", "parseq_ce")


@pytest.fixture(scope="module")
def rec():
    return load_record(TINY)


def batch():
    return {k: torch.from_numpy(v) for k, v in tiny_batch(detection_batch, Tokenizer()).items()}


def fresh(tx=None, params=None):
    state, tx = init_train_state(craft_cfg=TC, parseq_cfg=TP, device="cpu", tx=tx,
                                 params=params or jax_tiny_params())
    return state, tx


def snapshot(state):
    return {**{f"craft/{k}": v for k, v in module_flat(state.craft).items()},
            **{f"parseq/{k}": v for k, v in module_flat(state.parseq).items()}}


def run_steps(rec, n, dtype=torch.float32, tx=None, train_bn=True, state=None):
    if state is None:
        state, tx = fresh(tx)
    perms = torch.from_numpy(rec["perms"]).long()
    snaps, metrics = [snapshot(state)], []
    for _ in range(n):
        state, m = train_step(state, batch(), tx, perms=perms, compute_dtype=dtype,
                              train_bn=train_bn)
        snaps.append(snapshot(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, snaps, metrics


def assert_metrics(got, rec, prefix, rtol):
    for k in METRICS:
        np.testing.assert_allclose(got[k], float(rec[f"{prefix}/{k}"]), rtol=rtol, err_msg=k)


def assert_updates(before, after, jax_before, jax_after, grad, tol=1e-3, means=True):
    """Each leaf's update within tol * ||JAX's update|| (L2), as the module
    docstring sets out; -> the share of elements left out. `means=False`
    leaves out the running means, after a step that started from the
    port's own step 1: a running mean absorbs its conv's bias, and the
    biases took their noise-driven first steps there."""
    left_out = total = 0
    for k, want_after in jax_after.items():
        if ZERO_GRAD.search(k) or (not means and k.endswith("/mean")):
            continue
        dj = want_after.astype(np.float64) - jax_before[k]
        dp = after[k].astype(np.float64) - before[k]
        if k.endswith(("/mean", "/var")):
            keep = np.ones(dj.shape, bool)
        else:
            g = np.abs(grad[k])
            keep = g >= 1e-3 * g.max()
            left_out += int(((~keep) & (g > 0)).sum())
        total += keep.size
        n = np.linalg.norm(dj[keep])
        err = np.linalg.norm((dp - dj)[keep])
        assert err <= tol * n, f"{k}: |d_port - d_jax| = {err:.3e} > {tol} * {n:.3e}"
    return left_out / total


def test_fp32_two_steps_match_jax(rec):
    _, snaps, metrics = run_steps(rec, 2)
    assert_metrics(metrics[0], rec, "fp32/m1", 1e-5)
    assert_metrics(metrics[1], rec, "fp32/m2", 1e-5)
    grad = record_flat(rec, "fp32/grad")
    jax0 = flatten_tree({"craft": jax_tiny_params()[0], "parseq": jax_tiny_params()[1]})
    p1, p2 = record_flat(rec, "fp32/p1"), record_flat(rec, "fp32/p2")
    share = assert_updates(snaps[0], snaps[1], jax0, p1, grad)
    share = max(share, assert_updates(snaps[1], snaps[2], p1, p2, grad, means=False))
    assert share < 0.03, share


def test_zero_gradient_leaves_are_rounding_noise(rec):
    """The leaves left out of the update comparison: gradients below 1e-6
    of the global norm in both packages (JAX's from the record)."""
    grad = record_flat(rec, "fp32/grad")
    gnorm = float(rec["fp32/gnorm"][0])
    state, _ = fresh()
    from tuatara_tpu_torch.train.losses import craft_loss, parseq_plm_loss

    b = batch()
    lc, _ = craft_loss(state.craft, b["pages"], b["heat"], compute_dtype=torch.float32)
    lp, _ = parseq_plm_loss(state.parseq, b["crops"], b["labels"], b["lengths"],
                            perms=torch.from_numpy(rec["perms"]).long(),
                            compute_dtype=torch.float32)
    (lc + lp).backward()
    zero = [k for k in grad if ZERO_GRAD.search(k)]
    assert len(zero) == 12 + 8 + 2 + 3  # trunk, decoder, fc6/fc7 convs; three attentions
    for k, p in state.params().items():
        if k in zero:
            assert np.linalg.norm(grad[k]) < 1e-6 * gnorm, k
            assert float(p.grad.norm()) < 1e-6 * gnorm, k


def test_weight_decay_two_steps_match_jax(rec):
    _, snaps, metrics = run_steps(rec, 2, tx=make_optimizer(weight_decay=0.01))
    assert_metrics(metrics[0], rec, "fp32wd/m1", 1e-5)
    assert_metrics(metrics[1], rec, "fp32wd/m2", 1e-5)
    jax0 = flatten_tree({"craft": jax_tiny_params()[0], "parseq": jax_tiny_params()[1]})
    share = assert_updates(snaps[0], snaps[2], jax0, record_flat(rec, "fp32wd/p2"),
                           record_flat(rec, "fp32/grad"), means=False)
    assert share < 0.03, share


def test_resume_from_jax_optimizer_state(rec):
    """JAX's parameters and Adam state after step 1 -> the port's step 2
    equals JAX's step 2."""
    p1 = record_flat(rec, "fp32/p1")
    trees = ({k[len("craft/"):]: v for k, v in p1.items() if k.startswith("craft/")},
             {k[len("parseq/"):]: v for k, v in p1.items() if k.startswith("parseq/")})
    state, tx = fresh(params=trees)
    moments = {f"mu/{k}": v for k, v in record_flat(rec, "fp32/mu1").items()}
    moments.update({f"nu/{k}": v for k, v in record_flat(rec, "fp32/nu1").items()})
    moments["count"] = rec["fp32/count1"]
    state.opt_state = moments_from_jax(moments, state.params(),
                                       param_layouts(craft=state.craft, parseq=state.parseq))
    assert state.opt_state.count == 1
    assert not any(k.endswith(("/mean", "/var")) for k in state.opt_state.mu)
    _, snaps, metrics = run_steps(rec, 1, state=state, tx=tx)
    assert_metrics(metrics[0], rec, "fp32/m2", 1e-5)
    share = assert_updates(snaps[0], snaps[1], p1, record_flat(rec, "fp32/p2"),
                           record_flat(rec, "fp32/grad"))
    assert share < 0.03, share


def update_norm(snaps, i, keys):
    return np.sqrt(sum(np.sum((snaps[i][k].astype(np.float64) - snaps[i - 1][k]) ** 2)
                       for k in keys))


def test_bf16_steps_hold_the_bf16_record(rec):
    _, snaps, metrics = run_steps(rec, 2, dtype=torch.bfloat16)
    for i in (1, 2):
        assert_metrics(metrics[i - 1], rec, f"bf16/m{i}", 2e-2)
    want = record_flat(rec, "bf16/dnorm1")
    for k, n in want.items():
        if not ZERO_GRAD.search(k) and n > 0:
            got = update_norm(snaps, 1, [k])
            assert abs(got - n) <= 2e-2 * n, (k, got, float(n))
    want = record_flat(rec, "bf16/dnorm2")
    for model in ("craft/", "parseq/"):
        keys = [k for k in want if k.startswith(model) and not ZERO_GRAD.search(k)]
        n = np.sqrt(sum(float(want[k]) ** 2 for k in keys))
        got = update_norm(snaps, 2, keys)
        assert abs(got - n) <= 1e-2 * n, (model, got, n)


def test_train_bn_off_keeps_running_stats(rec):
    state, snaps, metrics = run_steps(rec, 1, train_bn=False)
    assert_metrics(metrics[0], rec, "fp32nobn/m1", 1e-5)
    for k, v in snaps[0].items():
        if k.endswith(("/mean", "/var")):
            np.testing.assert_array_equal(snaps[1][k], v)


def test_global_norm_matches_jax(rec):
    state, tx = fresh()
    from tuatara_tpu_torch.train.trainer import global_norm

    b = batch()
    perms = torch.from_numpy(rec["perms"]).long()
    state, _ = train_step(state, b, AdamW(lr=0.0), perms=perms, compute_dtype=torch.float32)
    got = float(global_norm([p.grad for p in state.params().values()]))
    np.testing.assert_allclose(got, float(rec["fp32/gnorm"][0]), rtol=1e-5)
    assert got > 1.0  # the default optimizer's clip is active on this record


@pytest.mark.parametrize("norm", [0.5, 3.0])
def test_clip_and_adamw_match_optax(norm):
    """Two updates of optax.chain(clip_by_global_norm(1), adamw(schedule,
    weight_decay=0.1)) on random leaves, gradient norm below and above the
    limit: equal within fp32 rounding."""
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": rng.standard_normal(11).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    for g in grads:
        s = norm / np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in g.values()))
        for k in g:
            g[k] = (g[k] * s).astype(np.float32)
    sched = optax.linear_schedule(1e-2, 1e-3, 5)
    otx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=0.1))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ost = otx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    tx = AdamW(lr=lambda c: float(sched(c)), weight_decay=0.1, clip_norm=1.0)
    st = tx.init(tparams)
    for g in grads:
        upd, ost = otx.update({k: jnp.asarray(v) for k, v in g.items()}, ost, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        tx.step(tparams, st)
        for k in params:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert st.count == 2
