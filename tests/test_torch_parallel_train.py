"""The port's sharded training (`train/trainer.py` mesh layouts,
`parallel/tensor.py`, `train/checkpoint.py`'s sharded backend) on the CPU:
ranks of a gloo group (`tests/torch_dist.py`) against the port's single
step and JAX's record `tests/fixtures/torch_train_tiny.npz` (the cases of
`tests/test_train_parallel.py`).

From JAX's tiny init, on the record's batch (2 pages, 4 crops) and
permutations, two fp32 joint steps at dp=2, tp=2 (world 2) and dp=2 x tp=2
(world 4):

* every metric of both steps within 2e-4 relative of the single step's and
  of JAX's record (JAX's own mesh test holds its sharded loss to rtol 2e-4;
  tp and dp reassociate sums), `craft_n_pos` exact; the same on every rank;
* CRAFT's BatchNorm running statistics equal on every rank after each
  step, and within 1e-5 relative or 1e-6 absolute of the single step's
  (batch statistics over the global batch, fp32 sums of ~1e4 activations
  of order 1 taken in another order): after step 1, and the
  variances after step 2 (a running mean after step 2 absorbs its conv's
  bias, whose first Adam step is rounding noise times lr, as
  `tests/test_torch_train_step.py` sets out);
* each PARSEQ leaf's two-step update within 1e-3 of the single step's
  update (L2), the leaves whose gradient is zero in exact arithmetic left
  out, as `tests/test_torch_train_step.py` sets out;
* a column-sharded weight (`enc/0/attn/q/w`) and its Adam moment hold half
  their output columns on each tp rank, a row-sharded one
  (`dec/0/linear2/w`) half its input rows, and the gathered leaves equal
  across ranks;
* a state sharded after a single-device step keeps its moments (each
  rank's slice of them), count and step, and its next step matches the
  single step's;
* saved sharded at dp=2 after one step, then loaded onto dp=2, onto tp=2
  and onto one device: the loaded leaves and moments equal the saved ones
  bit for bit, and the next step equals, bit for bit, the step from the
  same state built directly on that layout.
"""

import re

import numpy as np
import pytest
import torch

from gen_torch_train import TINY, jax_tiny_params, load_record, tiny_batch
from torch_common import torch_threads  # noqa: F401
from torch_dist import run_ranks
from torch_parallel_cases import O2W, QW, take_step, train_state
from tuatara_tpu_torch.tokenizer import Tokenizer
from tuatara_tpu_torch.train.trainer import full_flat
from tuatara_tpu_torch.utils.data import detection_batch

METRICS = ("loss", "loss_craft", "loss_parseq", "craft_pos", "craft_n_pos", "parseq_ce")
ZERO_GRAD = re.compile(r"craft/(vgg/conv\d_\d/conv|up/upconv\d/conv\d|fc/fc\d)/b$|attn/k/b$")
RTOL = 2e-4


@pytest.fixture(scope="module")
def inputs():
    rec = load_record(TINY)
    return jax_tiny_params(), tiny_batch(detection_batch, Tokenizer()), rec["perms"], rec


@pytest.fixture(scope="module")
def single(inputs):
    params, batch, perms, _ = inputs
    state, tx = train_state(params)
    flat0 = full_flat(state)
    metrics = [take_step(state, tx, batch, perms)]
    flat1 = full_flat(state)
    metrics.append(take_step(state, tx, batch, perms))
    return {"metrics": metrics, "flat0": flat0, "flat1": flat1, "flat": full_flat(state)}


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    params, batch, perms, _ = inputs
    wd = tmp_path_factory.mktemp("dist2")
    return run_ranks("torch_parallel_cases:train_rank", 2, wd, params, batch, perms, str(wd))


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    params, batch, perms, _ = inputs
    wd = tmp_path_factory.mktemp("dist4")
    return run_ranks("torch_parallel_cases:train_rank", 4, wd, params, batch, perms, str(wd))


def layout(world2, world4, name):
    return [r[name] for r in (world4 if name == "dp_tp" else world2)]


def assert_metrics(got, want, rtol=RTOL):
    for k in METRICS:
        if k == "craft_n_pos":
            assert got[k] == want[k]
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("name", ["dp", "tp", "dp_tp"])
def test_sharded_steps_match_single_step_and_jax(world2, world4, single, inputs, name):
    rec = inputs[3]
    for r in layout(world2, world4, name):
        for i in range(2):
            assert_metrics(r["metrics"][i], single["metrics"][i])
            assert_metrics(r["metrics"][i], {k: float(rec[f"fp32/m{i + 1}/{k}"])
                                             for k in METRICS})


@pytest.mark.parametrize("name", ["dp", "tp", "dp_tp"])
def test_sharded_bn_statistics(world2, world4, single, name):
    ranks = layout(world2, world4, name)
    keys = [k for k in single["flat"] if k.startswith("craft/") and k.endswith(("/mean",
                                                                                "/var"))]
    assert len(keys) == 2 * (12 + 8)
    for k in keys:
        for r in ranks:
            np.testing.assert_array_equal(r["flat1"][k], ranks[0]["flat1"][k])
            np.testing.assert_array_equal(r["flat"][k], ranks[0]["flat"][k])
        np.testing.assert_allclose(ranks[0]["flat1"][k], single["flat1"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        if k.endswith("/var"):
            np.testing.assert_allclose(ranks[0]["flat"][k], single["flat"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["dp", "tp", "dp_tp"])
def test_sharded_updates_match_single_step(world2, world4, single, name):
    ranks = layout(world2, world4, name)
    for r in ranks:
        assert r["flat"].keys() == single["flat"].keys()
    for k, want in single["flat"].items():
        if not k.startswith("parseq/") or ZERO_GRAD.search(k):
            continue
        d_want = want.astype(np.float64) - single["flat0"][k]
        for r in ranks:
            np.testing.assert_array_equal(r["flat"][k], ranks[0]["flat"][k])
        d_got = ranks[0]["flat"][k].astype(np.float64) - single["flat0"][k]
        err, n = np.linalg.norm(d_got - d_want), np.linalg.norm(d_want)
        assert err <= 1e-3 * n, f"{k}: {err:.3e} > 1e-3 * {n:.3e}"


@pytest.mark.parametrize("name", ["tp", "dp_tp"])
def test_tp_leaves_and_moments_are_sharded(world2, world4, single, name):
    full_q, full_o = single["flat"][QW].shape, single["flat"][O2W].shape
    for r in layout(world2, world4, name):
        shapes = r["local_shapes"]
        assert shapes[QW] == shapes["mu/" + QW] == (full_q[0], full_q[1] // 2)
        assert shapes[O2W] == shapes["nu/" + O2W] == (full_o[0] // 2, full_o[1])
    for r in layout(world2, world4, "dp"):  # dp alone replicates them
        assert r["local_shapes"][QW] == full_q


def test_shard_mid_training_keeps_moments(world2, single):
    for rank, r in enumerate(world2):
        re_ = r["reshard"]
        assert re_["count"] == 1 and re_["step"] == 1
        before, after = re_["before"], re_["after_local"]
        for k in ("mu/" + QW, "nu/" + QW):
            n = before[k].shape[1] // 2
            np.testing.assert_array_equal(after[k], before[k][:, rank * n:(rank + 1) * n])
        for k in ("mu/" + O2W, "nu/" + O2W):
            n = before[k].shape[0] // 2
            np.testing.assert_array_equal(after[k], before[k][rank * n:(rank + 1) * n])
        assert np.abs(before["mu/" + QW]).max() > 0
        assert_metrics(re_["metrics"], single["metrics"][1])


@pytest.mark.parametrize("target", ["dp", "tp", "single"])
def test_sharded_checkpoint_resumes_bit_equal(world2, target):
    for r in world2:
        c = r["ckpt"]
        got = c[target]
        assert got["step"] == 1 and got["count"] == 1
        assert got["loaded"].keys() == c["flat1"].keys()
        for k, v in c["flat1"].items():
            np.testing.assert_array_equal(got["loaded"][k], v, err_msg=k)
        for k, v in got["direct2"].items():
            np.testing.assert_array_equal(got["resumed2"][k], v, err_msg=k)
        if target == "dp":  # the saving layout: also the straight run's step
            for k, v in c["straight2"].items():
                np.testing.assert_array_equal(got["resumed2"][k], v, err_msg=k)


def test_shard_train_state_checks_heads(inputs):
    from tuatara_tpu_torch.parallel.mesh import Mesh
    from tuatara_tpu_torch.train.trainer import shard_train_state

    state, tx = train_state(inputs[0])
    mesh = Mesh(("dp", "tp"), np.arange(3).reshape(1, 3), {"dp": 0, "tp": 0},
                {"dp": None, "tp": None}, torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        shard_train_state(mesh, state, tx)
