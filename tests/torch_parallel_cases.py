"""The rank functions of the port's multi-rank tests (`tests/torch_dist.py`
runs them; no JAX here). Each takes (rank, world, *args) on a joined gloo
group and returns plain values for the parent to compare."""

import numpy as np
import torch

from tuatara_tpu_torch import OcrEngine
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.parallel import make_mesh, shard_pages, sharded_ocr_programs

from torch_common import GOLDEN

SERVING = {"max_label_length": 7, "max_boxes": 16, "rec_buckets": (4, 8, 16)}
COUNTERS = ("pages", "batches", "boxes", "spec_hits", "spec_misses", "spec_wasted")


def serving_configs():
    """The engines held mesh == single: the default path at fp32 (the JAX
    serving record's config), latency() (K6/K7's plain versions on the
    CPU, bf16) and production() (int8 CRAFT), dynamic and calibrated."""
    return {"default": OcrConfig(compute_dtype="float32", **SERVING),
            "latency": OcrConfig.latency(**SERVING),
            "production": OcrConfig.production(**SERVING),
            "production_calibrated": OcrConfig.production(**SERVING)}


def serve(engine, name, stream, mixed, odd):
    """One engine through the serving calls -> {call: results}."""
    out = {}
    if name == "production_calibrated":
        out["calibrated"] = engine.calibrate([odd, stream[2]], margin=1.0)
        out["scales"] = [float(q.sx) for _, q in engine.craft.qconvs()]
    out["odd"] = engine.run_pages(odd)
    engine.reset_stats()
    out["stream"] = engine.run_stream(stream, prefetch=2, depth=1)
    out["stream_stats"] = {k: engine.stats[k] for k in COUNTERS}
    out["mixed"] = [engine.run_mixed(mixed, max_batch=2) for _ in range(2)]
    out["mixed_stats"] = {k: engine.stats[k] for k in COUNTERS}
    return out


def serve_all(stream, mixed, odd, mesh=None, device="cpu"):
    return {name: serve(OcrEngine(cfg, weights_dir=GOLDEN, device=device, mesh=mesh),
                        name, stream, mixed, odd)
            for name, cfg in serving_configs().items()}


def calibrate_small_budget(odd, mesh=None):
    """An engine with an int8 recognizer encoder (`quantized_serving` on
    the XLA encoder) and a box budget below the ladder's top, calibrated
    on the odd batch -> its CRAFT and encoder scales."""
    cfg = OcrConfig(quantized_serving=True, max_label_length=7, max_boxes=4,
                    rec_buckets=(4, 8, 16))
    engine = OcrEngine(cfg, weights_dir=GOLDEN, device="cpu", mesh=mesh)
    n = engine.calibrate([odd], margin=1.0)
    return {"calibrated": n,
            "scales": [float(q.sx) for _, q in engine.craft.qconvs() + engine.parseq.qlinears()]}


def serving_rank(rank, world, stream, mixed, odd):
    """Every serving config on a dp mesh over all ranks, the mesh helpers,
    and make_mesh's shape errors."""
    mesh = make_mesh(device="cpu")
    out = {"results": serve_all(stream, mixed, odd, mesh=mesh),
           "dp_size": OcrEngine(serving_configs()["default"], weights_dir=GOLDEN,
                                device="cpu", mesh=mesh).dp_size,
           "calib_small": calibrate_small_budget(odd, mesh)}
    errors = []
    for kwargs in ({"shape": (world + 1,)}, {"axes": ("dp", "tp"), "shape": (world, 2)},
                   {"n_devices": world * 2}, {"axes": ("pp",)}):
        try:
            make_mesh(device="cpu", **kwargs)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["shape_errors"] = errors
    # The helpers of parallel/sharding.py: programs of the mesh engine
    # equal its own stages; an engine without the mesh is refused.
    eng = OcrEngine(serving_configs()["default"], weights_dir=GOLDEN, device="cpu", mesh=mesh)
    pages = np.concatenate([odd, odd[:1]])  # 4 pages: a dp multiple
    try:
        sharded_ocr_programs(OcrEngine(serving_configs()["default"], weights_dir=GOLDEN,
                                       device="cpu"), mesh, 4, *pages.shape[1:3])
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    detect, recognize_for = sharded_ocr_programs(eng, mesh, 4, *pages.shape[1:3])
    det = detect(pages)
    ids, conf = recognize_for(16)(pages, det["rects"], det["valid"])
    out["program"] = {"count": det["count"].tolist(), "bbox": det["bbox"].tolist(),
                      "ids": ids.tolist(), "conf": conf.tolist()}
    out["shard"] = shard_pages(mesh, torch.from_numpy(pages)).numpy()
    return out


# ---------------------------------------------------------------------------
# Training over a mesh
# ---------------------------------------------------------------------------

QW = "parseq/enc/0/attn/q/w"  # a column-sharded leaf (JAX layout [in, out])
O2W = "parseq/dec/0/linear2/w"  # a row-sharded one


def tiny_cfgs():
    from gen_torch_train import tiny_configs
    from tuatara_tpu_torch.config import CraftConfig, ParseqConfig

    return tiny_configs(CraftConfig, ParseqConfig)


def train_state(params, mesh=None, moments=None, step=0):
    """A tiny train state from JAX-layout trees (and Adam's flat moments),
    sharded onto `mesh` when given."""
    from tuatara_tpu_torch.train.trainer import (init_train_state, moments_from_jax,
                                                 param_layouts, shard_train_state)

    tc, tp = tiny_cfgs()
    state, tx = init_train_state(craft_cfg=tc, parseq_cfg=tp, device="cpu", params=params)
    if moments is not None:
        state.opt_state = moments_from_jax(moments, state.params(),
                                           param_layouts(craft=state.craft, parseq=state.parseq))
        state.step = step
    if mesh is not None:
        shard_train_state(mesh, state, tx)
    return state, tx


def take_step(state, tx, batch, perms):
    from tuatara_tpu_torch.train.trainer import shard_batch, train_step

    b = ({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()} if state.mesh is None
         else shard_batch(state.mesh, batch))
    _, m = train_step(state, b, tx, perms=torch.from_numpy(perms).long(),
                      compute_dtype=torch.float32)
    return {k: float(v) for k, v in m.items()}


def trees_of(flat):
    """A full flat train state -> ((craft tree, parseq tree), moments)."""
    from tuatara_tpu_torch.utils.weights import unflatten_tree

    def tree(prefix):
        return unflatten_tree({k[len(prefix):]: v for k, v in flat.items()
                               if k.startswith(prefix)})

    return ((tree("craft/"), tree("parseq/")),
            {k: v for k, v in flat.items() if k.startswith(("mu/", "nu/")) or k == "count"})


def two_steps(params, batch, perms, mesh):
    from tuatara_tpu_torch.train.trainer import full_flat, local_flat

    state, tx = train_state(params, mesh)
    metrics = [take_step(state, tx, batch, perms)]
    flat1 = full_flat(state)
    metrics.append(take_step(state, tx, batch, perms))
    local = local_flat(state)
    return {"metrics": metrics, "flat1": flat1, "flat": full_flat(state),
            "local_shapes": {k: local[k].shape for k in (QW, O2W, "mu/" + QW, "nu/" + O2W)}}


def train_rank(rank, world, params, batch, perms, workdir):
    """World 2: dp=2 and tp=2 steps, a mid-training reshard, and the
    sharded checkpoint across layouts. World 4: dp=2 x tp=2 steps."""
    from tuatara_tpu_torch.train.checkpoint import (load_checkpoint_sharded,
                                                    save_checkpoint_sharded)
    from tuatara_tpu_torch.train.trainer import full_flat, local_flat, shard_train_state

    if world == 4:
        return {"dp_tp": two_steps(params, batch, perms,
                                   make_mesh(axes=("dp", "tp"), shape=(2, 2), device="cpu"))}
    mesh_dp = make_mesh(device="cpu")
    mesh_tp = make_mesh(axes=("dp", "tp"), shape=(1, 2), device="cpu")
    out = {"dp": two_steps(params, batch, perms, mesh_dp),
           "tp": two_steps(params, batch, perms, mesh_tp)}

    # Mid-training: one single-device step, then the state goes onto tp.
    state, tx = train_state(params)
    take_step(state, tx, batch, perms)
    before = local_flat(state)
    shard_train_state(mesh_tp, state, tx)
    out["reshard"] = {"before": before, "after_local": local_flat(state),
                      "count": state.opt_state.count, "step": state.step,
                      "metrics": take_step(state, tx, batch, perms)}

    # Sharded checkpoint: saved under dp=2 after one step.
    ckpt = f"{workdir}/ckpt"
    a, tx = train_state(params, mesh_dp)
    take_step(a, tx, batch, perms)
    flat1 = full_flat(a)
    save_checkpoint_sharded(ckpt, a)
    take_step(a, tx, batch, perms)
    res = {"flat1": flat1, "straight2": full_flat(a)}
    trees, moments = trees_of(flat1)
    for name, mesh in (("dp", mesh_dp), ("tp", mesh_tp), ("single", None)):
        b, tx = train_state(params, mesh)
        load_checkpoint_sharded(ckpt, b)
        res[name] = {"loaded": full_flat(b), "step": b.step, "count": b.opt_state.count}
        take_step(b, tx, batch, perms)
        ref, tx = train_state(trees, mesh, moments=moments, step=1)
        take_step(ref, tx, batch, perms)
        res[name].update(resumed2=full_flat(b), direct2=full_flat(ref))
    out["ckpt"] = res
    return out
