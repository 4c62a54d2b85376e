"""The joint training step and its state (port of
`tuatara_tpu/train/trainer.py`).

`train_step` is one optimisation step of CRAFT's OHEM loss (weighted by
`craft_weight`) plus PARSEQ's permutation-LM loss, as ordinary autograd
over fp32 parameters with the products in a compute dtype. JAX keeps
CRAFT's BatchNorm running statistics as parameter leaves: they get zero
gradients and Adam moments, and after the optimizer step the train
forward's new mean/var are spliced over them. Here they are buffers that
the train forward updates in place and the optimizer never sees, which
gives the same state (the tests hold it to JAX's) and the same global
norm, since their JAX gradients are zero.

`AdamW` is optax's `chain(clip_by_global_norm(clip_norm), adamw(lr, b1,
b2, eps, weight_decay))` written out: clip scales by `clip_norm / norm`
only when `norm >= clip_norm` (torch's `clip_grad_norm_` divides by
`norm + 1e-6` always); Adam with eps 1e-8 and eps_root 0, bias-corrected
moments; the decay `weight_decay * p` added to every leaf (optax's mask
None: biases, norms and embeddings too); then `-lr` times that, with `lr`
a float or a function of the 0-based update count, as an optax schedule
sees it. The optimizer state keeps its moments under JAX's parameter paths
(`craft/vgg/conv1_1/conv/w`), in the port's layouts.

The mesh layouts of JAX's trainer: `shard_train_state(mesh, state)` puts a
state on a `parallel.make_mesh` mesh with the single-device semantics of
JAX's SPMD step, and `train_step` then takes the rank's `shard_batch`:

* 'dp': each rank holds a contiguous shard of every batch field
  (`batch_pspec`). Its loss is its share of the global loss (`losses`
  take the dp group), CRAFT's BatchNorms take batch statistics over the
  global batch (`layers.BatchNorm.sync_group`), and the gradients are
  summed over dp (one coalesced all-reduce; no mean of local means).
* 'tp': PARSEQ's attention q/k/v, fc1 and linear1 weights are split by
  output and attention o, fc2 and linear2 by input (`parseq_param_pspecs`,
  JAX's Megatron patterns, which also match the decoder's self_attn and
  cross_attn), as `parallel/tensor.py`'s layers; each attention keeps
  heads / tp heads (enc_heads and dec_heads must divide by tp). Every 1-D
  leaf stays whole on every rank, as JAX replicates it. The clip's global
  norm sums the shards' squares over tp and counts replicated leaves once.
  Adam's moments are sharded like their parameter; `shard_train_state`
  slices an existing state's moments and keeps its count and step.

The sharded step equals the single step up to the reassociated sums
(`tests/test_torch_parallel_train.py` states the tolerance). The JAX
train forward reaches no Pallas kernel, and neither does this one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tuatara_tpu_torch.api import resolve_device
from tuatara_tpu_torch.config import CraftConfig, ParseqConfig
from tuatara_tpu_torch.models.craft import TrainableCraft, init_craft
from tuatara_tpu_torch.models.layers import MHA, BatchNorm, Linear
from tuatara_tpu_torch.models.parseq import Parseq, init_parseq
from tuatara_tpu_torch.parallel.mesh import all_gather_cat
from tuatara_tpu_torch.parallel.tensor import (ColumnParallelLinear, RowParallelLinear,
                                               tp_sharded)
from tuatara_tpu_torch.train.losses import craft_loss, parseq_plm_loss
from tuatara_tpu_torch.weights import from_jax, load_tree, module_leaves, to_jax


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamState:
    """Adam's update count and moments, keyed by JAX parameter path."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's clip_by_global_norm (when clip_norm > 0) then adamw; with
    weight_decay 0 it is optax.adam."""

    lr: Union[float, Callable[[int], float]] = 7e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 0.0

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                         {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: Dict[str, nn.Parameter], state: AdamState, tp_group=None) -> None:
        """One update of `params` from their `.grad` (None counts as zero), in
        place, with no read on the host. With `tp_group`, the global norm
        sums the squares of the tensor-parallel shards over it."""
        names = list(params)
        ps = [params[k] for k in names]
        gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
        if self.clip_norm > 0:
            # optax: where(norm < m, g, (g / norm) * m), as g / d * f with
            # d = f = 1 where the norm is below m (exact).
            if tp_group is None:
                norm = global_norm(gs)
            else:
                sharded = [tp_sharded(p) for p in ps]
                sq = global_norm([g for g, s_ in zip(gs, sharded) if s_]) ** 2
                dist.all_reduce(sq, group=tp_group)
                rest = global_norm([g for g, s_ in zip(gs, sharded) if not s_])
                norm = torch.sqrt(sq + rest * rest)
            below = norm < self.clip_norm
            gs = torch._foreach_div(gs, torch.where(below, torch.ones_like(norm), norm))
            torch._foreach_mul_(gs, torch.where(below, torch.ones_like(norm),
                                                torch.full_like(norm, self.clip_norm)))
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(gs, 1.0 - self.b1))
        g2 = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(g2, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        count = state.count + 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(ps, self.weight_decay))
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        torch._foreach_mul_(upd, -float(lr))
        torch._foreach_add_(ps, upd)
        state.count = count


def make_optimizer(lr: float = 7e-4, weight_decay: float = 0.0) -> AdamW:
    """JAX `make_optimizer`: clip the global norm at 1.0, then AdamW."""
    return AdamW(lr=lr, weight_decay=weight_decay, clip_norm=1.0)


# ---------------------------------------------------------------------------
# The train state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """Both models (updated in place), the optimizer state and the count of
    steps taken."""

    step: int
    craft: TrainableCraft
    parseq: Parseq
    opt_state: AdamState
    mesh: Any = None  # set by shard_train_state

    def params(self) -> Dict[str, nn.Parameter]:
        return trainable_params(craft=self.craft, parseq=self.parseq)


def trainable_params(**models: nn.Module) -> Dict[str, nn.Parameter]:
    """{"<model>/<JAX path>": parameter} over the models' trained leaves (a
    BatchNorm's running statistics are buffers, not among them)."""
    return {f"{name}/{path}": t for name, m in models.items()
            for path, t, _ in module_leaves(m) if isinstance(t, nn.Parameter)}


def param_layouts(**models: nn.Module) -> Dict[str, str]:
    """{"<model>/<JAX path>": layout} over the models' trained leaves."""
    return {f"{name}/{path}": layout for name, m in models.items()
            for path, t, layout in module_leaves(m) if isinstance(t, nn.Parameter)}


def moments_to_jax(state: AdamState, layouts: Dict[str, str]) -> Dict[str, np.ndarray]:
    """{"mu/<path>", "nu/<path>": array in JAX's layout, "count": int32}."""
    out = {f"mu/{k}": to_jax(v, layouts[k]) for k, v in state.mu.items()}
    out.update({f"nu/{k}": to_jax(v, layouts[k]) for k, v in state.nu.items()})
    out["count"] = np.asarray(state.count, np.int32)
    return out


def moments_from_jax(flat: Dict[str, Any], params: Dict[str, nn.Parameter],
                     layouts: Dict[str, str]) -> AdamState:
    """Adam's state from JAX's moments, flat as `moments_to_jax` writes them
    (`mu/craft/vgg/conv1_1/conv/w`, ..., `count`), onto `params`' devices.
    Every trained leaf must be there; the moments JAX keeps for BatchNorm
    running statistics (`.../mean`, `.../var`) are dropped, and anything
    else raises."""
    mu, nu = {}, {}
    for key, val in flat.items():
        if key == "count":
            continue
        kind, path = key.split("/", 1)
        if kind not in ("mu", "nu"):
            raise KeyError(f"not an Adam moment: {key!r}")
        if path not in params:
            if path.rsplit("/", 1)[-1] in ("mean", "var"):
                continue
            raise KeyError(f"moment of an unknown parameter: {key!r}")
        t = from_jax(val, layouts[path]).to(params[path].device)
        (mu if kind == "mu" else nu)[path] = t
    missing = sorted(set(params) - set(mu) | set(params) - set(nu))
    if missing:
        raise KeyError(f"no moments for {missing[:5]}")
    return AdamState(int(flat["count"]), mu, nu)


def init_train_state(generator: Optional[torch.Generator] = None,
                     craft_cfg: CraftConfig = CraftConfig(),
                     parseq_cfg: ParseqConfig = ParseqConfig(),
                     tx: Optional[AdamW] = None, device: Optional[str] = None,
                     params: Optional[Tuple[Any, Any]] = None) -> Tuple[TrainState, AdamW]:
    """A fresh train state on `device` (None: the card) and its optimizer
    (default `make_optimizer()`). The models are drawn from `generator`
    (default seed 0), CRAFT first, or copied from `params`, a (CRAFT tree,
    PARSEQ tree) pair in JAX's layout, e.g. JAX's `init_train_state`
    parameters or `evals/production_weights`."""
    dev = resolve_device(device)
    if params is None:
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        craft, parseq = init_craft(craft_cfg, gen), init_parseq(parseq_cfg, gen)
    else:
        craft = load_tree(TrainableCraft(craft_cfg), params[0])
        parseq = load_tree(Parseq(parseq_cfg), params[1])
    craft.to(dev)
    parseq.to(dev)
    tx = tx or make_optimizer()
    return TrainState(0, craft, parseq, tx.init(trainable_params(craft=craft, parseq=parseq))), tx


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], tx: AdamW,
               craft_weight: float = 1.0, train_bn: bool = True,
               generator: Optional[torch.Generator] = None, perms: Optional[torch.Tensor] = None,
               k_perms: int = 6, compute_dtype: torch.dtype = torch.bfloat16
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One joint step, in place. batch (tensors on the state's device):
    pages [B, H, W, 3] in [0, 1], heat [B, H/2, W/2, 2], crops [N, 32, 128,
    3] in [0, 1], labels [N, max_len + 2], lengths [N]. The recognizer's
    orders are `perms` or drawn from `generator`. -> (state, metrics: loss,
    loss_craft, loss_parseq, craft_pos, craft_n_pos, parseq_ce, as device
    tensors)."""
    params = state.params()
    for p in params.values():
        p.grad = None
    mesh = state.mesh
    dp = None if mesh is None else mesh.group("dp")
    lc, mc = craft_loss(state.craft, batch["pages"], batch["heat"], train_bn=train_bn,
                        compute_dtype=compute_dtype, group=dp)
    lp, mp = parseq_plm_loss(state.parseq, batch["crops"], batch["labels"], batch["lengths"],
                             generator=generator, k_perms=k_perms, perms=perms,
                             compute_dtype=compute_dtype, group=dp)
    loss = craft_weight * lc + lp
    loss.backward()
    if dp is not None:
        _all_reduce_grads(list(params.values()), dp)
    tx.step(params, state.opt_state, tp_group=None if mesh is None else mesh.group("tp"))
    state.step += 1
    shares = torch.stack([lc.detach(), lp.detach(), loss.detach()])
    if dp is not None:
        dist.all_reduce(shares, group=dp)  # the global losses
    return state, {**mc, **mp, "loss_craft": shares[0], "loss_parseq": shares[1],
                   "loss": shares[2]}


def _all_reduce_grads(ps, group) -> None:
    """Sum every parameter's gradient over `group` in one all-reduce."""
    gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
    flat = torch.cat([g.reshape(-1) for g in gs])
    dist.all_reduce(flat, group=group)
    off = 0
    for p, g in zip(ps, gs):
        p.grad = flat[off:off + g.numel()].view_as(g)
        off += g.numel()


# ---------------------------------------------------------------------------
# Mesh layouts (JAX trainer.py:129-204)
# ---------------------------------------------------------------------------

COLUMN = ("attn/q/w", "attn/k/w", "attn/v/w", "fc1/w", "linear1/w")
ROW = ("attn/o/w", "fc2/w", "linear2/w")


def batch_pspec() -> Dict[str, Tuple[str, ...]]:
    """Data parallel: the leading batch dim of every batch field over 'dp'
    (JAX's P("dp"))."""
    return {k: ("dp",) for k in ("pages", "heat", "crops", "labels", "lengths")}


def parseq_param_pspecs(params: Dict[str, Any]) -> Dict[str, Tuple[Optional[str], ...]]:
    """{JAX path: spec} of PARSEQ leaves in JAX's layouts, JAX's Megatron
    rule: a 2-D leaf on a column pattern (None, "tp"), on a row pattern
    ("tp", None), every other leaf replicated (())."""
    out = {}
    for path, leaf in params.items():
        if np.ndim(leaf) != 2:
            out[path] = ()
        elif any(k in path for k in COLUMN):
            out[path] = (None, "tp")
        elif any(k in path for k in ROW):
            out[path] = ("tp", None)
        else:
            out[path] = ()
    return out


def shard_batch(mesh, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """This rank's contiguous dp shard of every batch field, on its device."""
    dp, r = mesh.size("dp"), mesh.rank("dp")
    out = {}
    for k, v in batch.items():
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if v.shape[0] % dp:
            raise ValueError(f"batch field {k!r} of {v.shape[0]} rows does not divide over "
                             f"dp = {dp}")
        n = v.shape[0] // dp
        out[k] = v[r * n:(r + 1) * n].to(mesh.device)
    return out


def _tp_layer(path: str):
    """The tensor-parallel class of the PARSEQ Linear at JAX `path`, or None."""
    spec = parseq_param_pspecs({f"{path}/w": np.zeros((1, 1))})[f"{path}/w"]
    return {(None, "tp"): ColumnParallelLinear, ("tp", None): RowParallelLinear}.get(spec)


def shard_train_state(mesh, state: TrainState, tx: Optional[AdamW] = None) -> TrainState:
    """Put `state` on `mesh`, in place: both models on the mesh's device,
    CRAFT replicated with BatchNorm statistics synchronized over dp, PARSEQ
    tensor parallel over tp, and the existing optimizer state resharded
    (each moment sliced like its parameter; count and step kept, nothing
    re-initialised). `tx` is accepted for JAX's signature. -> the state."""
    if state.mesh is not None:
        raise ValueError("the state is on a mesh already")
    tp, r = mesh.size("tp"), mesh.rank("tp")
    cfg = state.parseq.cfg
    if cfg.enc_heads % tp or cfg.dec_heads % tp:
        raise ValueError(f"tp = {tp} must divide enc_heads {cfg.enc_heads} and dec_heads "
                         f"{cfg.dec_heads}")
    state.craft.to(mesh.device)
    state.parseq.to(mesh.device)
    for m in state.craft.modules():
        if isinstance(m, BatchNorm):
            m.sync_group = mesh.group("dp")
    mu, nu = state.opt_state.mu, state.opt_state.nu
    for k in list(mu):
        mu[k], nu[k] = mu[k].to(mesh.device), nu[k].to(mesh.device)
    if tp > 1:
        group = mesh.group("tp")
        for name, m in list(state.parseq.named_modules()):
            if isinstance(m, MHA):
                m.heads //= tp
            if not isinstance(m, Linear):
                continue
            path = name.replace(".", "/")
            cls = _tp_layer(path)
            if cls is None:
                continue
            parent, _, attr = name.rpartition(".")
            setattr(state.parseq.get_submodule(parent) if parent else state.parseq, attr,
                    cls.from_linear(m, group, r, tp))
            key = f"parseq/{path}/w"
            mu[key], nu[key] = cls.shard(mu[key], r, tp), cls.shard(nu[key], r, tp)
    state.mesh = mesh
    return state


def leaf_spec(key: str, leaf) -> Tuple[Optional[str], ...]:
    """The mesh spec (JAX layout) of a flat train-state key: `parseq/<path>`
    or an Adam moment of it (`mu/parseq/<path>`) by `parseq_param_pspecs`,
    everything else replicated."""
    path = key.split("parseq/", 1)[1] if "parseq/" in key else None
    return () if path is None else parseq_param_pspecs({path: leaf})[path]


def local_flat(state: TrainState) -> Dict[str, np.ndarray]:
    """This rank's leaves in JAX's layouts, flat: `craft/<path>` and
    `parseq/<path>` (BatchNorm statistics included) and the moments as
    `moments_to_jax` names them; a tp-sharded leaf holds this rank's shard."""
    out = {f"{name}/{path}": to_jax(t, layout)
           for name, m in (("craft", state.craft), ("parseq", state.parseq))
           for path, t, layout in module_leaves(m)}
    out.update(moments_to_jax(state.opt_state,
                              param_layouts(craft=state.craft, parseq=state.parseq)))
    return out


def full_flat(state: TrainState) -> Dict[str, np.ndarray]:
    """`local_flat` with every tp shard gathered into its whole leaf (a
    collective over tp when the state is tensor parallel)."""
    flat = local_flat(state)
    mesh = state.mesh
    if mesh is None or mesh.size("tp") == 1:
        return flat
    group = mesh.group("tp")
    for key in sorted(flat):
        spec = leaf_spec(key, flat[key])
        if "tp" not in spec:
            continue
        t = torch.from_numpy(flat[key]).to(mesh.device)
        flat[key] = all_gather_cat(t, group, spec.index("tp")).cpu().numpy()
    return flat

