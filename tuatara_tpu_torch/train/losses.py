"""Training losses for both models (port of `tuatara_tpu/train/losses.py`).

* CRAFT: per-pixel squared error against the region and affinity targets
  with online hard negative mining, each map mined on its own: the
  positives are that map's pixels with target > 0.1; the negatives kept are
  every one whose error is at least the `n_neg`-th largest negative error,
  `n_neg = min(int(neg_ratio * n_pos), k)`, ties at that threshold included
  (not an exact top-k), non-finite errors never.
* PARSEQ: permutation language modelling, the cross-entropy of the decoder
  under K factorisation orders (left to right first, odd rows the mirror of
  the row before). Query q may attend content c when c is BOS or c's token
  comes before q's in the order; content at and after the first EOS is
  masked for every query; EOS is supervised only under the first two
  orders. The K orders run as one decode: the position queries repeat K
  times along the query axis, each block under its order's mask (queries
  are independent rows of the decoder, so this is the K decodes of JAX's
  vmap in one call).

Under a data-parallel mesh (`group`, the dp process group) each rank
holds a shard of the batch and returns its share of the global loss, so
that the shares' gradients, summed over dp, are the global loss's: OHEM
counts the positives over the whole batch, takes the threshold from every
rank's negative errors and divides by the global count; the PLM loss
divides by the global count of supervised positions. The metrics are the
global ones.

Both run the models in a compute dtype (bf16 by default, as JAX's losses
do) over fp32 parameters. The mined threshold, the masks and the label
gathers carry no gradient; the token log-probabilities are read through a
one-hot product, whose backward, unlike a gather's, needs no scatter.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tuatara_tpu_torch.models.craft import TrainableCraft
from tuatara_tpu_torch.models.layers import cast_products
from tuatara_tpu_torch.models.parseq import Parseq


# ---------------------------------------------------------------------------
# CRAFT
# ---------------------------------------------------------------------------

def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the ranks of `group`, or t; without its gradient."""
    if group is None:
        return t.detach()
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def _cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t [n] concatenated in rank order (no gradient), or t."""
    from tuatara_tpu_torch.parallel.mesh import all_gather_cat

    return all_gather_cat(t, group)


def ohem_keep(err: torch.Tensor, pos: torch.Tensor, neg_ratio: float,
              group=None) -> torch.Tensor:
    """The negatives OHEM keeps over one map: not positive, finite, and an
    error at least the n_neg-th largest negative error (ties kept); under
    `group`, of the whole batch's."""
    err = err.detach()
    neg_vals = _cat(torch.where(pos, float("-inf"), err).reshape(-1), group)
    k = neg_vals.numel()
    n_pos = _sum(pos.sum(), group).clamp(min=1)
    n_neg = torch.clamp((neg_ratio * n_pos).to(torch.int32), max=k)
    sorted_negs = torch.sort(neg_vals, descending=True).values
    thresh = sorted_negs[torch.clamp(n_neg - 1, 0, k - 1).long()]
    return ~pos & (err >= thresh) & torch.isfinite(err)


def channel_ohem(err: torch.Tensor, tgt: torch.Tensor, neg_ratio: float, group=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (the map's OHEM loss (this rank's share under `group`), the mean
    positive error, the positive count (at least 1))."""
    pos = tgt > 0.1
    pos_loss = torch.where(pos, err, 0.0)
    n_pos = _sum(pos.sum(), group).clamp(min=1)
    keep = ohem_keep(err, pos, neg_ratio, group)
    neg_loss = torch.where(keep, err, 0.0)
    denom = n_pos + _sum(keep.sum(), group).clamp(min=1)
    return ((pos_loss.sum() + neg_loss.sum()) / denom,
            _sum(pos_loss.sum(), group) / n_pos, n_pos)


def craft_loss(model: TrainableCraft, images: torch.Tensor, target_heatmaps: torch.Tensor,
               confidence: Optional[torch.Tensor] = None, neg_ratio: float = 3.0,
               train_bn: bool = True, compute_dtype: torch.dtype = torch.bfloat16,
               group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """OHEM-balanced squared error on (region, affinity). images [B, H, W,
    3] in [0, 1]; target_heatmaps [B, H/2, W/2, 2]; confidence [B, H/2,
    W/2], an optional per-pixel weight. With `train_bn` the BatchNorms use
    batch statistics and update their running statistics in place; without,
    they use the running ones. -> (loss, {"craft_pos", "craft_n_pos"})."""
    pred, _ = model(images, train_bn=train_bn, compute_dtype=compute_dtype)
    err = (pred - target_heatmaps) ** 2
    if confidence is not None:
        err = err * confidence[..., None]
    l_region, pos_region, n_pos = channel_ohem(err[..., 0], target_heatmaps[..., 0], neg_ratio,
                                               group)
    l_affinity, _, _ = channel_ohem(err[..., 1], target_heatmaps[..., 1], neg_ratio, group)
    return l_region + l_affinity, {"craft_pos": pos_region.detach(), "craft_n_pos": n_pos}


# ---------------------------------------------------------------------------
# PARSEQ permutation language modelling
# ---------------------------------------------------------------------------

def gen_permutations(max_len: int, k_perms: int, generator: torch.Generator) -> torch.Tensor:
    """[k_perms, max_len] factorisation orders over label positions
    1..max_len: row 0 left to right, each odd row the mirror of the row
    before, the other rows random permutations drawn from `generator` (on
    its device)."""
    lr = torch.arange(1, max_len + 1, device=generator.device)
    rows = [lr]
    while len(rows) < k_perms:
        if len(rows) % 2 == 1:
            rows.append(rows[-1].flip(0))
        else:
            rows.append(lr[torch.randperm(max_len, generator=generator,
                                          device=generator.device)])
    return torch.stack(rows[:k_perms])


def perm_attention_masks(perm: torch.Tensor, max_len: int) -> torch.Tensor:
    """Query masks of factorisation orders `perm` [..., max_len] (positions
    1..max_len) -> bool [..., T, T], T = max_len + 1 (BOS + max_len content
    slots): query q (the token at content slot q + 1) may attend content c
    when c's rank in the order is below q + 1's; BOS has rank 0 and the last
    query (the EOS slot) sees everything."""
    T = max_len + 1
    rank = torch.argsort(perm, dim=-1) + 1  # rank of content slots 1..max_len
    lead = perm.shape[:-1]
    c_rank = torch.cat([torch.zeros(lead + (1,), dtype=rank.dtype, device=rank.device),
                        rank], dim=-1)
    q_rank = torch.cat([rank, torch.full(lead + (1,), max_len + 1, dtype=rank.dtype,
                                         device=rank.device)], dim=-1)
    return c_rank[..., None, :] < q_rank[..., :, None]


def parseq_plm_loss(model: Parseq, images: torch.Tensor, labels: torch.Tensor,
                    label_lengths: torch.Tensor, generator: Optional[torch.Generator] = None,
                    k_perms: int = 6, perms: Optional[torch.Tensor] = None,
                    compute_dtype: torch.dtype = torch.bfloat16, group=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Permutation-LM cross-entropy. images [N, 32, 128, 3] in [0, 1];
    labels [N, max_len + 2] = [BOS, chars..., EOS, PAD...]; label_lengths
    [N] = chars + EOS. The orders are `perms` [K, max_len] when given, else
    `gen_permutations(max_len, k_perms, generator)`. The loss is summed
    over the orders, then divided by the count of supervised positions.
    -> (loss, {"parseq_ce": loss})."""
    cfg = model.cfg
    T = cfg.max_label_length + 1
    labels = labels.long()
    if perms is None:
        if generator is None:
            raise ValueError("parseq_plm_loss needs `perms` or a `generator`")
        perms = gen_permutations(cfg.max_label_length, k_perms, generator)
    perms = perms.to(labels.device)
    K = perms.shape[0]
    N = labels.shape[0]
    tgt_in = labels[:, :T]
    tgt_out = labels[:, 1:T + 1]
    steps = torch.arange(T, device=labels.device)
    loss_mask = steps[None] < label_lengths.to(labels.device)[:, None]
    is_eos = tgt_out == 0
    # Content padding: EOS and everything after it.
    zero = tgt_in == 0
    first = torch.where(zero.any(1), zero.int().argmax(1), T)
    pad = steps[None] >= first[:, None]  # [N, T]
    qmask = perm_attention_masks(perms, cfg.max_label_length).reshape(1, 1, K * T, T)
    qmask = qmask & ~pad[:, None, None, :]  # [N, 1, K * T, T]
    with cast_products(model, compute_dtype):
        memory = model.encode(images)
        query = model.pos_queries[:, :T].repeat(1, K, 1).expand(N, K * T, -1)
        # XLA leaves the head's bias add unrounded before JAX's fp32
        # log-softmax (tests/probe_torch_bf16.py hlo).
        logits = model.decode(memory, tgt_in, query=query, query_mask=qmask, fp32_logits=True)
    C = logits.shape[-1]
    logp = F.log_softmax(logits.float().reshape(N, K, T, C), dim=-1)
    onehot = F.one_hot(tgt_out.clamp(0, C - 1), C).to(logp.dtype)  # [N, T, C]
    tok_lp = (logp * onehot[:, None]).sum(-1)  # [N, K, T]
    keep_eos = torch.arange(K, device=labels.device) < 2
    m = loss_mask[:, None, :] & (keep_eos[None, :, None] | ~is_eos[:, None, :])
    loss = -(tok_lp * m).sum() / _sum(m.sum(), group).clamp(min=1)
    return loss, {"parseq_ce": _sum(loss, group)}
