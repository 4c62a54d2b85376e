"""Training loops (port of `tuatara_tpu/train/run.py`).

    from tuatara_tpu_torch.train.run import fit_recognizer
    model, losses = fit_recognizer(steps=200, device="cpu")

`fit_recognizer` trains PARSEQ with the permutation-LM loss, `fit_detector`
CRAFT with the OHEM loss and batch-statistics BatchNorm, `evaluate_recognizer`
scores greedy decoding. Both loops run on the card unless the caller passes
`device="cpu"`; one step issues no host read (the losses are read at
`log_every`). Their randomness comes from a `numpy` generator for the data
(rendering, pool sampling), as in JAX, and from a `torch.Generator` on the
device, seeded `seed + 1`, for the permutations and the augmentation.
`save_checkpoint` or `utils.weights.save_weights_dir` with
`weights.module_tree` persists what they return.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tuatara_tpu_torch.api import resolve_device
from tuatara_tpu_torch.config import CraftConfig, ParseqConfig
from tuatara_tpu_torch.models.craft import TrainableCraft, init_craft
from tuatara_tpu_torch.models.parseq import Parseq, init_parseq
from tuatara_tpu_torch.tokenizer import Tokenizer
from tuatara_tpu_torch.train.losses import craft_loss, parseq_plm_loss
from tuatara_tpu_torch.train.trainer import AdamState, AdamW, trainable_params
from tuatara_tpu_torch.utils.data import detection_batch, word_batch
from tuatara_tpu_torch.weights import load_tree

PAD_Y, PAD_X = 2, 3  # the augmentation's translation jitter, +-px


def augment_gray_u8_draws(crops: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          noise: torch.Tensor, dyx: torch.Tensor) -> torch.Tensor:
    """The augmentation's arithmetic given its draws, JAX
    `_augment_gray_u8`'s operations in its order (equal to JAX's run op by
    op, bit for bit): crops [B, H, W] uint8 -> [B, H, W, 3] fp32 in [0, 1]
    on the uint8 grid. a (contrast) and b (brightness) [B, 1, 1], noise [B,
    H, W] standard normal, dyx [B, 2] the crop's offsets into the
    edge-replicated (+-2, +-3) padding."""
    B, H, W = crops.shape
    f = crops.float() / 255.0
    f = torch.clamp(f * a + b + noise * 0.03, 0.0, 1.0)
    f = torch.round(f * 255.0) / 255.0
    padded = F.pad(f[:, None], (PAD_X, PAD_X, PAD_Y, PAD_Y), mode="replicate")[:, 0]
    dyx = dyx.long()
    rows = dyx[:, 0, None] + torch.arange(H, device=crops.device)
    cols = dyx[:, 1, None] + torch.arange(W, device=crops.device)
    f = padded[torch.arange(B, device=crops.device)[:, None, None], rows[:, :, None],
               cols[:, None, :]]
    return f[..., None].expand(B, H, W, 3).contiguous()


def augment_gray_u8(crops: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """[B, H, W] uint8 grayscale -> [B, H, W, 3] fp32 in [0, 1], re-randomised
    every call (JAX `_augment_gray_u8`): contrast U(0.6, 1.0), brightness
    U(0, 0.3), gaussian noise sigma 0.03, a snap to the uint8 grid, and an
    integer translation of +-3 px in x and +-2 px in y over edge-replicated
    borders. The draws come from `generator`, on the crops' device."""
    B, H, W = crops.shape
    dev = crops.device
    a = torch.rand((B, 1, 1), generator=generator, device=dev) * 0.4 + 0.6
    b = torch.rand((B, 1, 1), generator=generator, device=dev) * 0.3
    noise = torch.randn((B, H, W), generator=generator, device=dev)
    dy = torch.randint(0, 2 * PAD_Y + 1, (B,), generator=generator, device=dev)
    dx = torch.randint(0, 2 * PAD_X + 1, (B,), generator=generator, device=dev)
    return augment_gray_u8_draws(crops, a, b, noise, torch.stack([dy, dx], 1))


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to the card from pinned memory, with no
    wait on the work queued before."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def recognizer_step(model: Parseq, tx: AdamW, params: Dict[str, torch.nn.Parameter],
                    opt_state: AdamState, crops: torch.Tensor, labels: torch.Tensor,
                    lengths: torch.Tensor, generator: torch.Generator, k_perms: int,
                    compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One recognizer update in place; uint8 [B, H, W] crops are augmented
    first. -> the loss, on the device."""
    if crops.dtype == torch.uint8 and crops.ndim == 3:
        crops = augment_gray_u8(crops, generator)
    for p in params.values():
        p.grad = None
    loss, _ = parseq_plm_loss(model, crops, labels, lengths, generator=generator,
                              k_perms=k_perms, compute_dtype=compute_dtype)
    loss.backward()
    tx.step(params, opt_state)
    return loss.detach()


def fit_recognizer(
    steps: int = 200,
    batch_size: int = 8,
    lr: Union[float, Callable[[int], float]] = 1e-3,
    cfg: Optional[ParseqConfig] = None,
    tokenizer: Optional[Tokenizer] = None,
    k_perms: int = 1,
    seed: int = 0,
    data: Optional[Dict[str, np.ndarray]] = None,
    log_every: int = 50,
    resample: bool = False,
    charset_pool: Optional[str] = None,
    tight: bool = False,
    init_params: Union[None, Parseq, dict] = None,
    grad_clip: float = 0.0,
    weight_decay: float = 0.0,
    ckpt_every: int = 0,
    ckpt_fn=None,
    data_iter: Optional[Iterator[Dict[str, np.ndarray]]] = None,
    device: Optional[str] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[Parseq, List[float]]:
    """Train PARSEQ; -> (the model, the losses logged every `log_every`
    steps and at the last).

    The batch each step, as in JAX: `data_iter` (a host batch {"crops",
    "labels", "lengths"} a step) when given; else a pre-rendered pool
    (`data` with more rows than `batch_size`, kept on the device, a random
    minibatch a step drawn by the numpy generator); else one fixed batch
    (`data`, or a `word_batch` rendered from `seed`), rendered anew every
    step with `resample`. uint8 [B, H, W] crops are augmented on the
    device (`augment_gray_u8`). `init_params` (a Parseq or JAX's tree)
    warm-starts; `grad_clip` > 0 clips the global norm and `weight_decay`
    > 0 makes Adam AdamW; `lr` may be a function of the update count.
    `ckpt_fn(step, model, opt_state)` runs every `ckpt_every` steps and at
    the last."""
    dev = resolve_device(device)
    cfg = cfg or ParseqConfig()
    tok = tokenizer or Tokenizer()
    rng = np.random.default_rng(seed)

    def fresh():
        # Words must fit the label budget, or the crops would show more
        # than the labels say.
        return word_batch(batch_size, tok, rng, max_length=cfg.max_label_length,
                          max_len=min(8, cfg.max_label_length), charset=charset_pool,
                          tight=tight)

    if data is None and data_iter is None:
        data = fresh()
    if init_params is None:
        model = init_parseq(cfg, torch.Generator().manual_seed(seed))
    elif isinstance(init_params, Parseq):
        model = init_params
    else:
        model = load_tree(Parseq(cfg), init_params)
    model.to(dev)
    tx = AdamW(lr=lr, weight_decay=weight_decay, clip_norm=grad_clip)
    params = trainable_params(parseq=model)
    opt_state = tx.init(params)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def upload(d):
        return [to_device(d[k], dev) for k in ("crops", "labels", "lengths")]

    pool = batch = None
    if data_iter is None:
        if data["crops"].shape[0] > batch_size:
            pool = upload(data)
        else:
            batch = upload(data)
    losses: List[float] = []
    for i in range(steps):
        if data_iter is not None:
            batch = upload(next(data_iter))
        elif pool is not None:
            idx = to_device(rng.integers(0, pool[0].shape[0], batch_size), dev)
            batch = [t[idx] for t in pool]
        elif resample and i > 0:
            data = fresh()
            batch = upload(data)
        loss = recognizer_step(model, tx, params, opt_state, *batch, gen, k_perms,
                               compute_dtype)
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(loss))
        if ckpt_fn is not None and ckpt_every > 0 and ((i + 1) % ckpt_every == 0
                                                       or i == steps - 1):
            ckpt_fn(i + 1, model, opt_state)
    return model, losses


def detector_step(model: TrainableCraft, tx: AdamW, params: Dict[str, torch.nn.Parameter],
                  opt_state: AdamState, pages: torch.Tensor, heat: torch.Tensor,
                  compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One detector update in place, BatchNorm on batch statistics (its
    running statistics updated by the forward). -> the loss, on the
    device."""
    for p in params.values():
        p.grad = None
    loss, _ = craft_loss(model, pages, heat, train_bn=True, compute_dtype=compute_dtype)
    loss.backward()
    tx.step(params, opt_state)
    return loss.detach()


def fit_detector(
    steps: int = 400,
    batch_size: int = 8,
    lr: Union[float, Callable[[int], float]] = 2e-3,
    cfg: Optional[CraftConfig] = None,
    page_size: int = 96,
    words_per_page: int = 4,
    seed: int = 0,
    log_every: int = 100,
    data_fn=None,
    init_params: Union[None, TrainableCraft, dict] = None,
    device: Optional[str] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[TrainableCraft, List[float]]:
    """Train CRAFT on a fresh `detection_batch` a step (or `data_fn()`,
    which returns {"pages", "heat"}) with Adam and OHEM; -> (the model, the
    losses logged every `log_every` steps and at the last)."""
    dev = resolve_device(device)
    cfg = cfg or CraftConfig()
    if init_params is None:
        model = init_craft(cfg, torch.Generator().manual_seed(seed))
    elif isinstance(init_params, TrainableCraft):
        model = init_params
    else:
        model = load_tree(TrainableCraft(cfg), init_params)
    model.to(dev)
    tx = AdamW(lr=lr)
    params = trainable_params(craft=model)
    opt_state = tx.init(params)
    rng = np.random.default_rng(seed)
    losses: List[float] = []
    for i in range(steps):
        d = data_fn() if data_fn is not None else detection_batch(
            batch_size, rng, size=page_size, words_per_page=words_per_page)
        loss = detector_step(model, tx, params, opt_state, to_device(d["pages"], dev),
                             to_device(d["heat"], dev), compute_dtype)
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(loss))
    return model, losses


@torch.no_grad()
def evaluate_recognizer(model: Parseq, data: Dict, tokenizer: Optional[Tokenizer] = None
                        ) -> Tuple[float, List[str]]:
    """Greedy decoding (with the cloze pass) at fp32 over data["crops"]
    ([N, H, W, 3] in [0, 1], or uint8 [N, H, W] gray) against
    data["texts"] -> (exact-match rate, texts)."""
    tok = tokenizer or Tokenizer()
    dev = model.pos_queries.device
    crops = torch.as_tensor(np.asarray(data["crops"])).to(dev)
    if crops.dtype == torch.uint8:
        crops = (crops.float() / 255.0)[..., None].expand(*crops.shape, 3)
    logits = model(crops.float())
    texts = tok.decode_ids(torch.argmax(logits, -1).cpu().numpy())
    hits = sum(t == w for t, w in zip(texts, data["texts"]))
    return hits / len(texts), texts
