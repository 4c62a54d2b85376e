"""The port's fit loops on the CPU at a tiny size (`train/run.py`).

`fit_recognizer` descends in each of its data modes: one fixed batch (the
`word_batch` it renders), `resample`, a pre-rendered pool sampled on the
device, and `data_iter` of uint8 batches augmented on the device with a
callable learning rate; with `grad_clip`, `weight_decay`, `init_params`
and `ckpt_every` / `ckpt_fn` it warm-starts and checkpoints. `fit_detector`
descends on `detection_batch` pages. `evaluate_recognizer` on the golden
recognizer gives JAX's accuracy and texts (live) on the same crops (it was
trained on other renders: it reads none of these words, and the texts it
decodes are compared).
"""

import numpy as np
import pytest

from torch_common import GOLDEN, torch_threads  # noqa: F401
from tuatara_tpu_torch.config import CraftConfig, ParseqConfig
from tuatara_tpu_torch.models.parseq import Parseq
from tuatara_tpu_torch.tokenizer import Tokenizer
from tuatara_tpu_torch.train.run import evaluate_recognizer, fit_detector, fit_recognizer
from tuatara_tpu_torch.utils import weights as W
from tuatara_tpu_torch.utils.data import word_batch, word_pool
from tuatara_tpu_torch.weights import load_tree, module_tree

CFG = ParseqConfig(embed_dim=32, enc_depth=1, enc_heads=4, dec_heads=4, max_label_length=7)
TINY_CRAFT = CraftConfig(stage_channels=(8, 16, 16, 16, 16), fc_channels=16,
                         up_channels=((16, 16), (16, 16), (16, 8), (8, 8)),
                         head_channels=(8, 8, 8, 8))


def u8_batches(n=8, seed=0):
    """An endless iterator of one uint8 batch (bitmap renders, gray)."""
    d = word_batch(n, Tokenizer(), np.random.default_rng(seed), max_length=7, max_len=5)
    u8 = np.round(d["crops"][..., 0] * 255).astype(np.uint8)
    while True:
        yield {"crops": u8, "labels": d["labels"], "lengths": d["lengths"]}


@pytest.mark.parametrize("mode", ["fixed", "resample", "pool", "data_iter"])
def test_fit_recognizer_descends(mode):
    kw = {}
    if mode == "resample":
        kw["resample"] = True
    elif mode == "pool":
        kw["data"] = word_batch(24, Tokenizer(), np.random.default_rng(1), max_length=7,
                                max_len=4)
    elif mode == "data_iter":
        kw["data_iter"] = u8_batches()
        kw["lr"] = lambda count: 3e-3 * min(1.0, (count + 1) / 5)
    model, losses = fit_recognizer(steps=30, batch_size=8, cfg=CFG, k_perms=2,
                                   log_every=10, device="cpu", **{"lr": 3e-3, **kw})
    assert isinstance(model, Parseq) and len(losses) == 4
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.9 * losses[0], losses


def test_fit_recognizer_clip_decay_warm_start_and_checkpoints():
    data = word_batch(8, Tokenizer(), np.random.default_rng(2), max_length=7, max_len=5)
    calls = []
    model, first = fit_recognizer(steps=6, cfg=CFG, data=data, lr=3e-3, log_every=5,
                                  device="cpu", grad_clip=1.0, weight_decay=0.01,
                                  ckpt_every=4, ckpt_fn=lambda s, m, o: calls.append((s, o.count)))
    assert calls == [(4, 4), (6, 6)]
    tree = module_tree(model)
    again, losses = fit_recognizer(steps=6, cfg=CFG, data=data, lr=3e-3, log_every=5,
                                   device="cpu", grad_clip=1.0, weight_decay=0.01,
                                   init_params=tree)
    assert losses[0] < first[0]  # warm start from the trained tree


def test_fit_detector_descends():
    model, losses = fit_detector(steps=20, batch_size=4, lr=2e-3, cfg=TINY_CRAFT, page_size=64,
                                 words_per_page=3, log_every=5, device="cpu")
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < 0.8 * losses[0], losses
    # batch statistics moved the running statistics
    assert float(model.vgg["conv1_1"]["bn"].var.sub(1).abs().max()) > 0


def test_evaluate_recognizer_matches_jax():
    from tuatara_tpu.config import ParseqConfig as JParseqConfig
    from tuatara_tpu.tokenizer import Tokenizer as JTokenizer
    from tuatara_tpu.train.run import evaluate_recognizer as jax_evaluate

    _, parseq_cfg, _ = W.load_configs(GOLDEN)
    _, tree = W.load_weights_dir(GOLDEN)
    model = load_tree(Parseq(parseq_cfg), tree)
    data = word_batch(12, Tokenizer(), np.random.default_rng(5), max_length=7, max_len=5,
                      tight=True)
    acc, texts = evaluate_recognizer(model, data)
    import dataclasses

    jcfg = JParseqConfig(**{f.name: getattr(parseq_cfg, f.name)
                            for f in dataclasses.fields(JParseqConfig)})
    want_acc, want_texts = jax_evaluate(tree, data, jcfg, JTokenizer())
    assert texts == want_texts and acc == want_acc
    assert sum(bool(t) for t in texts) >= 6  # it decodes, if not these words
    u8 = {"crops": np.round(data["crops"][..., 0] * 255).astype(np.uint8), "texts": data["texts"]}
    assert evaluate_recognizer(model, u8)[1] == texts  # uint8 gray crops read the same


def test_word_pool_feeds_the_uint8_path():
    pytest.importorskip("PIL")
    pool = word_pool(16, Tokenizer(), np.random.default_rng(0), max_length=7, max_len=5)

    def it():
        while True:
            yield {"crops": pool["crops_u8"][:8], "labels": pool["labels"][:8],
                   "lengths": pool["lengths"][:8]}

    _, losses = fit_recognizer(steps=3, cfg=CFG, data_iter=it(), k_perms=6, log_every=1,
                               device="cpu", grad_clip=1.0, weight_decay=0.01)
    assert len(losses) == 3 and all(np.isfinite(losses))
