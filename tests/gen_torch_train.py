"""Write the JAX records that the port's training tests and chip_smoke.py's
phase 7 read, and the uint8 word pool phase 7 trains on.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_train.py \
        [--part tiny|fullwidth|words|craft_grads]

* `tests/fixtures/torch_train_tiny.npz` (--part tiny, ~1 min): two JAX
  `train_step`s at the test configs `TINY_CRAFT` / `TINY_PARSEQ` from
  `init_train_state(PRNGKey(0))`, on `tiny_batch(0)` with the orders of
  `gen_permutations(PRNGKey(1), 7, 6)`: the starting parameters; at fp32,
  the joint loss's gradients
  at the start, the parameters after each step, Adam's moments after step 1
  and the metrics; at fp32 with weight decay 0.01 the parameters after two
  steps; at bf16 (the shipped losses) the metrics and each leaf's update
  norm; at fp32 with `train_bn=False` the first step's metrics.
* `tests/fixtures/torch_train_fullwidth.npz` (--part fullwidth, ~6 min):
  two steps at full width from `evals/production_weights` on one 128x128
  `detection_batch` page and 4 `word_batch` crops (stored), at fp32 and
  bf16: metrics, each leaf's update norm, the first BatchNorm's running
  statistics, the gradients' global norms.
* `tests/fixtures/torch_train_words.npz` (--part words): 256 TrueType word
  crops rendered by the port's own `word_pool` (so the card needs no PIL).
* `tests/fixtures/torch_train_craft_grads.npz` (--part craft_grads, ~1
  min): JAX's bf16 CRAFT loss gradient before AdamW from
  `evals/production_weights` on the full-width record's detection page
  (train_bn, as phase 7's first step takes it), leaf by leaf (the leaves
  whose gradient is zero in exact arithmetic, and the running statistics,
  left out): each leaf's L2 norm and its sketch (`chip_smoke.grad_sketch`:
  the leaf itself up to 1024 elements, else a count sketch of 1024 signed
  bucket sums, from which a relative L2 error against JAX's is estimated
  within ~2.2%, one standard deviation). Phase 7 and
  `scripts/train_sites_torch_port.py` hold the port's gradient to it.

JAX's losses run their models at bf16 (`craft_forward_train` and PARSEQ's
encoder and decoder at their default compute dtype). For the fp32 records
this script rebinds the names `tuatara_tpu.train.losses` imports
(`craft_forward_train`, `craft_forward`, `parseq_encode`, `parseq_decode`)
to `functools.partial(..., compute_dtype=jnp.float32)` while it records;
nothing in `tuatara_tpu/` changes.
"""

import argparse
import contextlib
import functools
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
TINY = os.path.join(FIXTURES, "torch_train_tiny.npz")
FULLWIDTH = os.path.join(FIXTURES, "torch_train_fullwidth.npz")
WORDS = os.path.join(FIXTURES, "torch_train_words.npz")
CRAFT_GRADS = os.path.join(FIXTURES, "torch_train_craft_grads.npz")
TINY_MAX_LEN = 7
K_PERMS = 6


def tiny_configs(craft_cls, parseq_cls):
    """(TINY_CRAFT, TINY_PARSEQ) of tests/test_checkpoint.py from either
    package's config classes."""
    craft = craft_cls(stage_channels=(8, 16, 16, 16, 16), fc_channels=16,
                      up_channels=((16, 16), (16, 16), (16, 8), (8, 8)),
                      head_channels=(8, 8, 8, 8))
    parseq = parseq_cls(embed_dim=32, enc_depth=1, enc_heads=4, dec_heads=4,
                        max_label_length=TINY_MAX_LEN)
    return craft, parseq


def tiny_batch(detection_batch, tokenizer, seed=0):
    """The tiny records' batch, from numpy alone (either package's
    `detection_batch` and `Tokenizer`): 2 pages of 64x64 with their heat,
    4 random crops, labels of random words."""
    rng = np.random.default_rng(seed)
    det = detection_batch(2, rng, size=64, words_per_page=3)
    crops = rng.random((4, 32, 128, 3)).astype(np.float32)
    labels, lengths = [], []
    for _ in range(4):
        k = int(rng.integers(1, TINY_MAX_LEN))
        text = "".join(tokenizer.charset[int(i)] for i in rng.integers(0, 62, k))
        ids, n = tokenizer.encode(text, TINY_MAX_LEN)
        labels.append(ids)
        lengths.append(n)
    return {"pages": det["pages"], "heat": det["heat"], "crops": crops,
            "labels": np.stack(labels).astype(np.int32),
            "lengths": np.asarray(lengths, np.int32)}


@contextlib.contextmanager
def fp32_losses():
    """Run JAX's losses at fp32 (see the module docstring)."""
    import jax.numpy as jnp

    import tuatara_tpu.train.losses as JL
    from tuatara_tpu.models import craft as JC
    from tuatara_tpu.models import parseq as JP

    names = {"craft_forward_train": JC.craft_forward_train, "craft_forward": JC.craft_forward,
             "parseq_encode": JP.parseq_encode, "parseq_decode": JP.parseq_decode}
    old = {n: getattr(JL, n) for n in names}
    for n, f in names.items():
        setattr(JL, n, functools.partial(f, compute_dtype=jnp.float32))
    try:
        yield
    finally:
        for n, f in old.items():
            setattr(JL, n, f)


def flat(tree, prefix):
    from tuatara_tpu.utils.weights import flatten_tree

    return {f"{prefix}/{k}": np.asarray(v, np.float32) for k, v in flatten_tree(tree).items()}


def params_of(state):
    return {"craft": state.craft_params, "parseq": state.parseq_params}


def metrics_of(m, prefix):
    return {f"{prefix}/{k}": np.asarray(v, np.float32) for k, v in m.items()}


def update_norms(p_new, p_old, prefix):
    from tuatara_tpu.utils.weights import flatten_tree

    a, b = flatten_tree(p_new), flatten_tree(p_old)
    return {f"{prefix}/{k}": np.float64(np.linalg.norm((np.asarray(a[k], np.float64)
                                                        - np.asarray(b[k], np.float64)).ravel()))
            for k in a}


def grad_norm(state, batch, key, craft_cfg, parseq_cfg, train_bn=True):
    """The joint loss's gradients at `state` and their global norm."""
    import jax
    import optax

    from tuatara_tpu.train.losses import craft_loss, parseq_plm_loss

    def loss_fn(params):
        lc, _ = craft_loss(params["craft"], batch["pages"], batch["heat"], cfg=craft_cfg,
                           train_bn=train_bn)
        lp, _ = parseq_plm_loss(params["parseq"], batch["crops"], batch["labels"],
                                batch["lengths"], key, parseq_cfg)
        return lc + lp

    grads = jax.jit(jax.grad(loss_fn))(params_of(state))
    return grads, float(optax.global_norm(grads))


def two_steps(state, tx, batch, key, craft_cfg, parseq_cfg, train_bn=True):
    import jax

    from tuatara_tpu.train.trainer import train_step

    step = jax.jit(functools.partial(train_step, tx=tx, craft_cfg=craft_cfg,
                                     parseq_cfg=parseq_cfg, train_bn=train_bn))
    s1, m1 = step(state, batch, key)
    s2, m2 = step(s1, batch, key)
    return (s1, m1), (s2, m2)


def gen_tiny():
    import jax
    import jax.numpy as jnp

    from tuatara_tpu.config import CraftConfig, ParseqConfig
    from tuatara_tpu.tokenizer import Tokenizer
    from tuatara_tpu.train.losses import gen_permutations
    from tuatara_tpu.train.trainer import init_train_state, make_optimizer
    from tuatara_tpu.utils.data import detection_batch

    tc, tp = tiny_configs(CraftConfig, ParseqConfig)
    batch = {k: jnp.asarray(v) for k, v in tiny_batch(detection_batch, Tokenizer()).items()}
    key = jax.random.PRNGKey(1)
    out = {"perms": np.asarray(gen_permutations(key, TINY_MAX_LEN, K_PERMS), np.int32)}
    state0, tx = init_train_state(jax.random.PRNGKey(0), tc, tp)
    out.update(flat(params_of(state0), "p0"))
    with fp32_losses():
        grads, gn = grad_norm(state0, batch, key, tc, tp)
        out.update(flat(grads, "fp32/grad"))
        (s1, m1), (s2, m2) = two_steps(state0, tx, batch, key, tc, tp)
        _, gn2 = grad_norm(s1, batch, key, tc, tp)
        out["fp32/gnorm"] = np.asarray([gn, gn2], np.float64)
        out.update(metrics_of(m1, "fp32/m1"))
        out.update(metrics_of(m2, "fp32/m2"))
        out.update(flat(params_of(s1), "fp32/p1"))
        out.update(flat(params_of(s2), "fp32/p2"))
        adam = s1.opt_state[1][0]
        out.update(flat(adam.mu, "fp32/mu1"))
        out.update(flat(adam.nu, "fp32/nu1"))
        out["fp32/count1"] = np.asarray(adam.count, np.int32)
        wd0, txwd = init_train_state(jax.random.PRNGKey(0), tc, tp,
                                     tx=make_optimizer(weight_decay=0.01))
        (_, wm1), (w2, wm2) = two_steps(wd0, txwd, batch, key, tc, tp)
        out.update(metrics_of(wm1, "fp32wd/m1"))
        out.update(metrics_of(wm2, "fp32wd/m2"))
        out.update(flat(params_of(w2), "fp32wd/p2"))
        (_, nm1), _ = two_steps(state0, tx, batch, key, tc, tp, train_bn=False)
        out.update(metrics_of(nm1, "fp32nobn/m1"))
    (b1, bm1), (b2, bm2) = two_steps(state0, tx, batch, key, tc, tp)
    out.update(metrics_of(bm1, "bf16/m1"))
    out.update(metrics_of(bm2, "bf16/m2"))
    out.update(update_norms(params_of(b1), params_of(state0), "bf16/dnorm1"))
    out.update(update_norms(params_of(b2), params_of(b1), "bf16/dnorm2"))
    np.savez_compressed(TINY, **out)
    print(f"wrote {TINY}: {len(out)} arrays, gradient norms {gn:.4f}, {gn2:.4f}, "
          f"{os.path.getsize(TINY)} bytes")


def fullwidth_batch(seed=0):
    """One 128x128 `detection_batch` page and 4 `word_batch` crops (JAX's
    generators) -> numpy arrays; the crops also as uint8 (they lie on the
    uint8 grid)."""
    from tuatara_tpu.tokenizer import Tokenizer
    from tuatara_tpu.utils.data import detection_batch, word_batch

    rng = np.random.default_rng(seed)
    det = detection_batch(1, rng, size=128, words_per_page=6)
    words = word_batch(4, Tokenizer(), rng, max_length=25, max_len=8)
    u8 = np.round(words["crops"] * 255.0).astype(np.uint8)
    assert np.array_equal(np.float32(u8) / np.float32(255.0), words["crops"])
    return {"pages": det["pages"], "heat": det["heat"], "crops_u8": u8,
            "labels": words["labels"], "lengths": words["lengths"]}


def gen_fullwidth():
    import jax
    import jax.numpy as jnp

    from tuatara_tpu.train.losses import gen_permutations
    from tuatara_tpu.train.trainer import TrainState, make_optimizer
    from tuatara_tpu.utils.weights import load_configs, load_weights_dir

    weights = os.path.join(ROOT, "evals", "production_weights")
    craft_cfg, parseq_cfg, _ = load_configs(weights)
    craft_p, parseq_p = load_weights_dir(weights)
    craft_p = jax.tree.map(jnp.asarray, craft_p)
    parseq_p = jax.tree.map(jnp.asarray, parseq_p)
    tx = make_optimizer()
    state0 = TrainState(jnp.int32(0), craft_p, parseq_p,
                        tx.init({"craft": craft_p, "parseq": parseq_p}))
    data = fullwidth_batch()
    batch = {"pages": jnp.asarray(data["pages"]), "heat": jnp.asarray(data["heat"]),
             "crops": jnp.asarray(np.float32(data["crops_u8"]) / np.float32(255.0)),
             "labels": jnp.asarray(data["labels"]), "lengths": jnp.asarray(data["lengths"])}
    key = jax.random.PRNGKey(1)
    out = dict(data)
    out["perms"] = np.asarray(gen_permutations(key, parseq_cfg.max_label_length, K_PERMS),
                              np.int32)
    for tag, ctx in (("fp32", fp32_losses), ("bf16", contextlib.nullcontext)):
        with ctx():
            (s1, m1), (s2, m2) = two_steps(state0, tx, batch, key, craft_cfg, parseq_cfg)
            gn = [grad_norm(s, batch, key, craft_cfg, parseq_cfg)[1] for s in (state0, s1)]
        out[f"{tag}/gnorm"] = np.asarray(gn, np.float64)
        out.update(metrics_of(m1, f"{tag}/m1"))
        out.update(metrics_of(m2, f"{tag}/m2"))
        out.update(update_norms(params_of(s1), params_of(state0), f"{tag}/dnorm1"))
        out.update(update_norms(params_of(s2), params_of(s1), f"{tag}/dnorm2"))
        for i, s in ((1, s1), (2, s2)):
            bn = s.craft_params["vgg"]["conv1_1"]["bn"]
            out[f"{tag}/bn{i}/mean"] = np.asarray(bn["mean"], np.float32)
            out[f"{tag}/bn{i}/var"] = np.asarray(bn["var"], np.float32)
        print(f"{tag}: loss {float(m1['loss']):.6f} -> {float(m2['loss']):.6f}, "
              f"gradient norms {gn}", flush=True)
    np.savez_compressed(FULLWIDTH, **out)
    print(f"wrote {FULLWIDTH}: {os.path.getsize(FULLWIDTH)} bytes")


def craft_grad_record(grads, keys, buckets=None):
    """{JAX path: gradient} -> the record's arrays for `keys`: each leaf's
    norm (float64) and sketch (float32; `chip_smoke.SKETCH_BUCKETS` buckets
    unless `buckets`)."""
    sys.path.insert(0, ROOT)
    import torch

    from chip_smoke import SKETCH_BUCKETS, grad_sketch

    out = {}
    for k in keys:
        g = np.asarray(grads[k], np.float64)
        out[f"norm/{k}"] = np.float64(np.linalg.norm(g.ravel()))
        out[f"sketch/{k}"] = grad_sketch(torch.from_numpy(g), k, buckets or SKETCH_BUCKETS
                                        ).numpy().astype(np.float32)
    return out


def gen_craft_grads():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import probe_torch_bf16 as probe
    from tuatara_tpu.utils.weights import flatten_tree, load_configs, load_weights_dir

    weights = os.path.join(ROOT, "evals", "production_weights")
    cfg = load_configs(weights)[0]
    with np.load(FULLWIDTH) as z:
        rec = {k: z[k] for k in ("pages", "heat")}
    grads = probe.jax_craft_grads(cfg, flatten_tree(load_weights_dir(weights)[0]),
                                  rec["pages"], rec["heat"])
    keys = sorted(k for k in grads if not probe.CRAFT_ZERO_GRAD.search(k)
                  and not k.endswith(("/mean", "/var")))
    out = craft_grad_record(grads, keys)
    np.savez_compressed(CRAFT_GRADS, **out)
    print(f"wrote {CRAFT_GRADS}: {len(keys)} leaves, {os.path.getsize(CRAFT_GRADS)} bytes")


def gen_words(n=256, seed=0):
    sys.path.insert(0, ROOT)
    from tuatara_tpu_torch.tokenizer import Tokenizer
    from tuatara_tpu_torch.utils.data import word_pool

    pool = word_pool(n, Tokenizer(), np.random.default_rng(seed), max_length=25, max_len=8)
    np.savez_compressed(WORDS, **pool)
    print(f"wrote {WORDS}: {n} crops, {os.path.getsize(WORDS)} bytes")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("tiny", "fullwidth", "words", "craft_grads", "all"),
                    default="all")
    part = ap.parse_args().part
    if part in ("tiny", "all"):
        gen_tiny()
    if part in ("words", "all"):
        gen_words()
    if part in ("fullwidth", "all"):
        gen_fullwidth()
    if part in ("craft_grads", "all"):
        gen_craft_grads()


if __name__ == "__main__":
    main()


# ---------------------------------------------------------------------------
# Reading the records (tests/test_torch_train_*.py)
# ---------------------------------------------------------------------------

def load_record(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def record_flat(rec, prefix):
    """{path: array} of the record's entries under `prefix/`."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in rec.items() if k.startswith(prefix + "/")}


def jax_tiny_params():
    """(CRAFT, PARSEQ) flat {path: array} of JAX's
    `init_train_state(PRNGKey(0))` at the tiny configs (the record's "p0",
    where the tiny records start; JAX draws them in ~20 s on a CPU)."""
    p0 = record_flat(load_record(TINY), "p0")
    return ({k[6:]: v for k, v in p0.items() if k.startswith("craft/")},
            {k[7:]: v for k, v in p0.items() if k.startswith("parseq/")})
