"""Where the port and JAX part at one compute dtype, on the CPU: CRAFT's
heatmaps of a page through both engines, the pixels whose side of each
threshold (text_threshold and low_text on the text map, link_threshold on
the link map) differs, and the records whose text or bbox differs, under
`OcrConfig()` or the `latency()` and `production()` presets (JAX's Pallas
recognizer kernels in interpret mode, all that Pallas runs on a CPU).

`tests/test_torch_capi.py` and `tests/test_torch_bf16.py` hold the port to
JAX with `compare`; run this file to print what it measures (a 200x300
crop of `resume_example` on the golden weights: `OcrConfig()` at both
dtypes, then `latency()` and `production()`, both bf16):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/probe_torch_bf16.py

Three more probes, each a word on the command line:

* `pages [PACKAGE_DIR]`: on the CPU, the port (or the `tuatara_tpu_torch`
  found under PACKAGE_DIR, e.g. a parent commit unpacked there) at
  `OcrConfig()` and `latency()` with the full-width
  `evals/production_weights` on the four main-path pages, the share of
  JAX's bf16 records (tests/fixtures/torch_reference_bf16.json) with the
  same text and bbox. Full width, the fp32 sums' order decides bf16
  roundings that grow through the layers, so this share is not 1.
* `residual`: a bf16 Linear whose output feeds an fp32 add (a residual,
  PARSEQ's `x + linear(h)`): the share of JAX's compiled values that each
  form of the port's gives (XLA drops the rounding of the bias add there).
* `resample`: table_english's shrinking, antialiased canvas resample at
  fp32 (ROADMAP Queue 3 item 6): `F.interpolate` against JAX's
  `jax.image.resize`, and the two-contraction form (JAX's weight matrix
  per axis, each output's taps fused in index order) beside it.
"""

import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def interpret_pallas():
    """Run the JAX package's Pallas recognizer kernels in interpret mode
    (wrapping the module functions the engine calls; the package is not
    edited). Idempotent."""
    import tuatara_tpu.ops.pallas.decode as pallas_decode
    import tuatara_tpu.ops.pallas.vit as pallas_vit

    def interpreted(fn):
        if getattr(fn, "interpreted", False):
            return fn

        def call(*args, **kwargs):
            kwargs["interpret"] = True
            return fn(*args, **kwargs)
        call.interpreted = True
        return call

    pallas_vit.vit_blocks_pallas = interpreted(pallas_vit.vit_blocks_pallas)
    pallas_decode.greedy_decode_pallas = interpreted(pallas_decode.greedy_decode_pallas)


def compare(page, weights_dir, dtype, preset="default"):
    """-> {"max_abs": {"text", "link"}, "mean_abs", "flips": {name: (threshold,
    [[y, x], ...])}, "records": (JAX's, the port's), "same": records equal
    in text and bbox}. `preset`: "default" (`OcrConfig(compute_dtype=dtype)`),
    "latency" or "production" (the preset, at its own bf16)."""
    import jax
    import jax.numpy as jnp

    import tuatara_tpu_torch
    from tuatara_tpu.api import OcrEngine as JaxEngine, _canvas_prep
    from tuatara_tpu.config import OcrConfig as JaxConfig
    from tuatara_tpu.models.craft import craft_forward
    from tuatara_tpu_torch.config import OcrConfig

    if preset == "default":
        jax_config, config = JaxConfig(compute_dtype=dtype), OcrConfig(compute_dtype=dtype)
    else:
        interpret_pallas()
        jax_config, config = getattr(JaxConfig, preset)(), getattr(OcrConfig, preset)()
        assert jax_config.compute_dtype == config.compute_dtype == dtype
    jax_engine = JaxEngine(jax_config, weights_dir=weights_dir)
    engine = tuatara_tpu_torch.OcrEngine(config, weights_dir=weights_dir, device="cpu")
    cfg = jax_engine.config
    canvases = jax.vmap(lambda im: _canvas_prep(im, cfg))(jnp.asarray(page[None]))
    want, _ = craft_forward(jax_engine.craft_params, canvases, jax_engine.craft_config,
                            compute_dtype=jnp.dtype(dtype))
    want = np.asarray(want.astype(jnp.float32))[0]
    got = engine.detect(torch.from_numpy(page[None]))["scores"].float().numpy()[0]
    diff = np.abs(want - got)
    flips = {}
    for name, ch, thr in (("text_threshold", 0, cfg.text_threshold),
                          ("low_text", 0, cfg.low_text),
                          ("link_threshold", 1, cfg.link_threshold)):
        flips[name] = (thr, np.argwhere((want[..., ch] > thr) != (got[..., ch] > thr)).tolist())
    records = jax_engine.run(page), engine.run(page)
    same = sum((a["text"], a["bbox"]) == (b["text"], b["bbox"]) for a, b in zip(*records))
    return {"max_abs": {"text": float(diff[..., 0].max()), "link": float(diff[..., 1].max())},
            "mean_abs": float(diff.mean()), "flips": flips, "records": records, "same": same}


def main():
    sys.path.insert(0, HERE)
    from torch_common import GOLDEN, image

    page = image("resume_example")[:200, :300].copy()
    for preset, dtype in (("default", "float32"), ("default", "bfloat16"),
                          ("latency", "bfloat16"), ("production", "bfloat16")):
        r = compare(page, GOLDEN, dtype, preset)
        print(f"{preset} {dtype}: heatmap max |JAX - port| text {r['max_abs']['text']} link "
              f"{r['max_abs']['link']}, mean {r['mean_abs']}")
        for name, (thr, px) in r["flips"].items():
            print(f"  {name} {thr}: {len(px)} pixels on the other side, first {px[:4]}")
        jax_rec, port_rec = r["records"]
        print(f"  records: {r['same']} of {len(port_rec)} equal (JAX {len(jax_rec)})")
        for a, b in zip(jax_rec, port_rec):
            if (a["text"], a["bbox"]) != (b["text"], b["bbox"]):
                print(f"    JAX {a['text']!r} {a['bbox']}  port {b['text']!r} {b['bbox']}")


def pages_share(package=None):
    """The `pages` probe (see the module docstring)."""
    if package:
        sys.path.insert(0, package)
    sys.path.insert(1, os.path.dirname(HERE))
    import tuatara_tpu_torch
    from chip_smoke import PAGES, word_share
    from tuatara_tpu_torch.utils.image import load_image

    root = os.path.dirname(HERE)
    with open(os.path.join(HERE, "fixtures", "torch_reference_bf16.json")) as f:
        ref = json.load(f)["variants"]
    weights = os.path.join(root, "evals", "production_weights")
    print(f"package: {os.path.dirname(tuatara_tpu_torch.__file__)}")
    for preset, cfg in (("default", tuatara_tpu_torch.OcrConfig()),
                        ("latency", tuatara_tpu_torch.OcrConfig.latency())):
        engine = tuatara_tpu_torch.OcrEngine(cfg, weights_dir=weights, device="cpu")
        hit = total = 0
        for page in PAGES:
            want = ref[preset]["pages"][page]["words"]
            got = engine.run(load_image(os.path.join(root, "images", f"{page}.png")))
            hit += round(word_share(want, got) * len(want))
            total += len(want)
        print(f"{preset}: {hit} of {total} JAX bf16 records ({hit / total:.4f})")


def residual_rounding():
    """The `residual` probe (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import torch.nn.functional as F

    from tuatara_tpu.models import layers as JL

    rng = np.random.default_rng(0)
    w = (rng.standard_normal((384, 384)) * 0.05).astype(np.float32)
    b = rng.standard_normal(384).astype(np.float32)
    h = rng.standard_normal((4, 26, 384)).astype(np.float32)
    x = rng.standard_normal((4, 26, 384)).astype(np.float32) * 3
    want = np.asarray(jax.jit(lambda x, h: x + JL.linear({"w": w, "b": b}, h, jnp.bfloat16))(x, h))
    y = F.linear(torch.from_numpy(h).bfloat16(), torch.from_numpy(w.T).bfloat16())
    bt, xt = torch.from_numpy(b).bfloat16(), torch.from_numpy(x)
    for name, got in (("x + bf16(y + b)", xt + (y + bt).float()),
                      ("x + (fp32(y) + fp32(b))", xt + (y.float() + bt.float()))):
        print(f"{name}: {np.mean(got.numpy() == want):.6f} of JAX's values equal")


def shrink_weights(n_in, n_out):
    """JAX's antialiased bilinear weight matrix for one axis of a shrink
    (`jax.image.resize`'s `compute_weight_mat`: the triangle kernel widened
    by the scale), computed in fp32 in the formula's order -> [n_in, n_out]."""
    inv = np.float32(n_in / n_out)
    scale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / scale
    w = np.maximum(np.float32(1.0) - x, np.float32(0.0))
    total = w.sum(0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resample_residual():
    """The `resample` probe (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    from tuatara_tpu_torch.config import OcrConfig
    from tuatara_tpu_torch.ops import resize as R

    sys.path.insert(0, HERE)
    from torch_common import image

    img = image("table_english")
    h, w, c = img.shape
    th, tw, _ = R.resize_geometry(h, w, OcrConfig())

    def jax_resize(x, shape):
        return np.asarray(jax.jit(lambda v: jax.image.resize(v, shape, "bilinear"))(x))

    want = jax_resize(img.astype(np.float32), (th, tw, c))

    def report(name, got):
        d = np.abs(got - want)
        print(f"{name}: {np.mean(got != want):.6f} of values differ, max {d.max():.3g}")

    report("F.interpolate(antialias=True)", R.resample(torch.from_numpy(img), th, tw).numpy())
    # JAX's own weight matrices, read back through an identity image.
    wh = jax_resize(np.eye(h, dtype=np.float32)[:, :, None], (th, h, 1))[:, :, 0].T
    ww = jax_resize(np.eye(w, dtype=np.float32)[:, :, None], (tw, w, 1))[:, :, 0].T
    ph, pw = shrink_weights(h, th), shrink_weights(w, tw)
    print(f"shrink_weights against JAX's matrices: {np.mean(ph != wh):.6f} and "
          f"{np.mean(pw != ww):.6f} of the entries differ")

    def fused_taps(x, wm, axis):
        """Contract `axis` with wm, each output's nonzero taps as a chain of
        fused multiply-adds in index order (float64 products, exact)."""
        x = np.moveaxis(x, axis, 0).astype(np.float64)
        out = np.zeros((wm.shape[1],) + x.shape[1:], np.float32)
        for j in range(wm.shape[1]):
            acc = np.zeros(x.shape[1:], np.float32)
            for k in np.nonzero(wm[:, j])[0]:
                acc = (x[k] * np.float64(wm[k, j]) + acc).astype(np.float32)
            out[j] = acc
        return np.moveaxis(out, 0, axis)

    for name, (a, b) in (("JAX's matrices", (wh, ww)), ("shrink_weights", (ph, pw))):
        report(f"two contractions, H then W, fused taps, {name}",
               fused_taps(fused_taps(img.astype(np.float32), a, 0), b, 1))


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "crop"
    if what == "pages":
        pages_share(sys.argv[2] if len(sys.argv) > 2 else None)
    elif what == "residual":
        residual_rounding()
    elif what == "resample":
        resample_residual()
    else:
        main()
