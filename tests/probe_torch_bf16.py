"""Where the port and JAX part at one compute dtype, on the CPU: CRAFT's
heatmaps of a page through both engines, the pixels whose side of each
threshold (text_threshold and low_text on the text map, link_threshold on
the link map) differs, and the records whose text or bbox differs.

`tests/test_torch_capi.py` holds the port to JAX with `compare`; run this
file to print what it measures (default: a 200x300 crop of
`resume_example` on the golden weights, both dtypes):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/probe_torch_bf16.py
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def compare(page, weights_dir, dtype):
    """-> {"max_abs": {"text", "link"}, "mean_abs", "flips": {name: (threshold,
    [[y, x], ...])}, "records": (JAX's, the port's), "same": records equal
    in text and bbox}."""
    import jax
    import jax.numpy as jnp

    import tuatara_tpu_torch
    from tuatara_tpu.api import OcrEngine as JaxEngine, _canvas_prep
    from tuatara_tpu.config import OcrConfig as JaxConfig
    from tuatara_tpu.models.craft import craft_forward
    from tuatara_tpu_torch.config import OcrConfig

    jax_engine = JaxEngine(JaxConfig(compute_dtype=dtype), weights_dir=weights_dir)
    engine = tuatara_tpu_torch.OcrEngine(OcrConfig(compute_dtype=dtype),
                                         weights_dir=weights_dir, device="cpu")
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
    for dtype in ("float32", "bfloat16"):
        r = compare(page, GOLDEN, dtype)
        print(f"{dtype}: heatmap max |JAX - port| text {r['max_abs']['text']} link "
              f"{r['max_abs']['link']}, mean {r['mean_abs']}")
        for name, (thr, px) in r["flips"].items():
            print(f"  {name} {thr}: {len(px)} pixels on the other side, first {px[:4]}")
        jax_rec, port_rec = r["records"]
        print(f"  records: {r['same']} of {len(port_rec)} equal (JAX {len(jax_rec)})")
        for a, b in zip(jax_rec, port_rec):
            if (a["text"], a["bbox"]) != (b["text"], b["bbox"]):
                print(f"    JAX {a['text']!r} {a['bbox']}  port {b['text']!r} {b['bbox']}")


if __name__ == "__main__":
    main()
