"""Write the JAX reference that `chip_smoke.py` holds the port to on the GPU.

Runs the JAX package (`tuatara_tpu.OcrEngine`, CPU backend) at
`OcrConfig(compute_dtype="float32")` with the committed trained weights in
`evals/production_weights`, on the four pages of the port's main-path check,
and writes {text, bbox, confidence} per word to
`tests/fixtures/torch_reference_production.json`. With `--config lowthresh`
it runs `OcrConfig(compute_dtype="float32", text_threshold=0.3)` instead
(the detection branch text_threshold < low_text) and writes
`tests/fixtures/torch_reference_lowthresh.json`. `--config rotated` runs
`box_mode="rotated"` with `rotated_fit` "exact" and "pca", `--config tiled`
runs `tiled_detection=True` at canvas 1024 (only table_english tiles) and
512 (all four tile), each on the four pages and `rotated_text`, into
`torch_reference_rotated.json` / `torch_reference_tiled.json`, one section
a variant. The GPU machine has no JAX, so the references are recorded
here and committed (a few KB each).

Usage: PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_reference.py
       [--config default|lowthresh|rotated|tiled]
"""

import argparse
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from tuatara_tpu.api import OcrEngine  # noqa: E402
from tuatara_tpu.config import OcrConfig  # noqa: E402
from tuatara_tpu.utils.image import load_image  # noqa: E402

WEIGHTS = os.path.join(ROOT, "evals", "production_weights")
PAGES = ("resume_example", "funsd_0001129658", "funsd_91372360", "table_english")
CONFIGS = {
    "default": ({"compute_dtype": "float32"}, "torch_reference_production.json"),
    "lowthresh": ({"compute_dtype": "float32", "text_threshold": 0.3},
                  "torch_reference_lowthresh.json"),
}
GEOMETRY_PAGES = PAGES + ("rotated_text",)
# --config -> (file, {variant: overrides}), each variant over GEOMETRY_PAGES.
VARIANTS = {
    "rotated": ("torch_reference_rotated.json", {
        "exact": {"compute_dtype": "float32", "box_mode": "rotated", "rotated_fit": "exact"},
        "pca": {"compute_dtype": "float32", "box_mode": "rotated", "rotated_fit": "pca"}}),
    "tiled": ("torch_reference_tiled.json", {
        "canvas1024": {"compute_dtype": "float32", "tiled_detection": True},
        "canvas512": {"compute_dtype": "float32", "tiled_detection": True,
                      "canvas_size": 512}}),
}


def record_pages(engine, names):
    pages = {}
    for name in names:
        img = load_image(os.path.join(ROOT, "images", f"{name}.png"))
        words = engine.run(img)
        pages[name] = {
            "shape": list(img.shape),
            "words": [{"text": w["text"], "bbox": w["bbox"],
                       "confidence": round(w["confidence"], 6)} for w in words],
        }
        print(name, len(words), " ".join(w["text"] for w in words[:8]), flush=True)
    return pages


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=sorted(CONFIGS) + sorted(VARIANTS), default="default")
    which = ap.parse_args().config
    if which in VARIANTS:
        name, variants = VARIANTS[which]
        record = {"weights": "evals/production_weights", "backend": "jax cpu", "variants": {}}
        for variant, overrides in variants.items():
            engine = OcrEngine(OcrConfig(**overrides), weights_dir=WEIGHTS)
            record["variants"][variant] = {"config": overrides,
                                           "pages": record_pages(engine, GEOMETRY_PAGES)}
        with open(os.path.join(HERE, "fixtures", name), "w") as f:
            json.dump(record, f, indent=0)
            f.write("\n")
        return
    overrides, name = CONFIGS[which]
    out = os.path.join(HERE, "fixtures", name)
    engine = OcrEngine(OcrConfig(**overrides), weights_dir=WEIGHTS)
    pages = record_pages(engine, PAGES)
    with open(out, "w") as f:
        json.dump({"weights": "evals/production_weights",
                   "config": overrides,
                   "backend": "jax cpu", "pages": pages}, f, indent=0)
        f.write("\n")


if __name__ == "__main__":
    main()
