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
a variant. `--config modes` runs `decode_mode` "beam" and "nar" and
`quantized_serving=True` (int8 CRAFT and int8 recognizer encoder)
calibrated on resume_example and rotated_text, into
`torch_reference_modes.json`. `--config bf16` runs, at their own compute
dtype, bf16, on the four pages, into `torch_reference_bf16.json`:
`OcrConfig()` ("default"); `OcrConfig.latency()` ("latency"), which off a
TPU serves XLA's eager encoder and scan decode (exact GELU), not the
Pallas recognizer kernels; and `latency()` and `production()` with
`encoder_impl="pallas", decode_impl="pallas"` ("latency_pallas",
"production_pallas"), the algorithm they serve on a TPU: the fused ViT
kernel in interpret mode and the fused greedy decode by the JAX tests'
eager transcription of its kernel (`probe_torch_bf16.pallas_reference`;
each of these entries states its algorithm and the commit it was made
at). `--variant NAME` (repeatable) remakes only those variants of the
config's file and keeps the others as they are. The GPU machine has no
JAX, so the references are recorded here and committed (a few KB each).

Usage: PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_reference.py
       [--config default|lowthresh|rotated|tiled|modes|bf16] [--variant NAME ...]
"""

import argparse
import json
import os
import subprocess
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
    "modes": ("torch_reference_modes.json", {
        "beam": {"compute_dtype": "float32", "decode_mode": "beam"},
        "nar": {"compute_dtype": "float32", "decode_mode": "nar"},
        "int8_calibrated": {"compute_dtype": "float32", "quantized_serving": True}}),
    # A preset of `probe_torch_bf16.PRESETS` by name ("preset"), the four
    # pages only.
    "bf16": ("torch_reference_bf16.json", {
        "default": {}, "latency": {"preset": "latency"},
        "latency_pallas": {"preset": "latency_pallas"},
        "production_pallas": {"preset": "production_pallas"}}),
}
# What the forced-Pallas variants run, as their entries state it.
PALLAS_ALGORITHM = {
    "encoder": "vit_blocks_pallas in interpret mode",
    "decode": ("greedy_decode_pallas computed by tests/test_pallas_decode.py "
               "_simulate_kernel, eagerly, over the kernel's tiles with its tile early exit "
               "(compiled by XLA's CPU backend, interpret mode drops the kernel's bf16 "
               "rounding of the attention products)")}
# Variants whose engine calibrates first, on these pages.
CALIBRATED = {"int8_calibrated": ("resume_example", "rotated_text")}


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


def commit():
    """The repository's HEAD commit, with "+changes" if the JAX package or
    the kernel transcription differ from it (what the record depends on)."""
    def git(*a):
        return subprocess.run(["git", *a], cwd=ROOT, capture_output=True, text=True).stdout
    dirty = git("status", "--porcelain", "--", "tuatara_tpu", "tests/test_pallas_decode.py")
    return git("rev-parse", "HEAD").strip() + ("+changes" if dirty.strip() else "")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=sorted(CONFIGS) + sorted(VARIANTS), default="default")
    ap.add_argument("--variant", action="append")
    args = ap.parse_args()
    which = args.config
    if which in VARIANTS:
        name, variants = VARIANTS[which]
        path = os.path.join(HERE, "fixtures", name)
        record = {"weights": "evals/production_weights", "backend": "jax cpu", "variants": {}}
        if args.variant:
            if not set(args.variant) <= set(variants):
                ap.error(f"--variant: {which} has {sorted(variants)}")
            with open(path) as f:
                record = json.load(f)
            variants = {k: variants[k] for k in args.variant}
        for variant, overrides in variants.items():
            overrides = dict(overrides)
            preset = overrides.pop("preset", None)
            if preset:
                sys.path.insert(0, HERE)
                from probe_torch_bf16 import PRESETS, jax_config

                config = jax_config(preset)
                factory, forced = PRESETS[preset]
            else:
                config = OcrConfig(**overrides)
            engine = OcrEngine(config, weights_dir=WEIGHTS)
            if preset and forced:
                entry = {"config": {"preset": factory, **forced,
                                    "compute_dtype": config.compute_dtype},
                         "algorithm": PALLAS_ALGORITHM, "commit": commit()}
            else:
                entry = {"config": {"preset": preset or "OcrConfig", **overrides,
                                    "compute_dtype": config.compute_dtype}}
            if variant in CALIBRATED:
                entry["calibration_pages"] = CALIBRATED[variant]
                entry["calibration_layers"] = engine.calibrate(
                    [load_image(os.path.join(ROOT, "images", f"{n}.png"))[None]
                     for n in CALIBRATED[variant]])
            entry["pages"] = record_pages(engine, PAGES if which == "bf16" else GEOMETRY_PAGES)
            record["variants"][variant] = entry
        with open(path, "w") as f:
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
