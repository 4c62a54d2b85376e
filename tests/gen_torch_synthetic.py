"""Write the confident-input parity fixture for the port's `latency()` path.

Renders the 16 held-out TrueType synthetic pages of
`scripts/eval_parity_configs.py` (the JAX package's `synthetic_text_pages`:
rng 888, 256x256, 8 words of 2-8 characters per page, style "font") once,
and records from those very renders the JAX engine's bf16 result at
`OcrConfig(canvas_size=256, max_boxes=32, rec_buckets=(32,))` on
`evals/production_weights`: every page's words (text + bbox) and the
engine's word accuracy against the truths (`utils/metrics.evaluate_engine`,
IoU 0.5). The pages are stored as uint8, so no later comparison depends on
the fonts or PIL of the machine that reads them.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_synthetic.py

Writes tests/fixtures/torch_synthetic_pages.npz (pages) and .json (truths,
JAX words, JAX word accuracy).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_synthetic.py --config production

reads those pages and truths back and writes
tests/fixtures/torch_synthetic_production.json: the JAX engine's words and
word accuracy at `OcrConfig.production(canvas_size=256, max_boxes=32,
rec_buckets=(32,), encoder_impl="pallas", decode_impl="pallas")` (bf16,
int8 CRAFT with dynamic activation scales, the fused recognizer kernels;
without the two lowering fields a CPU backend would also quantize the
encoder). Pallas runs only in interpret mode on the CPU, so the two fused
kernels are called with interpret=True (about 8 s a page).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_synthetic.py --config production \
        --weights evals/production_weights_w64

does the same on another weights directory, at the crop width its
recognizer was trained for (`rec_width`, from its config.json): on the
width-64 weights, `production(rec_width=64, ...)`, written to
tests/fixtures/torch_synthetic_production_w64.json.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_synthetic.py \
        --config latency_beam|latency_nar|production_xla|quantized_fp32

writes tests/fixtures/torch_synthetic_<config>.json, the JAX engine's
words and word accuracy on the same pages at bf16 under
`latency(decode_mode="beam")`, `latency(decode_mode="nar")` (the Pallas
encoder in interpret mode, the XLA decode: JAX's `decode_impl` affects the
greedy decode only) and `production(encoder_impl="xla")` (int8 CRAFT and
int8 recognizer encoder; the greedy decode's Pallas kernel in interpret
mode), and at fp32 under `OcrConfig(quantized_serving=True)` (int8 CRAFT
and encoder), each with canvas_size=256, max_boxes=32, rec_buckets=(32,).
For the two int8 encoder variants it also calibrates the engine on the
first two pages and records the calibrated engine's words and accuracy
("calibrated").
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "evals", "production_weights")
OUT = os.path.join(ROOT, "tests", "fixtures", "torch_synthetic_pages")
N_PAGES = 16


def _interpret_pallas() -> None:
    """Run the JAX package's Pallas recognizer kernels in interpret mode,
    all that Pallas runs on a CPU."""
    import tuatara_tpu.ops.pallas.decode as pallas_decode
    import tuatara_tpu.ops.pallas.vit as pallas_vit

    def interpreted(fn):
        def call(*args, **kwargs):
            kwargs["interpret"] = True
            return fn(*args, **kwargs)
        return call

    pallas_vit.vit_blocks_pallas = interpreted(pallas_vit.vit_blocks_pallas)
    pallas_decode.greedy_decode_pallas = interpreted(pallas_decode.greedy_decode_pallas)


def production(weights: str) -> int:
    """The production() record on the pages and truths already written."""
    _interpret_pallas()
    from tuatara_tpu.api import OcrEngine
    from tuatara_tpu.config import OcrConfig
    from tuatara_tpu.utils.metrics import evaluate_engine
    from tuatara_tpu.utils.weights import load_configs

    config = dict(canvas_size=256, max_boxes=32, rec_buckets=(32,), encoder_impl="pallas",
                  decode_impl="pallas")
    rec_width = load_configs(weights)[1].img_size[1]
    if rec_width != OcrConfig().rec_width:
        config["rec_width"] = rec_width
    engine = OcrEngine(OcrConfig.production(**config), weights_dir=weights)
    pages = np.load(OUT + ".npz")["pages"]
    with open(OUT + ".json") as f:
        truths = json.load(f)["truths"]
    words = [[{"text": w["text"], "bbox": [float(v) for v in w["bbox"]]}
              for w in engine.run(img)] for img in pages]
    scores = evaluate_engine(engine, list(pages), truths, iou_threshold=0.5)
    suffix = f"_w{rec_width}" if "rec_width" in config else ""
    out = os.path.join(ROOT, "tests", "fixtures", f"torch_synthetic_production{suffix}.json")
    with open(out, "w") as f:
        json.dump({
            "what": ("JAX engine production() words on the 16 held-out synthetic pages of "
                     "torch_synthetic_pages.npz (int8 CRAFT, dynamic activation scales; "
                     "Pallas recognizer kernels in interpret mode)"),
            "config": {"preset": "production", **config, "rec_buckets": [32],
                       "compute_dtype": "bfloat16"},
            "weights": os.path.relpath(weights, ROOT),
            "word_acc": scores["word_acc"], "matched": scores["matched"],
            "words": words}, f, indent=1)
    print(f"wrote {out}: word_acc {scores['word_acc']:.4f}, "
          f"{sum(len(w) for w in words)} JAX words")
    return 0


VARIANTS = {  # name -> (OcrConfig preset or None, overrides, also calibrated)
    "latency_beam": ("latency", {"decode_mode": "beam"}, False),
    "latency_nar": ("latency", {"decode_mode": "nar"}, False),
    "production_xla": ("production", {"encoder_impl": "xla"}, True),
    "quantized_fp32": (None, {"quantized_serving": True, "compute_dtype": "float32"}, True),
}
CALIB_PAGES = 2  # the int8 encoder variants' calibrated engine: the first two pages


def variant(name: str) -> int:
    """One of VARIANTS on the pages and truths already written."""
    _interpret_pallas()
    from tuatara_tpu.api import OcrEngine
    from tuatara_tpu.config import OcrConfig
    from tuatara_tpu.utils.metrics import evaluate_engine

    preset, over, calibrated = VARIANTS[name]
    config = dict(canvas_size=256, max_boxes=32, rec_buckets=(32,), **over)
    make = getattr(OcrConfig, preset) if preset else OcrConfig
    engine = OcrEngine(make(**config), weights_dir=WEIGHTS)
    pages = np.load(OUT + ".npz")["pages"]
    with open(OUT + ".json") as f:
        truths = json.load(f)["truths"]

    def run():
        words = [[{"text": w["text"], "bbox": [float(v) for v in w["bbox"]]}
                  for w in engine.run(img)] for img in pages]
        scores = evaluate_engine(engine, list(pages), truths, iou_threshold=0.5)
        return {"word_acc": scores["word_acc"], "matched": scores["matched"], "words": words}

    dtype = over.get("compute_dtype", "bfloat16")
    record = {"what": (f"JAX engine {preset or 'OcrConfig'}({over}) words on the 16 held-out "
                       f"synthetic pages of torch_synthetic_pages.npz, {dtype}; Pallas kernels "
                       "in interpret mode"),
              "config": {"preset": preset, **config, "rec_buckets": [32], "compute_dtype": dtype},
              "weights": "evals/production_weights", **run()}
    if calibrated:
        record["calibration_pages"] = CALIB_PAGES
        record["calibration_layers"] = engine.calibrate([p[None] for p in pages[:CALIB_PAGES]])
        record["calibrated"] = run()
    out = os.path.join(ROOT, "tests", "fixtures", f"torch_synthetic_{name}.json")
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {out}: word_acc {record['word_acc']:.4f}, "
          f"{sum(len(w) for w in record['words'])} JAX words")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("default", "production") + tuple(VARIANTS),
                    default="default")
    ap.add_argument("--weights", default=WEIGHTS,
                    help="weights directory of the production() record")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.config == "production":
        return production(os.path.abspath(args.weights))
    if args.config in VARIANTS:
        return variant(args.config)
    from tuatara_tpu.api import OcrEngine
    from tuatara_tpu.config import OcrConfig
    from tuatara_tpu.utils.data import synthetic_text_pages
    from tuatara_tpu.utils.metrics import evaluate_engine

    engine = OcrEngine(OcrConfig(canvas_size=256, max_boxes=32, rec_buckets=(32,)),
                       weights_dir=WEIGHTS)
    held = synthetic_text_pages(N_PAGES, engine.tokenizer, np.random.default_rng(888),
                                size=256, words_per_page=8, max_len=8, style="font")
    pages = (held["pages"] * 255).astype(np.uint8)
    words = [[{"text": w["text"], "bbox": [float(v) for v in w["bbox"]]}
              for w in engine.run(img)] for img in pages]
    scores = evaluate_engine(engine, list(pages), held["truths"], iou_threshold=0.5)
    truths = [[{"text": t["text"], "bbox": [float(v) for v in t["bbox"]]} for t in page]
              for page in held["truths"]]
    np.savez_compressed(OUT + ".npz", pages=pages)
    with open(OUT + ".json", "w") as f:
        json.dump({
            "what": ("JAX engine bf16 words on 16 held-out TrueType synthetic pages "
                     "(synthetic_text_pages rng 888, size 256, 8 words/page, font); "
                     "pages in the .npz as uint8"),
            "config": {"canvas_size": 256, "max_boxes": 32, "rec_buckets": [32],
                       "compute_dtype": "bfloat16"},
            "weights": "evals/production_weights",
            "word_acc": scores["word_acc"], "matched": scores["matched"],
            "truths": truths, "words": words}, f, indent=1)
    print(f"wrote {OUT}.npz/.json: word_acc {scores['word_acc']:.4f}, "
          f"{sum(len(w) for w in words)} JAX words")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
