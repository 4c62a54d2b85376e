"""Write the JAX record that the port's rotated-box and tiling tests hold it
to (`tests/test_torch_rotated.py`, `tests/test_torch_tiling.py`), so that
those tests run no JAX engine but one live case a file.

On `tests/fixtures/golden_weights` at `OcrConfig(max_label_length=7,
compute_dtype="float32", **overrides)`, the JAX engine reads the reference
pages as the port's PNG reader decodes them (`torch_common.image`), one
section a variant of `VARIANTS`: {variant: {"config": overrides, "pages":
{page: words}}}. A page name ending in "/gray" is that page read as
[H, W] gray.

Writes tests/fixtures/torch_geometry_golden.json.
Usage: PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_geometry.py
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from tuatara_tpu.api import OcrEngine  # noqa: E402
from tuatara_tpu.config import OcrConfig  # noqa: E402
from torch_common import GOLDEN, image, words  # noqa: E402

RECORD = os.path.join(HERE, "fixtures", "torch_geometry_golden.json")
BASE = {"max_label_length": 7, "compute_dtype": "float32"}
PAGES = ("funsd_0001129658", "funsd_91372360", "resume_example", "table_english",
         "rotated_text")
TILED = {"tiled_detection": True, "canvas_size": 512, "tile_overlap": 256}
VARIANTS = {
    "rotated_exact": ({"box_mode": "rotated", "rotated_fit": "exact"}, PAGES),
    "rotated_pca": ({"box_mode": "rotated", "rotated_fit": "pca"}, PAGES),
    # All but rotated_text (275 wide) tile at canvas 512.
    "tiled": (TILED, PAGES + ("funsd_0001129658/gray",)),
    "tiled_1024": ({"tiled_detection": True}, ("table_english",)),
    # Upsampled before tiling: the resample differs from XLA's by an ulp
    # (ROADMAP Queue 3, item 6), so the test holds a share of words.
    "tiled_mag_1.5": ({"tiled_detection": True, "mag_ratio": 1.5}, ("resume_example",)),
    "rotated_tiled": ({**TILED, "box_mode": "rotated"}, ("table_english", "rotated_text")),
}


def page(name):
    base, _, kind = name.partition("/")
    return image(base, keep_gray=kind == "gray")


def main():
    record = {"weights": "tests/fixtures/golden_weights", "base": BASE, "backend": "jax cpu",
              "variants": {}}
    for variant, (overrides, names) in VARIANTS.items():
        eng = OcrEngine(OcrConfig(**BASE, **overrides), weights_dir=GOLDEN)
        record["variants"][variant] = {
            "config": overrides, "pages": {n: words(eng.run(page(n))) for n in names}}
        print(variant, {n: len(w) for n, w in record["variants"][variant]["pages"].items()},
              flush=True)
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=0)
        f.write("\n")


if __name__ == "__main__":
    main()
