"""Write the JAX records that the port's engine tests hold it to, so that
those tests run no JAX engine (each page geometry costs the JAX engine a
compile on the CPU; the JAX package does not change, so its record equals
a live run, and each test file keeps one live case that would show a stale
record).

On `tests/fixtures/golden_weights` at `OcrConfig(max_label_length=7,
compute_dtype="float32", **overrides)`, the JAX engine reads, as the
port's PNG reader decodes them (`torch_common.image`):

* "default": the five reference pages (`tests/test_torch_engine.py`);
* "low_threshold": three of them at `text_threshold=0.3`
  (`tests/test_torch_engine_configs.py`);
* "configs": each user configuration of
  `tests/test_torch_engine_user_configs.py`, on `resume_example`, or for
  the max_boxes cases on a two-page batch of `funsd_0001129658` and its
  mirror image (one result list a page).

Writes tests/fixtures/torch_engine_golden.json.
Usage: PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_engine.py
"""

import json
import os
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

sys.path.insert(0, HERE)

from tuatara_tpu.api import OcrEngine  # noqa: E402
from tuatara_tpu.config import OcrConfig  # noqa: E402
from torch_common import GOLDEN, image, words  # noqa: E402

RECORD = os.path.join(HERE, "fixtures", "torch_engine_golden.json")
BASE = {"max_label_length": 7, "compute_dtype": "float32"}
PAGES = ("funsd_0001129658", "funsd_91372360", "resume_example", "table_english",
         "rotated_text")
LOW_PAGES = ("funsd_0001129658", "resume_example", "rotated_text")
LOW_THRESHOLD = {"text_threshold": 0.3}
# ROADMAP Queue 3, item 2. The max_boxes cases run a two-page batch, so
# there are more live boxes than the budget holds.
USER_CONFIGS = {
    "mag_ratio_1.5": {"mag_ratio": 1.5},
    "channel_mode_cpp": {"channel_mode": "cpp"},
    "channel_mode_rgb": {"channel_mode": "rgb"},
    "niter_upstream": {"niter_mode": "upstream"},
    "canvas_512": {"canvas_size": 512},
    "canvas_bucket_0": {"canvas_bucket": 0},
    "max_boxes_16": {"max_boxes": 16},
    "max_boxes_16_slab_8": {"max_boxes": 16, "rec_slab_multiple": 8},
}


def two_page_batch():
    """funsd_0001129658 and its mirror image, [2, H, W, 3]."""
    img = image("funsd_0001129658")
    return np.stack([img, img[:, ::-1].copy()])


def engine(**overrides):
    return OcrEngine(OcrConfig(**BASE, **overrides), weights_dir=GOLDEN)


def main():
    record = {"weights": "tests/fixtures/golden_weights", "config": BASE,
              "backend": "jax cpu", "low_threshold_config": LOW_THRESHOLD,
              "user_configs": USER_CONFIGS}
    eng = engine()
    record["default"] = {n: words(eng.run(image(n))) for n in PAGES}
    eng = engine(**LOW_THRESHOLD)
    record["low_threshold"] = {n: words(eng.run(image(n))) for n in LOW_PAGES}
    record["configs"] = {}
    for name, overrides in USER_CONFIGS.items():
        eng = engine(**overrides)
        if "max_boxes" in overrides:
            record["configs"][name] = [words(p) for p in eng.run_pages(two_page_batch())]
        else:
            record["configs"][name] = words(eng.run(image("resume_example")))
        print(name, flush=True)
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=0)
        f.write("\n")


if __name__ == "__main__":
    main()
