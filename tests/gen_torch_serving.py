"""Write the JAX record that `tests/test_torch_serving.py` holds the port's
serving loop to: the JAX engine's `run_stream`, `run_mixed` and `stats`
over one sequence of calls on small crops of the reference pages.

On `tests/fixtures/golden_weights` at `OcrConfig(**CONFIG)` (fp32, a box
budget of 16 and the slab ladder 4, 8, 16, so that a batch can outgrow the
bucket speculated for it), one fresh JAX engine runs

1. `run_stream(STREAM batches, prefetch=2, depth=1)`: seven batches of two
   96x128 crops, among them a batch whose 19 boxes outgrow the 4-row slab
   speculated from the first batch (a miss), a batch with no boxes (a
   wasted speculative slab, which drops the bucket) and batches that a
   larger slab than their own serves (hits);
2. `run_mixed(MIXED pages, max_batch=2)` twice: 96x120 RGB crops, 64x80
   gray crops ([H, W]) and 64x80 RGB crops, interleaved (the second call
   speculates each geometry's bucket from the first);

and the record keeps each call's results and the counters after it. The
crops are cut from the images that the port's PNG reader decodes
(`crop`), so both packages read the same pixels.

Writes tests/fixtures/torch_serving_golden.json.
Usage: PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_serving.py
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

from torch_common import GOLDEN, image, words  # noqa: E402

RECORD = os.path.join(HERE, "fixtures", "torch_serving_golden.json")
CONFIG = {"max_label_length": 7, "compute_dtype": "float32", "max_boxes": 16,
          "rec_buckets": [4, 8, 16]}
COUNTERS = ("pages", "batches", "boxes", "spec_hits", "spec_misses", "spec_wasted")
# A crop: [page, y, x, h, w, gray].
R = "resume_example"
F = "funsd_0001129658"
T = "table_english"
STREAM = [
    [[R, 0, 0, 96, 128, False], [R, 0, 256, 96, 128, False]],      # 2 boxes: slab 4
    [[R, 0, 384, 96, 128, False], [R, 192, 0, 96, 128, False]],    # 4
    [[R, 288, 128, 96, 128, False], [R, 96, 0, 96, 128, False]],   # 19 > 4: a miss
    [[R, 288, 0, 96, 128, False], [R, 480, 0, 96, 128, False]],    # 0: wasted
    [[R, 192, 384, 96, 128, False], [R, 384, 384, 96, 128, False]],  # 9 <= 32: a hit
    [[R, 576, 0, 96, 128, False], [R, 0, 128, 96, 128, False]],    # 6, no bucket
    [[R, 192, 0, 96, 128, False], [R, 576, 0, 96, 128, False]],    # 4 <= 16: a hit
]
MIXED = [
    [R, 192, 240, 96, 120, False],
    [F, 128, 160, 64, 80, True],
    [T, 0, 0, 96, 120, False],
    [F, 896, 160, 64, 80, True],
    [T, 128, 480, 64, 80, False],
    [R, 384, 480, 96, 120, False],
    [F, 256, 160, 64, 80, True],
]


def crop(spec):
    """[page, y, x, h, w, gray] -> the uint8 crop ([h, w] gray, else [h, w,
    3]) of the port-decoded reference image."""
    page, y, x, h, w, gray = spec
    return np.ascontiguousarray(image(page, keep_gray=gray)[y:y + h, x:x + w])


def stream_batches():
    return [np.stack([crop(c) for c in batch]) for batch in STREAM]


def mixed_pages():
    return [crop(c) for c in MIXED]


def counters(engine):
    return {k: engine.stats[k] for k in COUNTERS}


def jax_record():
    """The JAX engine over the sequence of calls. -> the record."""
    from tuatara_tpu.api import OcrEngine
    from tuatara_tpu.config import OcrConfig

    cfg = dict(CONFIG, rec_buckets=tuple(CONFIG["rec_buckets"]))
    engine = OcrEngine(OcrConfig(**cfg), weights_dir=GOLDEN)
    stream = engine.run_stream(stream_batches(), prefetch=2, depth=1)
    after_stream = counters(engine)
    mixed = [engine.run_mixed(mixed_pages(), max_batch=2) for _ in range(2)]
    return {"weights": "tests/fixtures/golden_weights", "config": CONFIG,
            "backend": "jax cpu", "stream": STREAM, "mixed": MIXED,
            "stream_results": [[words(p) for p in batch] for batch in stream],
            "stats_after_stream": after_stream,
            "mixed_results": [[words(p) for p in call] for call in mixed],
            "stats_after_mixed": counters(engine)}


def main():
    record = jax_record()
    print(record["stats_after_stream"], record["stats_after_mixed"])
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=0)
        f.write("\n")


if __name__ == "__main__":
    main()
