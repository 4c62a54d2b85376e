"""Write the JAX record that `tests/test_torch_decode_modes.py` holds the
port's beam and NAR decodes to, so that the test runs no JAX engine (each
page geometry costs the JAX engine a compile).

On `tests/fixtures/golden_weights` at `OcrConfig(max_label_length=7,
compute_dtype="float32", decode_mode=...)`, the JAX engine reads the five
reference pages as the port's PNG reader decodes them
(`torch_common.image`) under "beam" (beam_size 4, and 2 on two pages) and
"nar". Writes tests/fixtures/torch_decode_modes_golden.json.

Usage: PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_decode_modes.py
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

RECORD = os.path.join(HERE, "fixtures", "torch_decode_modes_golden.json")
BASE = {"max_label_length": 7, "compute_dtype": "float32"}
PAGES = ("funsd_0001129658", "funsd_91372360", "resume_example", "table_english",
         "rotated_text")
MODES = {
    "beam": ({"decode_mode": "beam"}, PAGES),
    "beam2": ({"decode_mode": "beam", "beam_size": 2}, ("resume_example", "rotated_text")),
    "nar": ({"decode_mode": "nar"}, PAGES),
}


def main():
    record = {"weights": "tests/fixtures/golden_weights", "config": BASE, "backend": "jax cpu",
              "modes": {}}
    for name, (over, pages) in MODES.items():
        engine = OcrEngine(OcrConfig(**BASE, **over), weights_dir=GOLDEN)
        record["modes"][name] = {"overrides": over,
                                 "pages": {p: words(engine.run(image(p))) for p in pages}}
        print(name, {p: len(w) for p, w in record["modes"][name]["pages"].items()}, flush=True)
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=0)
        f.write("\n")


if __name__ == "__main__":
    main()
