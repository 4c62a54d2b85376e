"""Write the JAX records that `tests/test_torch_int8.py` holds the port's int8
serving to, so that the test runs no JAX engine (each page geometry costs
the JAX engine a compile).

The golden CRAFT tree (`tests/fixtures/golden_weights`) is BN-folded by the
JAX package and written, with the golden PARSEQ tree and config, to a
temporary weights directory (the test folds it the same way). On it the JAX
engine at `OcrConfig.production(compute_dtype="float32", max_label_length=7,
encoder_impl="pallas", decode_impl="pallas")` (int8 CRAFT, dynamic scales;
at fp32 the recognizer takes the XLA lowering) reads the five reference
pages, then calibrates on two of them. Writes

* tests/fixtures/torch_int8_golden.json: per page {text, bbox, confidence};
* tests/fixtures/torch_int8_golden_calibration.npz: the calibrated scales,
  as `OcrEngine.save_calibration` writes them.

Usage: PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_int8.py
"""

import json
import os
import shutil
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from tuatara_tpu.api import OcrEngine  # noqa: E402
from tuatara_tpu.config import OcrConfig  # noqa: E402
from tuatara_tpu.models.craft import fold_batchnorms  # noqa: E402
from tuatara_tpu.utils import weights as W  # noqa: E402
from tuatara_tpu.utils.image import load_image  # noqa: E402

GOLDEN = os.path.join(HERE, "fixtures", "golden_weights")
PAGES = ("funsd_0001129658", "funsd_91372360", "resume_example", "table_english",
         "rotated_text")
CALIB_PAGES = ("resume_example", "rotated_text")
CONFIG = {"compute_dtype": "float32", "max_label_length": 7, "encoder_impl": "pallas",
          "decode_impl": "pallas"}


def folded_weights_dir(out: str) -> str:
    """The golden weights with CRAFT's BatchNorms folded by the JAX package."""
    craft, _ = W.load_weights_dir(GOLDEN)
    eps = json.load(open(os.path.join(GOLDEN, W.CONFIG_FILE)))["craft"]["bn_eps"]
    tree = fold_batchnorms(jax.tree_util.tree_map(jnp.asarray, craft), eps=eps)
    W.save_params(os.path.join(out, W.CRAFT_FILE), jax.tree_util.tree_map(np.asarray, tree))
    for f in (W.PARSEQ_FILE, W.CONFIG_FILE):
        shutil.copy(os.path.join(GOLDEN, f), out)
    return out


def main():
    with tempfile.TemporaryDirectory() as tmp:
        engine = OcrEngine(OcrConfig.production(**CONFIG), weights_dir=folded_weights_dir(tmp))
        pages = {}
        for name in PAGES:
            words = engine.run(load_image(os.path.join(ROOT, "images", f"{name}.png")))
            pages[name] = [{"text": w["text"], "bbox": w["bbox"],
                            "confidence": round(w["confidence"], 6)} for w in words]
            print(name, len(words), flush=True)
        n = engine.calibrate([load_image(os.path.join(ROOT, "images", f"{name}.png"))[None]
                              for name in CALIB_PAGES])
        engine.save_calibration(os.path.join(HERE, "fixtures",
                                             "torch_int8_golden_calibration.npz"))
    with open(os.path.join(HERE, "fixtures", "torch_int8_golden.json"), "w") as f:
        json.dump({"weights": "tests/fixtures/golden_weights, CRAFT BN-folded by the JAX "
                              "package",
                   "config": {"preset": "production", **CONFIG},
                   "calibration": {"pages": list(CALIB_PAGES), "layers": n},
                   "backend": "jax cpu", "pages": pages}, f, indent=0)
        f.write("\n")


if __name__ == "__main__":
    main()
