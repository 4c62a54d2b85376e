"""Write the JAX records that `tests/test_torch_int8_encoder.py` holds the
port's int8 recognizer encoder to, so that the test runs no JAX engine.

The golden CRAFT tree is BN-folded by the JAX package
(`gen_torch_int8.folded_weights_dir`, as the test folds it). On it, at
compute_dtype float32 and max_label_length 7, the JAX engine reads the
five reference pages as the port's PNG reader decodes them under

* "quantized": `OcrConfig(quantized_serving=True)` (int8 CRAFT and int8
  encoder, dynamic scales);
* "production_xla": `OcrConfig.production(encoder_impl="xla")`;
* "calibrated": the "quantized" engine after `calibrate` on two pages,
  whose scales (CRAFT's and the encoder's) are written as
  tests/fixtures/torch_int8_encoder_calibration.npz;

and, for the serving loop with the dynamic int8 encoder, the JAX engine
at `OcrConfig(quantized_serving=True)` with the serving test's budget
(`gen_torch_serving.CONFIG`) runs `gen_torch_serving.STREAM` once as
`run_stream(prefetch=2, depth=1)` and once as a `run_pages` loop, each on
a fresh engine. Writes tests/fixtures/torch_int8_encoder_golden.json.

Usage: PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_int8_encoder.py
"""

import json
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from tuatara_tpu.api import OcrEngine  # noqa: E402
from tuatara_tpu.config import OcrConfig  # noqa: E402
from gen_torch_int8 import folded_weights_dir  # noqa: E402
from gen_torch_serving import CONFIG as SERVING, STREAM, stream_batches  # noqa: E402
from torch_common import image, words  # noqa: E402

RECORD = os.path.join(HERE, "fixtures", "torch_int8_encoder_golden.json")
CALIBRATION = os.path.join(HERE, "fixtures", "torch_int8_encoder_calibration.npz")
BASE = {"compute_dtype": "float32", "max_label_length": 7}
PAGES = ("funsd_0001129658", "funsd_91372360", "resume_example", "table_english",
         "rotated_text")
CALIB_PAGES = ("resume_example", "rotated_text")


def main():
    record = {"weights": "tests/fixtures/golden_weights, CRAFT BN-folded by the JAX package",
              "config": BASE, "backend": "jax cpu", "calibration": {"pages": CALIB_PAGES}}
    with tempfile.TemporaryDirectory() as tmp:
        wdir = folded_weights_dir(tmp)
        quantized = OcrEngine(OcrConfig(quantized_serving=True, **BASE), weights_dir=wdir)
        production = OcrEngine(OcrConfig.production(encoder_impl="xla", **BASE),
                               weights_dir=wdir)
        for name, engine in (("quantized", quantized), ("production_xla", production)):
            record[name] = {p: words(engine.run(image(p))) for p in PAGES}
            print(name, {p: len(w) for p, w in record[name].items()}, flush=True)
        record["calibration"]["layers"] = quantized.calibrate(
            [image(p)[None] for p in CALIB_PAGES])
        quantized.save_calibration(CALIBRATION)
        record["calibrated"] = {p: words(quantized.run(image(p))) for p in PAGES}
        serving = dict(SERVING, rec_buckets=tuple(SERVING["rec_buckets"]),
                       compute_dtype="float32", quantized_serving=True)
        engine = OcrEngine(OcrConfig(**serving), weights_dir=wdir)
        stream = engine.run_stream(stream_batches(), prefetch=2, depth=1)
        engine = OcrEngine(OcrConfig(**serving), weights_dir=wdir)
        loop = [engine.run_pages(b) for b in stream_batches()]
        record["serving"] = {"config": dict(serving, rec_buckets=SERVING["rec_buckets"]),
                             "stream": STREAM,
                             "stream_results": [[words(p) for p in b] for b in stream],
                             "loop_results": [[words(p) for p in b] for b in loop]}
        print("stream == loop:", record["serving"]["stream_results"]
              == record["serving"]["loop_results"], flush=True)
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=0)
        f.write("\n")


if __name__ == "__main__":
    main()
