"""Table-page example, the counterpart of the reference's
examples/table.cpp, which takes only the image on its argv and reads its
weights from a fixed path: here `./weights` when that directory exists,
else random weights. Prints each word's record and the count of boxes.

    python -m tuatara_tpu_torch.examples.table [image] [--device D]
"""

import argparse
import os

from tuatara_tpu_torch.api import image_to_data
from tuatara_tpu_torch.utils.image import asset_path, load_image

DEFAULT_WEIGHTS = "./weights"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tuatara_tpu_torch.examples.table")
    ap.add_argument("image", nargs="?", default=None,
                    help="page to read (default: the repo's table_english.png)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    path = args.image or asset_path("table_english.png")
    weights = DEFAULT_WEIGHTS if os.path.isdir(DEFAULT_WEIGHTS) else None
    results = image_to_data(load_image(path), weights, "./outputs", device=args.device)
    for r in results:
        print(r)
    print(f"{len(results)} boxes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
