"""Resume-page example, the counterpart of the reference's
examples/resume.cpp (argv: image, weights_dir, outputs_dir): prints each
word's record and the count of boxes. With no weights_dir the engine
serves random weights.

    python -m tuatara_tpu_torch.examples.resume [image] [weights_dir] [outputs_dir] [--device D]
"""

import argparse

from tuatara_tpu_torch.api import image_to_data
from tuatara_tpu_torch.utils.image import asset_path, load_image


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tuatara_tpu_torch.examples.resume")
    ap.add_argument("image", nargs="?", default=None,
                    help="page to read (default: the repo's resume_example.png)")
    ap.add_argument("weights_dir", nargs="?", default=None)
    ap.add_argument("outputs_dir", nargs="?", default=None, help="accepted and unused")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    path = args.image or asset_path("resume_example.png")
    results = image_to_data(load_image(path), args.weights_dir, args.outputs_dir,
                            device=args.device)
    for r in results:
        print(r)
    print(f"{len(results)} boxes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
