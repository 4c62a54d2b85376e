"""Weight-conversion command line: the reference's TorchScript artifacts ->
the engine's npz weights directory (port of `tuatara_tpu/convert.py`).

    python -m tuatara_tpu_torch.convert /path/to/reference/weights ./weights
    python -m tuatara_tpu_torch page.png ./weights

The reference directory holds `craft_traced_torchscript_model.pt` and
`parseq_torchscript.bin` (plain torch checkpoints under those names are
read too). The normalization probe runs the port's forward on `--device`
(default: the card; `--device cpu` on a machine without one). The
directory written serves in either package's engine.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tuatara_tpu_torch.convert",
        description="Convert reference TorchScript weights (craft_traced_torchscript_model.pt "
                    "+ parseq_torchscript.bin) to the engine's npz format")
    p.add_argument("reference_weights_dir", help="directory holding the two TorchScript artifacts")
    p.add_argument("out_weights_dir", help="output directory for craft.npz / parseq.npz")
    p.add_argument("--device", default=None,
                   help="device of the normalization probe's forward (default: the GPU)")
    args = p.parse_args(argv)

    from tuatara_tpu_torch.utils.convert import convert_torchscript_weights

    verdicts = convert_torchscript_weights(args.reference_weights_dir, args.out_weights_dir,
                                           device=args.device)
    print(f"converted -> {args.out_weights_dir} (craft.npz, parseq.npz); input normalization: "
          f"craft {verdicts['craft']}, parseq {verdicts['parseq']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
