"""Command line of the port: `python -m tuatara_tpu_torch image [weights_dir]
[outputs_dir] [flags]`, the JAX package's `tuatara_tpu/cli.py` argv and
flags (positional arguments in the reference examples' order). Prints one
JSON object a word (a line with `--lines`, a block with `--blocks`) and
the elapsed time on stderr; `--eval` scores the words against ground truth
on stderr; `--annotate` writes a three-panel render. `--encoder-impl` and
`--decode-impl` keep JAX's names: "pallas" selects the port's CUDA kernels
K6 and K7, "xla" the plain PyTorch lowering. The engine runs on the card
unless `--device cpu` is given. With no weights_dir it serves random
weights (seed 0), as the JAX command line does.

    python -m tuatara_tpu_torch images/resume_example.png evals/production_weights
    python -m tuatara_tpu_torch page.png weights --device cpu --lines --eval truth.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tuatara_tpu_torch",
        description="Two-stage OCR (CRAFT detect + PARSEQ recognize) in PyTorch with "
                    "hand-written CUDA kernels")
    p.add_argument("image", help="input image path (PNG)")
    p.add_argument("weights_dir", nargs="?", default=None,
                   help="directory with craft.npz/parseq.npz (omit: random weights)")
    p.add_argument("outputs_dir", nargs="?", default=None,
                   help="accepted for reference-CLI parity; unused")
    p.add_argument("--annotate", metavar="PNG",
                   help="write a 3-panel annotated render (boxes, text, reading order)")
    p.add_argument("--json-out", metavar="FILE", help="write results as a JSON file")
    p.add_argument("--canvas-size", type=int, default=None)
    p.add_argument("--text-threshold", type=float, default=None)
    p.add_argument("--link-threshold", type=float, default=None)
    p.add_argument("--low-text", type=float, default=None)
    p.add_argument("--box-mode", choices=["axis", "rotated"], default=None)
    p.add_argument("--decode-mode", choices=["greedy", "beam", "nar"], default=None)
    p.add_argument("--beam-size", type=int, default=None)
    p.add_argument("--channel-mode", choices=["python", "cpp", "rgb"], default=None)
    p.add_argument("--encoder-impl", choices=["xla", "pallas"], default=None,
                   help="recognizer encoder: pallas = the fused CUDA kernel K6 (bf16 "
                        "only); default xla, plain PyTorch")
    p.add_argument("--decode-impl", choices=["xla", "pallas"], default=None,
                   help="greedy decode: pallas = the fused CUDA kernel K7 (bf16 only); "
                        "default xla, plain PyTorch")
    p.add_argument("--latency", action="store_true",
                   help="single-image latency preset (OcrConfig.latency): exact-fit "
                        "canvas, finer recognition buckets, the K6/K7 kernels; explicit "
                        "flags still override")
    p.add_argument("--quantized", action="store_true",
                   help="int8 detector and recognizer encoder (quantized_serving)")
    p.add_argument("--calibrate", action="store_true",
                   help="with --quantized and a weights_dir: freeze static int8 "
                        "activation scales from this image and save them as "
                        "calibration.npz next to the weights (later runs load them)")
    p.add_argument("--charset", choices=["standard", "extended", "reference"], default=None,
                   help="recognizer decode table (default: the charset stored next to "
                        "the weights, else standard)")
    p.add_argument("--blocks", action="store_true",
                   help="group words into blocks of lines (implies --lines)")
    p.add_argument("--lines", action="store_true",
                   help="group words into lines (one JSON object a line, with its words)")
    p.add_argument("--eval", metavar="TRUTH_JSON",
                   help="score the words against ground truth and print {precision, "
                        "recall, f1, cer, word_acc, ...} to stderr: a FUNSD annotation "
                        "file (with a 'form' key) or a [{text, bbox}] list")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card; 'cpu' to run on "
                        "the CPU)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.calibrate and not (args.quantized and args.weights_dir):
        parser.error("--calibrate requires --quantized and a weights_dir")
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(name)s %(levelname)s %(message)s")

    from tuatara_tpu_torch.api import get_engine
    from tuatara_tpu_torch.config import DEFAULT_CONFIG, OcrConfig
    from tuatara_tpu_torch.utils.image import annotate, load_image, save_image

    overrides = {k: v for k, v in {
        "canvas_size": args.canvas_size,
        "text_threshold": args.text_threshold,
        "link_threshold": args.link_threshold,
        "low_text": args.low_text,
        "box_mode": args.box_mode,
        "decode_mode": args.decode_mode,
        "beam_size": args.beam_size,
        "channel_mode": args.channel_mode,
        "encoder_impl": args.encoder_impl,
        "decode_impl": args.decode_impl,
        "quantized_serving": True if args.quantized else None,
    }.items() if v is not None}
    if args.charset:
        from tuatara_tpu_torch.tokenizer import EXTENDED_CHARSET, STANDARD_CHARSET

        if args.charset == "extended":
            overrides["charset"] = EXTENDED_CHARSET
        elif args.charset == "standard":
            overrides["charset"] = STANDARD_CHARSET
        else:
            overrides["reference_charset"] = True
    if args.latency:
        config = OcrConfig.latency(**overrides)
    else:
        config = dataclasses.replace(DEFAULT_CONFIG, **overrides)

    image = load_image(args.image)
    engine = get_engine(config, args.weights_dir, args.device)
    if args.calibrate:
        engine.calibrate(image[None])
        print(f"calibration -> {engine.save_calibration()}", file=sys.stderr)
    t0 = time.perf_counter()
    results = engine.run(image, args.outputs_dir)
    if args.eval:
        # The words are scored; grouping below is for display.
        from tuatara_tpu_torch.utils.metrics import evaluate_page

        with open(args.eval) as f:
            truth = json.load(f)
        if isinstance(truth, dict) and "form" in truth:
            from tuatara_tpu_torch.utils.data import load_funsd_annotations

            truth = load_funsd_annotations(args.eval)
        scores = evaluate_page(results, truth)
        print("eval: " + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                     for k, v in scores.items()}), file=sys.stderr)
    if args.lines or args.blocks:
        from tuatara_tpu_torch.ops.grouping import group_blocks, group_lines

        results = group_lines(results)
        if args.blocks:
            results = group_blocks(results)
    elapsed = time.perf_counter() - t0

    for r in results:
        print(json.dumps(r))
    print(f"Elapsed time: {elapsed:.3f} seconds ({len(results)} boxes)", file=sys.stderr)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    if args.annotate:
        save_image(args.annotate, annotate(image, results))
        print(f"annotated render -> {args.annotate}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
