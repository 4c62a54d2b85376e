#!/usr/bin/env python3
"""Counts the machine instructions of the PyTorch port's CUDA kernels, by
opcode, from the SASS of a source under `tuatara_tpu_torch/csrc/` built as
the port builds it (`kernels/_build.py`), on a machine with the CUDA
toolkit (nvcc and cuobjdump).

For each kernel whose mangled name matches `--match`, prints one JSON line
("sass {...}"): its name, its instruction count and its opcodes (the
opcode's first word, e.g. FFMA, MUFU.EX2, F2F.BF16.F32, kept whole); with
`--per N`, each count divided by N too (the elements one pass of a
kernel's unrolled loop handles, to read instructions an element). An
operation bound follows from those counts and the card's peak rates, as
PERF.md states it for the GELU mode of BA:

    python3 scripts/sass_torch_port.py --source bias_act \
        --match 'bias_act_rowsI13__nv_bfloat16iLi1E' --per 32
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def histogram(sass: str, match: str):
    """{kernel name: Counter of opcodes} of the kernels in `sass` (the text
    cuobjdump -sass prints) whose name matches the regex `match`."""
    out = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if re.search(match, m.group(1)) else None
            if name:
                out[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if m and name:
            out[name][m.group(2)] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True, help="csrc/<source>.cu")
    ap.add_argument("--match", default=".", help="regex on the mangled kernel name")
    ap.add_argument("--per", type=float, default=0.0)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from tuatara_tpu_torch.kernels import _build

    _build.build_all([args.source])
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build._target(args.source)], capture_output=True,
                          text=True, check=True).stdout
    for name, ops in histogram(sass, args.match).items():
        line = {"kernel": name, "instructions": sum(ops.values()), "opcodes": dict(ops.most_common())}
        if args.per:
            line["per"] = args.per
            line["instructions_per"] = sum(ops.values()) / args.per
            line["opcodes_per"] = {k: v / args.per for k, v in ops.most_common()}
        print("sass " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
