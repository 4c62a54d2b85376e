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

With `--root DIR` the source is that tree's (a parent commit unpacked
into a directory that .gitignore lists), built into its own build/.
`--loop` counts only the instructions between the kernel's widest backward
branch and its target, the body of its largest loop (for
`gelu_grad_kernel`, the grid-stride loop over groups), as a second
"loop_" set of counts; `--exclude FMUL.FTZ,LDG.E.CONSTANT` leaves out the
loop's basic blocks that hold those opcodes (for `gelu_grad_kernel`, its
fp32 chain and its global-table reads: what is left is a regular bf16
group's path).
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


def loop_histogram(sass: str, match: str, exclude=()):
    """{kernel name: Counter of opcodes} of the instructions from the target
    of each matching kernel's widest backward branch (a BRA to a lower
    address) to that branch: the body of its largest loop. With
    `exclude` (opcodes), the loop's basic blocks (cut at every branch and
    branch target) that hold any of them are left out: the path through
    the loop that avoids them."""
    out = {}
    name, instrs = None, []

    def close():
        if name is None:
            return
        back = [(i, t) for i, (addr, op, t) in enumerate(instrs)
                if op.startswith("BRA") and t is not None and t < addr]
        counts = collections.Counter()
        if back:
            i, target = max(back, key=lambda b: instrs[b[0]][0] - b[1])
            body = [x for x in instrs[:i + 1] if x[0] >= target]
            starts = {t for _, _, t in body if t is not None}
            blocks, cur = [], []
            for addr, op, t in body:
                if addr in starts and cur:
                    blocks.append(cur)
                    cur = []
                cur.append(op)
                if op.startswith("BRA"):
                    blocks.append(cur)
                    cur = []
            blocks.append(cur)
            for block in blocks:
                if not any(op in exclude for op in block):
                    counts.update(block)
        out[name] = counts

    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name = m.group(1) if re.search(match, m.group(1)) else None
            instrs = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)(.*)", line)
        if m and name:
            t = re.search(r"BRA\S*\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", m.group(3) + m.group(4))
            instrs.append((int(m.group(1), 16), m.group(3), int(t.group(1), 16) if t else None))
    close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True, help="csrc/<source>.cu")
    ap.add_argument("--match", default=".", help="regex on the mangled kernel name")
    ap.add_argument("--per", type=float, default=0.0)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--exclude", default="", help="opcodes, comma-separated: with --loop, "
                    "leave out the loop's blocks that hold any")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from tuatara_tpu_torch.kernels import _build

    _build.build_all([args.source])
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build._target(args.source)], capture_output=True,
                          text=True, check=True).stdout
    exclude = tuple(op for op in args.exclude.split(",") if op)
    loops = loop_histogram(sass, args.match, exclude) if args.loop else {}
    for name, ops in histogram(sass, args.match).items():
        line = {"kernel": name, "source": _build._target(args.source),
                "instructions": sum(ops.values()), "opcodes": dict(ops.most_common())}
        sets = [("", ops)] + ([("loop_", loops[name])] if name in loops else [])
        for prefix, counts in sets:
            if prefix:
                line["loop_instructions"] = sum(counts.values())
                line["loop_opcodes"] = dict(counts.most_common())
            if args.per:
                line["per"] = args.per
                line[f"{prefix}instructions_per"] = sum(counts.values()) / args.per
                line[f"{prefix}opcodes_per"] = {k: v / args.per for k, v in counts.most_common()}
        print("sass " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
