#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/readings.py --workload <cell> --seconds <s>
        --seeds <n> ... [--control-seeds <n> ...]

For each seed: the cell's pool from that seed, warmed up, a window of
`--seconds` at the cell's load, and the numbers of `benchlib/check.py`
for a sample of what it served, as a run computes them. For each control
seed: each lower-precision control of the configuration (`controls`: the
reference with each layer in the format one step below the precision the
configuration states, or only some layers so) read on the same sample of
that seed's pages, in the program's place. The engine is built once.
Prints one line a reading and writes them all to
`build/readings/readings_<cell>.json` (or `--out`). The benchmark's runs do
not run this.
"""

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [ROOT, BENCH]

import run  # noqa: E402


def main(argv=None, device: str = "cuda", mix_override=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "readings"))
    args = ap.parse_args(argv)
    run.set_caches()
    import torch

    from benchlib import check
    from benchlib.spec import Spec
    from reference.pipeline import Reference
    from traffic.pages import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    limits = spec.limits(cell["name"])
    c = run.setup_cell(spec, cell, args.seeds[0], device, mix_override)
    per_batch = c.mix.get("pages_per_batch", 1)
    ref = Reference.of_config(c.weights, c.cfg, device)
    lows = [(ctl, Reference.of_config(c.weights, c.cfg, device, ctl))
            for ctl in c.cfg["controls"]]
    rows = []
    for seed in args.seeds:
        c.pool = generate(ROOT, c.mix, seed)
        c.driver.set_pool(c.pool)
        c.capture.n = len(c.pool)
        c.driver.warm()
        c.capture.start()
        w = c.driver.run(seconds=args.seconds)
        c.capture.on = False
        sampled = check.sample(w["results"], limits["sample_pages"], seed)
        picked = [i for i, _ in sampled]
        pages = [c.pool[i] for i in picked]
        wants = check.reference_maps(ref, c.pool, picked, per_batch)
        row = {"seed": seed, "who": "program", "pages": len(pages),
               "words": sum(len(r or ()) for _, r in sampled),
               **check.numbers(ref, pages, [r for _, r in sampled],
                               [c.capture.maps.get(i) for i in picked], wants),
               "repeats_differ": check.repeats_agree(w["results"]), "failed": w["failed"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if seed in args.control_seeds:
            for ctl, low in lows:
                maps = check.reference_maps(low, c.pool, picked, per_batch)
                served = [low.read_scores(p, m) for p, m in zip(pages, maps)]
                row = {"seed": seed, "who": "control", "control": ctl["name"],
                       "pages": len(pages), "words": sum(len(r) for r in served),
                       **check.numbers(ref, pages, served, maps, wants)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    mine = [r for r in rows if r["who"] == "program"]
    print("program, highest:", {k: max(r[k] for r in mine) for k in check.NUMBERS})
    for ctl, _ in lows:
        mine = [r for r in rows if r["who"] == "control" and r["control"] == ctl["name"]]
        if mine:
            print(f"control {ctl['name']}, lowest:",
                  {k: min(r[k] for r in mine) for k in check.NUMBERS})
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"readings_{cell['name']}.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
