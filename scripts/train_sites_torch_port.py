#!/usr/bin/env python3
"""Phase 7's bf16 training parity on one CUDA card for each form of
`TrainableCraft`'s sums (ROADMAP Queue 3 item 19b): two joint steps at full
width from `evals/production_weights` against JAX's record
(`chip_smoke.check_train_parity`, its bounds as they are) and the CRAFT
loss's gradient before AdamW against JAX's record
(`chip_smoke.check_craft_grads`: each leaf's estimated relative L2 error,
median, mean and worst; not gated here), with the sums in the forms before
any followed JAX's graph (`FUSED_SITES` of `tests/probe_torch_bf16.py`),
each site alone in JAX's form (`JAX_SITES`), the forms the port takes
(`SHIPPED_SITES`) and all in JAX's, each set by the probe's `site_forms`.
Each configuration runs `--reps` times, so that a run-to-run difference
(cuDNN's choice of backward algorithm, which need not be deterministic)
shows as two sets of values.

A site that the port does not yet take in JAX's form is a candidate when,
alone in JAX's form, its gradient's median error falls below the forms
before's in every run and phase 7's bounds hold in every run; the
candidates together on top of the shipped forms run last ("candidate").
Prints chip_smoke's "train parity bf16" lines under a "sites: NAME" line,
then one JSON line ("train_sites {...}": by configuration and run, the
values out of bounds and the gradient measure; the candidates).

    python3 scripts/train_sites_torch_port.py [--reps N]
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_sites_torch_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import chip_smoke
    from probe_torch_bf16 import JAX_SITES, SHIPPED_SITES, site_configs, site_forms
    from tuatara_tpu_torch.kernels._build import build_all

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; build: {build_all():.1f} s", flush=True)
    with np.load(chip_smoke.TRAIN_RECORD) as z:
        rec = {k: z[k] for k in z.files}
    with np.load(chip_smoke.TRAIN_CRAFT_GRADS) as z:
        grads_rec = {k: z[k] for k in z.files}
    out = {}

    def run(name, sites):
        with site_forms(sites):
            for rep in range(args.reps):
                print(f"sites: {name} (run {rep + 1})", flush=True)
                _, bad = chip_smoke.check_train_parity(rec, torch.bfloat16, "bf16")
                grads, _ = chip_smoke.check_craft_grads(rec, grads_rec, gate=False)
                out.setdefault(name, []).append({"out_of_bounds": bad, "grads": grads})

    for name, sites in site_configs():
        run(name, sites)
    base = out["fused (before)"]
    candidates = []
    for site, form in JAX_SITES.items():
        if SHIPPED_SITES[site] == form:
            continue
        runs = out[f"{site} -> {form}"]
        if all(not r["out_of_bounds"] and r["grads"]["median"] < b["grads"]["median"]
               for r, b in zip(runs, base)):
            candidates.append(site)
    if candidates:
        run("candidate", {**SHIPPED_SITES, **{s: JAX_SITES[s] for s in candidates}})
    print("train_sites " + json.dumps({"card": card, "candidates": candidates, "runs": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
