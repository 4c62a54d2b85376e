"""Run a function on several ranks of a CPU process group, for the port's
multi-rank tests (no JAX here, so the ranks start fast).

`run_ranks("module:function", world, workdir, *args)` starts `world`
processes (multiprocessing's spawn), each of which joins a gloo group
through a `file://` rendezvous under `workdir`, caps torch at one thread,
calls `module.function(rank, world, *args)` and pickles its return value.
-> the values in rank order. A rank that raises, exits nonzero or outlasts
`timeout` seconds fails the call with its traceback; the other ranks are
then killed.
"""

import importlib
import multiprocessing as mp
import os
import pickle
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _entry(target, rank, world, workdir, args):
    out = os.path.join(workdir, f"rank{rank}.pkl")
    try:
        for p in (ROOT, HERE):
            if p not in sys.path:
                sys.path.insert(0, p)
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                                rank=rank, world_size=world)
        mod, fn = target.split(":")
        value = getattr(importlib.import_module(mod), fn)(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(("ok", value), f)
    except BaseException:  # noqa: BLE001 - reported to the parent
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        sys.exit(1)


def run_ranks(target: str, world: int, workdir, *args, timeout: float = 240.0):
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world, workdir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    values, errors = [], []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{r}.pkl")
        if not os.path.isfile(path):
            errors.append(f"rank {r}: exit code {p.exitcode}, no result (timeout {timeout} s?)")
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            errors.append(f"rank {r}:\n{value}")
        values.append(value)
    if errors:
        raise AssertionError("\n".join(errors))
    return values
