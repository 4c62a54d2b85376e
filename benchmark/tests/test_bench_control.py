"""On the card: each lower-precision control of a cell's configuration
(`controls`: the reference with each layer, or the recognizer's alone, one
format below the precision the configuration states) put in the program's
place fails the cell's limits, on three seeds, at the cell's own sizes
with a short window."""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]
SEEDS = [str(2**31 + 501), str(2**31 + 502), str(2**31 + 503)]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell, card, tmp_path):
    sys.path[:0] = [BENCH]
    import readings
    from benchlib import check
    from benchlib.spec import Spec

    assert readings.main(["--workload", cell, "--seconds", "2", "--seeds", *SEEDS,
                          "--control-seeds", *SEEDS, "--out", str(tmp_path)]) == 0
    with open(tmp_path / f"readings_{cell}.json") as f:
        rows = [r for r in json.load(f) if r["who"] == "control"]
    spec = Spec(ROOT)
    limits = spec.limits(cell)["limits"]
    assert len(rows) == 3 * len(spec.config(spec.cell(cell)["config"])["controls"])
    for r in rows:
        ok, _ = check.judge(r, limits)
        assert not ok, r
