"""A run whose timed path is broken underneath comes out not correct, on
the CPU at a small size (the run's look for a card skipped): a token
altered where it is produced, and half of each batch's pages left out.
Each fault must lift its number past the cell's limit and past the clean
run's reading. So must a window whose CRAFT maps the run could not keep
(CRAFT reached by another route than the attribute the run wraps)."""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"page_sizes": [[320, 448]], "pool_pages": 4, "pages_per_batch": 2,
         "trace_batches": 1, "trace_pages": 2}


def run_cell(cell, capsys, seed=2**31 + 1001):
    import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "3", "--trace", "0"],
                  device="cpu", mix_override=SMALL)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def alter_tokens(monkeypatch):
    from tuatara_tpu_torch.tokenizer import STANDARD_CHARSET, Tokenizer

    decode = Tokenizer.decode_ids

    def altered(self, ids, *a, **kw):
        out = []
        for t in decode(self, ids, *a, **kw):
            c = STANDARD_CHARSET[(STANDARD_CHARSET.index(t[0]) + 47) % 94] if t else "x"
            out.append(c + t[1:])
        return out

    monkeypatch.setattr(Tokenizer, "decode_ids", altered)


def drop_half(monkeypatch):
    from tuatara_tpu_torch.api import OcrEngine

    finalize = OcrEngine._finalize

    def half(self, st):
        res = finalize(self, st)
        return res[:len(res) // 2] + [[] for _ in res[len(res) // 2:]]

    monkeypatch.setattr(OcrEngine, "_finalize", half)


@pytest.mark.parametrize("cell,fault,number", [
    ("production.stream-dense", alter_tokens, "read_miss"),
    ("production.stream-dense", drop_half, "box_miss"),
    ("latency.page-mixed", alter_tokens, "read_miss"),
])
def test_fault_is_not_correct(cell, fault, number, monkeypatch, capsys):
    sys.path[:0] = [BENCH]
    clean = run_cell(cell, capsys)
    with monkeypatch.context() as m:
        fault(m)
        broken = run_cell(cell, capsys)
    assert broken["correct"] is False
    got = broken["checks"][number]
    assert got["value"] > max(got["limit"], clean["checks"][number]["value"])


def test_maps_not_kept_is_not_correct(monkeypatch, capsys):
    sys.path[:0] = [BENCH]
    import run

    monkeypatch.setattr(run.Capture, "add", lambda self, scores: None)
    broken = run_cell("latency.page-mixed", capsys)
    assert broken["correct"] is False
    assert broken["checks"]["score_err"]["value"] == "inf"
