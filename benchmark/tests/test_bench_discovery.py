"""A configuration, a mix, a metric and a cell added as files and entries
are found by name, with no file that is there edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def digests(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = digests(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "craft-parseq-s.latency.json").read_text())
    cfg["name"] = "craft-parseq-s.tiled"
    (b / "configs" / "craft-parseq-s.tiled.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "page-mixed.json").read_text())
    mix["page_sizes"] = [[2000, 1500]]
    (b / "traffic" / "page-large.json").write_text(json.dumps(mix))
    (b / "metrics" / "pages_total.py").write_text(
        '"""pages: the window\'s pages."""\n\n\ndef read(ctx):\n    return ctx.window["pages"]\n')
    (b / "limits" / "tiled.page-large.json").write_text(
        json.dumps({"sample_pages": 4, "limits": {"box_miss": 0.5}}))
    bench["configs"].append({"name": "craft-parseq-s.tiled", "source": "x",
                             "file": "benchmark/configs/craft-parseq-s.tiled.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiled.page-large", "config": "craft-parseq-s.tiled",
                               "traffic": "page-large", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "pages_total", "unit": "pages", "better": "higher",
                               "source": "host_clock", "layer": "x", "moves": "page_ms",
                               "workloads": ["tiled.page-large"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = """
import sys, types
sys.path[:0] = [%r]
from benchlib.spec import Spec, reader
s = Spec(%r)
cell = s.cell("tiled.page-large")
assert s.config(cell["config"])["name"] == "craft-parseq-s.tiled"
assert s.mix(cell["traffic"])["page_sizes"] == [[2000, 1500]]
assert s.limits(cell["name"])["sample_pages"] == 4
names = [m["name"] for m in s.metrics(cell["name"], True)]
assert names == ["pages_total"], names
assert [m["name"] for m in s.metrics(cell["name"], False)] == ["setup_s"]
ctx = types.SimpleNamespace(window={"pages": 7})
assert reader("pages_total")(ctx) == 7
print("ok")
""" % (str(b), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr
    after = digests(b)
    assert all(after[k] == v for k, v in before.items())  # nothing there was edited
