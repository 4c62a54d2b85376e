"""The port's user-facing surface on the CPU against the JAX package: line
and block grouping (`ops/grouping.py`, `OcrEngine.run_lines` /
`run_blocks`), the metrics (`utils/metrics.py`), the FUNSD reader and PNG
writer, and the command line (`python -m tuatara_tpu_torch`, run in
process with `--device cpu`).

* `group_lines` and `group_blocks` equal JAX's on seeded word lists and on
  the golden pages' recorded words (tests/fixtures/torch_engine_golden.json);
* every metric equals JAX's on seeded pairs and boxes, `evaluate_engine`
  over the same results;
* `load_funsd_annotations` equals JAX's on a FUNSD-style file built here;
* the command line's `--json-out` equals the engine's `run`; `--lines`,
  `--blocks` and `--eval` print what JAX's grouping and `evaluate_page`
  give on the same words; its flag checks refuse as JAX's do.
"""

import json
import os

import numpy as np
import pytest

from tuatara_tpu.ops import grouping as jgrouping
from tuatara_tpu.utils import data as jdata
from tuatara_tpu.utils import metrics as jmetrics
import tuatara_tpu_torch
from tuatara_tpu_torch import cli
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.ops import grouping
from tuatara_tpu_torch.utils import data, metrics
from tuatara_tpu_torch.utils.image import annotate, load_image, save_image

from torch_common import GOLDEN, ROOT, image, torch_threads  # noqa: F401

PAGE = "resume_example"
ENGINE_RECORD = os.path.join(ROOT, "tests", "fixtures", "torch_engine_golden.json")


def seeded_words(seed, n=40):
    """Words on a few jittered lines and two columns, seeded."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        line, col = int(rng.integers(0, 8)), int(rng.integers(0, 2))
        x0 = col * 300 + float(rng.uniform(0, 220))
        y0 = line * 30 + float(rng.uniform(-4, 4))
        w, h = float(rng.uniform(10, 70)), float(rng.uniform(10, 22))
        out.append({"text": "".join(rng.choice(list("abcdeXYZ"), int(rng.integers(1, 6)))),
                    "bbox": [x0, y0, x0 + w, y0 + h],
                    "confidence": float(rng.uniform(0.01, 1.0))})
    return out


def recorded_pages():
    with open(ENGINE_RECORD) as f:
        return json.load(f)["default"]


@pytest.mark.parametrize("seed", range(6))
def test_grouping_matches_jax_seeded(seed):
    words = seeded_words(seed)
    lines = grouping.group_lines(words)
    assert lines == jgrouping.group_lines(words)
    assert grouping.group_blocks(lines) == jgrouping.group_blocks(jgrouping.group_lines(words))
    for kw in ({"min_vertical_overlap": 0.7, "max_gap_ratio": 0.5},):
        assert grouping.group_lines(words, **kw) == jgrouping.group_lines(words, **kw)
    kw = {"max_line_gap_ratio": 2.0, "min_horizontal_overlap": 0.1}
    assert grouping.group_blocks(lines, **kw) == jgrouping.group_blocks(lines, **kw)


@pytest.mark.parametrize("name", sorted(recorded_pages()))
def test_grouping_matches_jax_on_pages(name):
    words = recorded_pages()[name]
    lines = grouping.group_lines(words)
    assert lines and lines == jgrouping.group_lines(words)
    assert grouping.group_blocks(lines) == jgrouping.group_blocks(lines)


def seeded_pairs(seed, n=60):
    rng = np.random.default_rng(seed)
    alphabet = list("abcAB1 ")

    def word():
        return "".join(rng.choice(alphabet, int(rng.integers(0, 7))))

    pairs = []
    for _ in range(n):
        t = word()
        p = t if rng.random() < 0.4 else word()
        pairs.append((p, t))
    return pairs


@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_jax(seed):
    pairs = seeded_pairs(seed)
    for p, t in pairs:
        assert metrics.edit_distance(p, t) == jmetrics.edit_distance(p, t)
    assert metrics.char_error_rate(pairs) == jmetrics.char_error_rate(pairs)
    assert metrics.pair_accuracy(pairs) == jmetrics.word_accuracy(pairs)
    assert metrics.pair_accuracy([]) == jmetrics.word_accuracy([])
    truth = seeded_words(seed + 10, 30)
    rng = np.random.default_rng(seed)
    pred = [{**w, "bbox": [v + float(rng.normal(0, 4)) for v in w["bbox"]],
             "text": w["text"] if rng.random() < 0.7 else w["text"][::-1]}
            for w in truth if rng.random() < 0.8]
    pred += seeded_words(seed + 20, 5)
    pb, tb = [w["bbox"] for w in pred], [w["bbox"] for w in truth]
    for a in pb[:10]:
        for b in tb[:10]:
            assert metrics.box_iou(a, b) == jmetrics.box_iou(a, b)
    for thr in (0.3, 0.5, 0.7):
        assert metrics.match_boxes(pb, tb, thr) == jmetrics.match_boxes(pb, tb, thr)
        assert metrics.detection_prf(pb, tb, thr) == jmetrics.detection_prf(pb, tb, thr)
        for cs in (True, False):
            assert (metrics.evaluate_page(pred, truth, thr, cs)
                    == jmetrics.evaluate_page(pred, truth, thr, cs))
    for empty in (([], []), ([], tb), (pb, [])):
        assert metrics.detection_prf(*empty) == jmetrics.detection_prf(*empty)

    class Recorded:
        """An engine whose run_mixed returns fixed results."""

        def __init__(self, results):
            self.results = results

        def run_mixed(self, images):
            return self.results[:len(images)]

    pages, truths = [pred, truth, []], [truth, truth, seeded_words(seed, 3)]
    got = metrics.evaluate_engine(Recorded(pages), [0, 1, 2], truths)
    assert got == jmetrics.evaluate_engine(Recorded(pages), [0, 1, 2], truths)
    with pytest.raises(ValueError):
        metrics.evaluate_engine(Recorded(pages), [0], truths)


def funsd_file(path, words):
    """A FUNSD-style annotation of `words`: two words a field, and an empty
    field (a checkbox) that the reader drops."""
    form = [{"text": " ".join(w["text"] for w in words[i:i + 2]),
             "box": [int(v) for v in words[i]["bbox"]],
             "words": [{"text": w["text"], "box": [int(v) for v in w["bbox"]]}
                       for w in words[i:i + 2]]}
            for i in range(0, len(words), 2)]
    form.append({"text": "", "box": [0, 0, 1, 1], "words": [{"text": " ", "box": [0, 0, 1, 1]}]})
    with open(path, "w") as f:
        json.dump({"form": form}, f)
    return path


def test_funsd_annotations_match_jax(tmp_path):
    path = funsd_file(str(tmp_path / "truth.json"), seeded_words(3, 9))
    for level in ("word", "entity"):
        got = data.load_funsd_annotations(path, level)
        assert got and got == jdata.load_funsd_annotations(path, level)
    with pytest.raises(ValueError):
        data.load_funsd_annotations(path, "line")


def test_png_writer_and_annotate(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((17, 23, 3), (9, 31)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / "x.png")
        save_image(path, img)
        np.testing.assert_array_equal(load_image(path, keep_gray=img.ndim == 2), img)
    page = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    out = annotate(page, seeded_words(1, 5))
    assert out.shape == (60, 240, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(annotate(page, [])[:, :80], page)


@pytest.fixture(scope="module")
def engine():
    return tuatara_tpu_torch.api.get_engine(OcrConfig(), GOLDEN, "cpu")


def run_cli(capsys, *args):
    assert cli.main([os.path.join(ROOT, "images", f"{PAGE}.png"), GOLDEN, *args,
                     "--device", "cpu"]) == 0
    out = capsys.readouterr()
    return [json.loads(line) for line in out.out.splitlines()], out.err


def test_cli_json_out_equals_run(engine, capsys, tmp_path):
    path = str(tmp_path / "out.json")
    printed, err = run_cli(capsys, "--json-out", path)
    want = engine.run(image(PAGE))
    assert want and printed == want
    with open(path) as f:
        assert json.load(f) == want
    assert f"({len(want)} boxes)" in err


def test_cli_lines_blocks_eval(engine, capsys, tmp_path):
    """--lines, --blocks and --eval give what JAX's grouping and metrics
    give on the engine's words; run_lines / run_blocks agree."""
    words = engine.run(image(PAGE))
    lines, _ = run_cli(capsys, "--lines")
    assert lines == jgrouping.group_lines(words) == engine.run_lines(image(PAGE))
    blocks, _ = run_cli(capsys, "--blocks")
    assert blocks == jgrouping.group_blocks(jgrouping.group_lines(words))
    assert blocks == engine.run_blocks(image(PAGE))
    truth = funsd_file(str(tmp_path / "funsd.json"), words[::2])
    _, err = run_cli(capsys, "--eval", truth)
    scores = jmetrics.evaluate_page(words, jdata.load_funsd_annotations(truth))
    want = {k: round(v, 4) if isinstance(v, float) else v for k, v in scores.items()}
    assert json.loads(err.split("eval: ")[1].splitlines()[0]) == want
    assert want["recall"] == 1.0 and want["precision"] < 1.0
    plain = str(tmp_path / "plain.json")
    with open(plain, "w") as f:
        json.dump([{"text": w["text"], "bbox": w["bbox"]} for w in words[:5]], f)
    _, err = run_cli(capsys, "--eval", plain)
    assert json.loads(err.split("eval: ")[1].splitlines()[0])["precision"] == round(5 / len(words), 4)
    render = str(tmp_path / "render.png")
    run_cli(capsys, "--annotate", render)
    assert load_image(render).shape == (image(PAGE).shape[0], 3 * image(PAGE).shape[1], 3)


def test_cli_flags_and_refusals(capsys):
    """JAX's flags parse; --calibrate without --quantized is refused by the
    parser; a missing weights directory is not (random weights, as in JAX):
    the command goes on to read the image."""
    args = cli.build_parser().parse_args(
        ["p.png", "w", "o", "--latency", "--quantized", "--decode-mode", "beam", "--beam-size",
         "2", "--encoder-impl", "xla", "--decode-impl", "pallas", "--box-mode", "rotated",
         "--channel-mode", "cpp", "--charset", "extended", "--canvas-size", "512",
         "--text-threshold", "0.5", "--link-threshold", "0.3", "--low-text", "0.3", "-v"])
    assert (args.decode_mode, args.beam_size, args.encoder_impl, args.device) == \
        ("beam", 2, "xla", None)
    with pytest.raises(SystemExit):
        cli.main(["p.png", "w", "--calibrate"])
    assert cli.build_parser().parse_args(["p.png"]).weights_dir is None
    with pytest.raises(FileNotFoundError, match="p.png"):
        cli.main(["p.png", "--device", "cpu"])
    capsys.readouterr()
