"""The plain reference against the program at fp32 on the CPU, at a small
page: CRAFT's score maps, the boxes, the crops, PARSeq's logits and the
page's words; and the reference's int8 convs against the program's under
production(), one layer at a time on one input (a whole int8 network
turns each input's roundings into other int8 values, layer after layer).
(This test may import both; the reference imports nothing of the
program.)"""

import json
import os

import numpy as np
import pytest
import torch

from reference import boxes as B
from reference.pipeline import Reference
from traffic import pages as P

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
WEIGHTS = os.path.join(ROOT, "evals", "production_weights")


def config(name):
    with open(os.path.join(BENCH, "configs", f"craft-parseq-s.{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def both():
    import tuatara_tpu_torch as T

    cfg = config("latency")
    ocr = T.OcrConfig(compute_dtype="float32", canvas_bucket=32)
    engine = T.OcrEngine(ocr, weights_dir=WEIGHTS, device="cpu")
    ref = Reference(WEIGHTS, cfg["ocr"], "cpu")
    with open(os.path.join(BENCH, "traffic", "page-mixed.json")) as f:
        mix = dict(json.load(f), page_sizes=[[160, 224]], pool_pages=2)
    pages = P.generate(ROOT, mix, 2**31 + 77)
    return engine, ref, pages, cfg


def test_craft_scores(both):
    from tuatara_tpu_torch.ops.resize import canvas_prep

    engine, ref, pages, _ = both
    page = pages[0]
    canvas = canvas_prep(torch.from_numpy(page), engine.config)[None]
    with torch.no_grad():
        got = engine.craft(canvas)[0]
    want = ref.craft.forward(ref.canvas(page, ref.geometry(page)))
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-3)


def test_boxes_crops_and_logits(both):
    from tuatara_tpu_torch.ops.boxes import extract_boxes
    from tuatara_tpu_torch.ops.warp import crop_rects, extract_crops_batched

    engine, ref, pages, cfg = both
    for page in pages:
        g = ref.geometry(page)
        scores = ref.craft.forward(ref.canvas(page, g))[0]
        mask = torch.zeros(scores.shape[:2], dtype=torch.bool)
        mask[:g["content"][0] // 2, :g["content"][1] // 2] = True
        det = extract_boxes(scores[..., 0], scores[..., 1], mask, engine.config)
        got = det["boxes"][det["valid"]].long().numpy()
        want = B.heatmap_boxes(scores[..., 0].numpy(), scores[..., 1].numpy(), g["content"],
                               cfg["ocr"])
        assert np.array_equal(got, want)
        bbox = B.report_box(B.scale(want, g["ratio"], cfg["ocr"]))
        assert np.array_equal(B.from_report_box(bbox, g["ratio"], cfg["ocr"]), want)
        scaled = torch.from_numpy(B.scale(want, g["ratio"], cfg["ocr"]))
        rects = crop_rects(scaled, *page.shape[:2])
        crops = extract_crops_batched(torch.from_numpy(page)[None],
                                      torch.zeros(len(rects), dtype=torch.long), rects)
        mine = ref.crops(page, bbox)
        assert torch.allclose(crops, mine, atol=1e-5)
        with torch.no_grad():
            logits = engine.parseq(crops)
        assert torch.allclose(logits[:, :, :], ref.parseq.recognize(mine), atol=2e-3)


def test_words(both):
    engine, ref, pages, _ = both
    for page in pages:
        got = engine.run(page)
        want = ref.read_page(page)
        assert [w["text"] for w in got] == [w["text"] for w in want]
        assert [w["bbox"] for w in got] == [w["bbox"] for w in want]
        assert np.allclose([w["confidence"] for w in got], [w["confidence"] for w in want],
                           atol=1e-4)


@pytest.fixture(scope="module")
def int8_pair():
    import tuatara_tpu_torch as T

    cfg = config("production")
    ocr = T.OcrConfig.production(compute_dtype="float32")
    program = T.OcrEngine(ocr, weights_dir=WEIGHTS, device="cpu").craft
    int8 = Reference.of_config(WEIGHTS, cfg, "cpu").craft
    fp32 = Reference.of_config(WEIGHTS, dict(cfg, precision={"default": "bf16"}), "cpu").craft
    return program, int8, fp32


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("path,dilation,bn", [
    ("vgg/conv1_2/conv", 1, "vgg/conv1_2/bn"),
    ("vgg/conv3_1/conv", 1, "vgg/conv3_1/bn"),
    ("fc/fc6", 6, None),
    ("head/conv2", 1, None),
])
def test_int8_conv_scales(int8_pair, path, dilation, bn):
    program, int8, fp32 = int8_pair
    mod = program
    for part in path.split("/"):
        mod = getattr(mod, part)
    x = torch.relu(torch.randn(2, mod.cin, 20, 24, generator=torch.Generator().manual_seed(3)))
    with torch.no_grad():
        got = mod(x).float()
        want, plain = (r.conv(x, path, dilation) for r in (int8, fp32))
        if bn:
            want, plain = int8.bn(want, bn), fp32.bn(plain, bn)
    assert rel(got, want) < 1e-3 and 5 * rel(got, want) < rel(got, plain)


def test_int8_decoder_level_splits_the_concat(int8_pair):
    program, int8, fp32 = int8_pair
    blk = program.up["upconv2"]
    g = torch.Generator().manual_seed(4)
    y = torch.relu(torch.randn(2, blk["conv1a"].cin, 12, 16, generator=g))
    skip = torch.randn(2, blk["conv1b"].cin, 12, 16, generator=g)
    with torch.no_grad():
        got = (blk["conv1a"](y) + blk["conv1b"](skip)).float()
        want, plain = (r.bn(r.conv1(y, skip, "up/upconv2/conv1"), "up/upconv2/bn1")
                       for r in (int8, fp32))
    assert rel(got, want) < 1e-3 and 5 * rel(got, want) < rel(got, plain)


def test_int8_maps_span_the_program_batch():
    from benchlib import check

    cfg = config("production")
    with open(os.path.join(BENCH, "traffic", "stream-dense.json")) as f:
        mix = dict(json.load(f), page_sizes=[[160, 224]], pool_pages=4)
    pool = P.generate(ROOT, mix, 2**31 + 78)
    int8 = Reference.of_config(WEIGHTS, cfg, "cpu")
    assert int8.craft.batch_wide
    got = check.reference_maps(int8, pool, [3, 1], 2)
    assert torch.equal(got[0], int8.scores_batch(pool[2:4])[1])
    assert torch.equal(got[1], int8.scores_batch(pool[0:2])[1])
    assert not torch.equal(got[1], int8.scores(pool[1]))
