"""Where the port and JAX part at one compute dtype, on the CPU: CRAFT's
heatmaps of a page through both engines, the pixels whose side of each
threshold (text_threshold and low_text on the text map, link_threshold on
the link map) differs, and the records whose text or bbox differs, under
`OcrConfig()`, the `latency()` and `production()` presets as JAX runs them
off a TPU (XLA's eager encoder and scan decode, exact GELU), or those
presets with JAX's Pallas recognizer kernels forced, the algorithm they
serve on a TPU (`pallas_reference`: the fused ViT kernel in interpret
mode, the fused decode by the JAX tests' eager transcription of its
kernel, `_simulate_kernel`, since compiled by XLA's CPU backend the
interpret mode drops the kernel's bf16 rounding of the attention products).

`tests/test_torch_capi.py` and `tests/test_torch_bf16.py` hold the port to
JAX with `compare`; run this file to print what it measures (a 200x300
crop of `resume_example` on the golden weights: `OcrConfig()` at both
dtypes, then `latency()` and `production()`, both bf16, against JAX's
presets off a TPU and forced to Pallas; at the golden weights' width, 32,
JAX's gates and the port's run no Pallas kernel):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/probe_torch_bf16.py

More probes, each a word on the command line:

* `pages [PACKAGE_DIR] [--preset NAME[,NAME]] [--attribute]`: on the CPU,
  the port (or the `tuatara_tpu_torch` found under PACKAGE_DIR, e.g. a
  parent commit unpacked there) at `OcrConfig()` and `latency()` (or the
  presets named: `default`, `latency`, `latency_pallas`,
  `production_pallas`, each the port's preset against that record) with
  the full-width `evals/production_weights` on the four main-path pages,
  the share of JAX's bf16 records (tests/fixtures/torch_reference_bf16.json)
  with the same text and bbox, a page at a time. Full width, the fp32 sums' order
  decides bf16 roundings that grow through the layers, so this share is
  not 1. With `--attribute`, a line for each JAX record the port does not
  give: where the two first part (`first_parting`: heatmap pixels across
  a threshold near the box, or the first greedy step or refined position
  whose argmax differs, with both packages' logits), and under int8 CRAFT
  the first quantized layer whose dynamic scale differs from JAX's on that
  page, with both scales and abs-maxes (`first_scale_parting`); the
  preset's line then counts the missed records that part first at
  detection and at recognition.
* `residual`: a bf16 Linear whose output feeds an fp32 add (a residual,
  PARSEQ's `x + linear(h)`): the share of JAX's compiled values that each
  form gives (XLA drops the rounding of the bias add there), the port's
  `Linear(h, residual=x)` last.
* `hlo`: XLA's optimised HLO of what the JAX engine jits at bf16 on the
  golden weights (`_recognize_body` under greedy, NAR and beam, which
  holds `parseq_encode`'s eager blocks, the greedy decode, the refine and
  the confidence; `parseq_encode` of the int8 encoder; `craft_forward` on
  the canvases of `OcrConfig()` and `latency()`; on
  `evals/production_weights`, the greedy `_recognize_body` of the
  forced-Pallas `latency()` engine, `pallas_graph`) and of the training
  losses' gradients (`parseq_plm_loss`, `craft_loss`). Every `linear`,
  `linear_q` and `conv2d` call is traced inside a named scope that holds
  its JAX call site; each bias add is followed through the graph (fusions,
  loops, tuples) to its consumers, and printed with the op's name, the
  port's counterpart by file:line where `PORT_SITES` lists it (every site
  whose sum is not rounded, and the rounded ones next to K7):
  "rounded" where a convert to bf16 comes first, or "UNROUNDED" and the
  fp32 op its sum reaches. CRAFT's decoder sum `ya + yb` is followed the
  same way (`bias_scopes`); `CRAFT_TRAIN_SITES` names CRAFT's training
  sites as `models/craft._train_conv` does. Then the int8 graph
  (`int8_sites`): JAX's int8 `craft_forward` at bf16 as the forced-Pallas
  `production()` engine jits it, on the golden weights and on
  `evals/production_weights`; each layer's dequant, each decoder sum and
  each float conv's bias add followed past its bf16 rounding to every op
  that reads it (the next abs-max and x * xs, the sum, the upsample, the
  head's convs), "rounded" or "UNROUNDED", and the opcode of each scale
  division (127 / amax, sw / xs). Last the GELU's backward inside the
  gradient of the JAX package's bf16 `mlp` (`gelu_vjp_form`): the
  expression XLA's graph computes for the gradient at the GELU's input,
  read from the optimised HLO, with every rounding to bf16 written T(.),
  beside the form the port computes (`GELU_GRAD_FORM`,
  `kernels/bias_act.gelu_plain_grad` and the `gelu_grad` kernel).
* `craft_grads [tiny|full]`: the CRAFT loss's gradient at bf16 before the
  optimizer, the port's against JAX's leaf by leaf, with each of
  `TrainableCraft`'s sums alone in JAX's form and with the forms the port
  takes (ROADMAP Queue 3 item 19; `craft_grads`).
* `resample`: table_english's shrinking, antialiased canvas resample at
  fp32 (ROADMAP Queue 3 item 6): `F.interpolate` against JAX's
  `jax.image.resize`, and the two-contraction form (JAX's weight matrix
  per axis, each output's taps fused in index order) beside it.
"""

import contextlib
import dataclasses
import json
import os
import re
import sys
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def simulated_decode(mem_k, mem_v, stacked, heads, t, n_classes, bos_id, eps=1e-6, tb=32,
                     interpret=False, early_exit=True):
    """`greedy_decode_pallas`'s result computed by the JAX tests'
    transcription of its kernel, `_simulate_kernel`
    (tests/test_pallas_decode.py), eagerly on the host through
    `jax.pure_callback`: a tile of `tb` crops at a time, and with
    `early_exit` the kernel's tile early exit (the positions after the step
    at which every crop of the tile has emitted EOS hold the EOS-certain
    logits, +30 at id 0, -30 elsewhere). Eagerly, because each bf16 product
    of the kernel's attention is then rounded, as on the TPU; compiled by
    XLA's CPU backend, in interpret mode too, the rounding is dropped.
    `interpret` is taken and ignored."""
    import types

    import jax
    import jax.numpy as jnp

    from test_pallas_decode import _simulate_kernel

    n, _, d = mem_k.shape
    cfg = types.SimpleNamespace(embed_dim=d, dec_heads=heads, charset_size=n_classes - 1,
                                layer_norm_eps=eps, num_tokens=bos_id + 2)

    def host(mk, mv, st):
        st = {k: jnp.asarray(v) for k, v in st.items()}
        out = np.empty((n, t, n_classes), np.float32)
        for t0 in range(0, n, tb):
            lg = np.array(_simulate_kernel(st, jnp.asarray(mk[t0:t0 + tb]),
                                           jnp.asarray(mv[t0:t0 + tb]), cfg, t))
            ended = (np.cumsum(lg.argmax(-1) == 0, axis=1) > 0).all(0)
            if early_exit and ended.any():
                stop = int(np.argmax(ended))
                lg[:, stop + 1:] = -30.0
                lg[:, stop + 1:, 0] = 30.0
            out[t0:t0 + tb] = lg
        return out

    return jax.pure_callback(host, jax.ShapeDtypeStruct((n, t, n_classes), jnp.float32),
                             mem_k, mem_v, stacked)


def pallas_reference():
    """The JAX package's Pallas recognizer kernels as the forced-Pallas
    references run them on the CPU: K6's `vit_blocks_pallas` in interpret
    mode, K7's `greedy_decode_pallas` by `simulated_decode` (module
    attributes wrapped; the package is not edited). Idempotent."""
    import tuatara_tpu.ops.pallas.decode as pallas_decode
    import tuatara_tpu.ops.pallas.vit as pallas_vit

    pallas_decode.greedy_decode_pallas = simulated_decode
    vit = pallas_vit.vit_blocks_pallas
    if not getattr(vit, "interpreted", False):
        def call(*args, **kwargs):
            kwargs["interpret"] = True
            return vit(*args, **kwargs)
        call.interpreted = True
        pallas_vit.vit_blocks_pallas = call


# Preset -> (the OcrConfig factory, JAX's and the port's; the overrides of
# JAX's): the forced-Pallas presets run the JAX package's Pallas recognizer
# kernels off a TPU (`pallas_reference`), where JAX's `latency()` and
# `production()` run XLA's eager encoder and scan decode.
PALLAS = {"encoder_impl": "pallas", "decode_impl": "pallas"}
PRESETS = {"latency": ("latency", {}), "production": ("production", {}),
           "latency_pallas": ("latency", PALLAS), "production_pallas": ("production", PALLAS)}


def jax_recognize(params, crops, pcfg):
    """JAX's `OcrEngine._recognize_body` (greedy, bf16, the confidence
    included) with its recognizer's Pallas kernels forced
    (`encoder_impl`/`decode_impl` "pallas" on `pcfg`, run by
    `pallas_reference`), jitted, on a parameter tree and crops -> (ids
    [N, T], conf [N]) as numpy fp32."""
    import dataclasses
    import types

    import jax
    import jax.numpy as jnp

    from tuatara_tpu.api import OcrEngine as JaxEngine
    from tuatara_tpu.config import OcrConfig as JaxConfig

    pallas_reference()
    eng = types.SimpleNamespace(parseq_config=dataclasses.replace(pcfg, **PALLAS),
                                config=JaxConfig(), mesh=None)
    ids, conf = jax.jit(lambda p, x: JaxEngine._recognize_body(eng, p, x))(params, crops)
    return np.asarray(ids), np.asarray(conf.astype(jnp.float32))


def jax_config(preset):
    """JAX's OcrConfig of a preset name (`PRESETS`, or "default" for
    `OcrConfig()`); installs `pallas_reference` for the forced-Pallas ones
    (off a TPU the others call no Pallas kernel)."""
    from tuatara_tpu.config import OcrConfig as JaxConfig

    if preset == "default":
        return JaxConfig()
    factory, overrides = PRESETS[preset]
    if overrides:
        pallas_reference()
    return getattr(JaxConfig, factory)(**overrides)


def compare(page, weights_dir, dtype, preset="default"):
    """-> {"max_abs": {"text", "link"}, "mean_abs", "flips": {name: (threshold,
    [[y, x], ...])}, "records": (JAX's, the port's), "same": records equal
    in text and bbox}. `preset`: "default" (`OcrConfig(compute_dtype=dtype)`)
    or a name of `PRESETS` (the preset, at its own bf16)."""
    import jax
    import jax.numpy as jnp

    import tuatara_tpu_torch
    from tuatara_tpu.api import OcrEngine as JaxEngine, _canvas_prep
    from tuatara_tpu.config import OcrConfig as JaxConfig
    from tuatara_tpu.models.craft import craft_forward
    from tuatara_tpu_torch.config import OcrConfig

    if preset == "default":
        jcfg, config = JaxConfig(compute_dtype=dtype), OcrConfig(compute_dtype=dtype)
    else:
        jcfg, config = jax_config(preset), getattr(OcrConfig, PRESETS[preset][0])()
        assert jcfg.compute_dtype == config.compute_dtype == dtype
    jax_engine = JaxEngine(jcfg, weights_dir=weights_dir)
    engine = tuatara_tpu_torch.OcrEngine(config, weights_dir=weights_dir, device="cpu")
    cfg = jax_engine.config
    canvases = jax.vmap(lambda im: _canvas_prep(im, cfg))(jnp.asarray(page[None]))
    want, _ = craft_forward(jax_engine.craft_params, canvases, jax_engine.craft_config,
                            compute_dtype=jnp.dtype(dtype))
    want = np.asarray(want.astype(jnp.float32))[0]
    got = engine.detect(torch.from_numpy(page[None]))["scores"].float().numpy()[0]
    diff = np.abs(want - got)
    flips = {}
    for name, ch, thr in (("text_threshold", 0, cfg.text_threshold),
                          ("low_text", 0, cfg.low_text),
                          ("link_threshold", 1, cfg.link_threshold)):
        flips[name] = (thr, np.argwhere((want[..., ch] > thr) != (got[..., ch] > thr)).tolist())
    records = jax_engine.run(page), engine.run(page)
    same = sum((a["text"], a["bbox"]) == (b["text"], b["bbox"]) for a, b in zip(*records))
    return {"max_abs": {"text": float(diff[..., 0].max()), "link": float(diff[..., 1].max())},
            "mean_abs": float(diff.mean()), "flips": flips, "records": records, "same": same}


def main():
    sys.path.insert(0, HERE)
    from torch_common import GOLDEN, image

    page = image("resume_example")[:200, :300].copy()
    for preset, dtype in (("default", "float32"), ("default", "bfloat16"),
                          ("latency", "bfloat16"), ("production", "bfloat16"),
                          ("latency_pallas", "bfloat16"), ("production_pallas", "bfloat16")):
        r = compare(page, GOLDEN, dtype, preset)
        print(f"{preset} {dtype}: heatmap max |JAX - port| text {r['max_abs']['text']} link "
              f"{r['max_abs']['link']}, mean {r['mean_abs']}")
        for name, (thr, px) in r["flips"].items():
            print(f"  {name} {thr}: {len(px)} pixels on the other side, first {px[:4]}")
        jax_rec, port_rec = r["records"]
        print(f"  records: {r['same']} of {len(port_rec)} equal (JAX {len(jax_rec)})")
        for a, b in zip(jax_rec, port_rec):
            if (a["text"], a["bbox"]) != (b["text"], b["bbox"]):
                print(f"    JAX {a['text']!r} {a['bbox']}  port {b['text']!r} {b['bbox']}")


def pages_share(package=None, attribute=False, presets=("default", "latency")):
    """The `pages` probe (see the module docstring) over `presets` (record
    names of tests/fixtures/torch_reference_bf16.json: "default",
    "latency", "latency_pallas", "production_pallas"); with `attribute`,
    where each record that differs first parts from JAX
    (`first_parting`)."""
    if package:
        sys.path.insert(0, package)
    sys.path.insert(1, os.path.dirname(HERE))
    import tuatara_tpu_torch
    from chip_smoke import PAGES, word_share
    from tuatara_tpu_torch.utils.image import load_image

    root = os.path.dirname(HERE)
    with open(os.path.join(HERE, "fixtures", "torch_reference_bf16.json")) as f:
        ref = json.load(f)["variants"]
    weights = os.path.join(root, "evals", "production_weights")
    print(f"package: {os.path.dirname(tuatara_tpu_torch.__file__)}")
    for preset in presets:
        cfg = (tuatara_tpu_torch.OcrConfig() if preset == "default" else
               getattr(tuatara_tpu_torch.OcrConfig, PRESETS[preset][0])())
        engine = tuatara_tpu_torch.OcrEngine(cfg, weights_dir=weights, device="cpu")
        jax_engine = None
        hit = total = 0
        per_page = {}
        kinds = {"detection": 0, "recognition": 0}
        for page in PAGES:
            want = ref[preset]["pages"][page]["words"]
            img = load_image(os.path.join(root, "images", f"{page}.png"))
            got = engine.run(img)
            n = round(word_share(want, got) * len(want))
            per_page[page] = n
            hit += n
            total += len(want)
            if attribute and n < len(want):
                if jax_engine is None:
                    from tuatara_tpu.api import OcrEngine as JaxEngine

                    jax_engine = JaxEngine(jax_config(preset), weights_dir=weights)
                scale = ""
                if engine.craft.quantized:
                    scale = "; " + first_scale_parting(engine, jax_engine, img)
                for line in first_parting(engine, jax_engine, img, want, got):
                    kinds["detection" if "; detection:" in line else "recognition"] += 1
                    print(f"  {preset} {page}: {line}{scale}", flush=True)
        print(f"{preset}: {hit} of {total} JAX bf16 records ({hit / total:.4f}); per page "
              f"{json.dumps(per_page)}"
              + (f"; the missed part first at {json.dumps(kinds)}" if attribute else ""),
              flush=True)


def jax_int8_scales(jax_engine, img):
    """JAX's int8 CRAFT on a page as its engine jits it (canvas prep and
    CRAFT in one graph) -> ([(amax, xs)] of each quantized layer in the
    order their inputs are quantized, whether the scores equal those of
    the same graph without the extra outputs). The jit returns only those
    fp32 scalars beside the scores: a bf16 intermediate returned from it
    would be materialized, and keep a rounding the whole graph may drop."""
    import jax
    import jax.numpy as jnp

    from tuatara_tpu.api import _canvas_prep
    from tuatara_tpu.models import layers as JL
    from tuatara_tpu.models.craft import craft_forward

    cfg, ccfg = jax_engine.config, jax_engine.craft_config
    saved, taps = JL.quantize_act_q, []

    def quantize(qp, x):
        xq, xs = saved(qp, x)
        taps.append((jnp.max(jnp.abs(x.astype(jnp.float32))), xs))
        return xq, xs

    def forward(p, im):
        taps.clear()
        canvases = jax.vmap(lambda i: _canvas_prep(i, cfg))(im)
        return (craft_forward(p, canvases, ccfg, compute_dtype=jnp.dtype(cfg.compute_dtype))[0],
                list(taps))

    page = jnp.asarray(np.asarray(img)[None])
    plain, _ = jax.jit(forward)(jax_engine.craft_params, page)
    JL.quantize_act_q = quantize
    try:
        scores, scales = jax.jit(lambda p, im: forward(p, im))(jax_engine.craft_params, page)
    finally:
        JL.quantize_act_q = saved
    same = bool(np.array_equal(np.asarray(plain), np.asarray(scores)))
    return [(float(a), float(x)) for a, x in scales], same


def port_int8_scales(engine, img):
    """The port's int8 CRAFT on a page (`engine.detect`) -> [(layer, amax,
    xs)] in `Craft.qconvs()` order, the order their inputs are quantized."""
    from tuatara_tpu_torch.models.layers import QConv, _abs_max

    names = {id(m): n for n, m in engine.craft.qconvs()}
    rows, orig = [], QConv.quantize_input

    def quantize_input(self, x):
        xq, xs = orig(self, x)
        rows.append((names[id(self)], float(_abs_max(x)), float(xs)))
        return xq, xs

    images = engine._to_device(engine._batch_geometry(img)[0])
    QConv.quantize_input = quantize_input
    try:
        with torch.no_grad():
            engine.detect(images)
    finally:
        QConv.quantize_input = orig
    return rows


def first_scale_parting(engine, jax_engine, img):
    """-> a line: the first int8 layer of the page (module order) whose
    dynamic scale xs differs from JAX's, with both xs and both abs-maxes,
    or that every one is equal."""
    want, same = jax_int8_scales(jax_engine, img)
    got = port_int8_scales(engine, img)
    tail = "" if same else " (JAX's observed graph scored otherwise than its plain one)"
    for (layer, amax, xs), (jamax, jxs) in zip(got, want):
        if xs != jxs:
            return (f"first int8 scale that parts: {layer} xs JAX {jxs!r}, port {xs!r} (amax "
                    f"JAX {jamax!r}, port {amax!r}){tail}")
    return f"every int8 scale equal to JAX's ({len(got)} layers){tail}"


def _unmatched(want, got):
    """JAX's records that no distinct port record equals in text and bbox
    (chip_smoke.word_share's matching)."""
    pool = {}
    for w in got:
        key = (w["text"], tuple(w["bbox"]))
        pool[key] = pool.get(key, 0) + 1
    out = []
    for w in want:
        key = (w["text"], tuple(w["bbox"]))
        if pool.get(key, 0) > 0:
            pool[key] -= 1
        else:
            out.append(w)
    return out


def first_parting(engine, jax_engine, img, want, got):
    """For each JAX record (want) that the port's records (got) do not
    give, where the two first part, as a line:

    * the port has no box with JAX's bbox: detection. The pixels of the
      bf16 heatmaps on the other side of a threshold (text_threshold and
      low_text on the text map, link_threshold on the link map) within 2
      pixels of the box, and the first of them with both values;
    * the port has the box, with other text: recognition. The box's crop
      (the engine's own) through both recognizers alone (a slab of one;
      of 8 copies where the recognizer's Pallas kernels are forced, so
      that the gates run them): the first greedy step whose argmax
      differs, with JAX's two best classes and both packages' logits for
      them, else the first refined position that differs, else "not
      reproduced" (the slab's other rows change the sums' order)."""
    import jax
    import jax.numpy as jnp

    from tuatara_tpu.api import _canvas_prep
    from tuatara_tpu.models import parseq as jparseq
    from tuatara_tpu.models.craft import craft_forward
    from tuatara_tpu_torch.ops.resize import resize_geometry

    bf16 = jnp.bfloat16
    cfg, pq, tok = engine.config, engine.parseq, engine.tokenizer
    images, _, h, w, _ = engine._batch_geometry(img)
    images = engine._to_device(images)
    with torch.no_grad():
        det = engine.detect(images)
    bboxes = [tuple(float(v) for v in b) for b in det["bbox"][0].tolist()]
    lines, heat = [], None
    jcfg, pcfg = jax_engine.config, jax_engine.parseq_config

    def chars(i):
        return repr(tok.itos[i]) if i else "EOS"

    for rec in _unmatched(want, got):
        bbox = tuple(rec["bbox"])
        same = [g for g in got if tuple(g["bbox"]) == bbox]
        head = f"JAX {rec['text']!r} {list(bbox)}, port "
        if not same:
            if heat is None:
                canv = jax.jit(lambda im: _canvas_prep(im, jcfg))(jnp.asarray(np.asarray(img)))
                want_h = np.asarray(craft_forward(jax_engine.craft_params, canv[None],
                                                  jax_engine.craft_config,
                                                  compute_dtype=bf16)[0][0])
                heat = want_h, det["scores"][0].float().numpy()
            ratio = resize_geometry(h, w, cfg)[2] / 2
            x0, y0, x1, y1 = (int(round(v * ratio)) for v in bbox)
            region = (slice(max(y0 - 2, 0), y1 + 3), slice(max(x0 - 2, 0), x1 + 3))
            flips = []
            for name, ch, thr in (("text_threshold", 0, cfg.text_threshold),
                                  ("low_text", 0, cfg.low_text),
                                  ("link_threshold", 1, cfg.link_threshold)):
                a, b = heat[0][region + (ch,)], heat[1][region + (ch,)]
                for y, x in np.argwhere((a > thr) != (b > thr)):
                    flips.append((name, thr, y + region[0].start, x + region[1].start,
                                  float(a[y, x]), float(b[y, x])))
            near = max(bboxes or [(0, 0, 0, 0)], key=lambda b: _iou(b, bbox))
            where = (f"first {flips[0][0]} {flips[0][1]} at heatmap (y {flips[0][2]}, x "
                     f"{flips[0][3]}): JAX {flips[0][4]:.5f}, port {flips[0][5]:.5f}"
                     if flips else "none within 2 px of the box")
            lines.append(head + f"no box there (nearest {list(near)}, IoU {_iou(near, bbox):.2f})"
                         f"; detection: {len(flips)} heatmap pixels across a threshold, {where}")
            continue
        j = bboxes.index(bbox)
        valid = torch.zeros_like(det["valid"])
        valid[0, j] = True
        with torch.no_grad():
            crops, _ = engine._crop_slab(images, det["rects"], valid, 1)
            if pcfg.encoder_impl == "pallas":
                crops = crops.expand(8, *crops.shape[1:]).contiguous()
            memory = pq.encode(crops)
            ar = pq.greedy_decode(memory)
            refined = pq.refine(memory, ar)
        x = crops.numpy()
        jmem = jax.jit(lambda p, v: jparseq.parseq_encode(p, v, pcfg, compute_dtype=bf16))(
            jax_engine.parseq_params, x)
        jar = jax.jit(lambda p, m: jparseq.parseq_greedy_decode(p, m, pcfg, bf16)[0].astype(
            jnp.float32))(jax_engine.parseq_params, jmem)
        # The refined logits leave the jit in bf16, as the engine's graph
        # keeps them (a cast inside would drop the head's rounding).
        jref = jax.jit(lambda p, m, lg: jparseq.parseq_refine(p, m, lg, pcfg, bf16))(
            jax_engine.parseq_params, jmem, jar).astype(jnp.float32)
        mem_diff = float(np.abs(np.asarray(jmem) - memory.numpy()).max())
        where = "not reproduced at a slab of one"
        for stage, a, b in (("greedy step", np.asarray(jar)[0], ar.float().numpy()[0]),
                            ("refined position", np.asarray(jref)[0], refined.numpy()[0])):
            ia, ib = a.argmax(-1), b.argmax(-1)
            diff = np.nonzero(ia != ib)[0]
            if len(diff):
                t = int(diff[0])
                c1, c2 = np.argsort(-a[t], kind="stable")[:2]
                where = (f"{stage} {t}: JAX {chars(c1)} {a[t, c1]:.4f} > {chars(c2)} "
                         f"{a[t, c2]:.4f}; port {chars(c1)} {b[t, c1]:.4f}, {chars(c2)} "
                         f"{b[t, c2]:.4f}, argmax {chars(ib[t])} {b[t, ib[t]]:.4f}")
                break
        lines.append(head + f"{same[0]['text']!r}; recognition: {where} (memory max |JAX - "
                     f"port| {mem_diff:.3g})")
    return lines


def _iou(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def residual_rounding():
    """The `residual` probe (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import torch.nn.functional as F

    from tuatara_tpu.models import layers as JL

    rng = np.random.default_rng(0)
    w = (rng.standard_normal((384, 384)) * 0.05).astype(np.float32)
    b = rng.standard_normal(384).astype(np.float32)
    h = rng.standard_normal((4, 26, 384)).astype(np.float32)
    x = rng.standard_normal((4, 26, 384)).astype(np.float32) * 3
    want = np.asarray(jax.jit(lambda x, h: x + JL.linear({"w": w, "b": b}, h, jnp.bfloat16))(x, h))
    y = F.linear(torch.from_numpy(h).bfloat16(), torch.from_numpy(w.T).bfloat16())
    bt, xt = torch.from_numpy(b).bfloat16(), torch.from_numpy(x)
    from tuatara_tpu_torch.models import layers as TL

    lin = TL.Linear(384, 384)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
        TL.set_compute_dtype(lin, torch.bfloat16)
        port = lin(torch.from_numpy(h), residual=xt)
    for name, got in (("x + bf16(y + b)", xt + (y + bt).float()),
                      ("x + (fp32(y) + fp32(b))", xt + (y.float() + bt.float())),
                      ("the port's Linear(h, residual=x)", port)):
        print(f"{name}: {np.mean(got.numpy() == want):.6f} of JAX's values equal")


def shrink_weights(n_in, n_out):
    """JAX's antialiased bilinear weight matrix for one axis of a shrink
    (`jax.image.resize`'s `compute_weight_mat`: the triangle kernel widened
    by the scale), computed in fp32 in the formula's order -> [n_in, n_out]."""
    inv = np.float32(n_in / n_out)
    scale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / scale
    w = np.maximum(np.float32(1.0) - x, np.float32(0.0))
    total = w.sum(0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resample_residual():
    """The `resample` probe (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    from tuatara_tpu_torch.config import OcrConfig
    from tuatara_tpu_torch.ops import resize as R

    sys.path.insert(0, HERE)
    from torch_common import image

    img = image("table_english")
    h, w, c = img.shape
    th, tw, _ = R.resize_geometry(h, w, OcrConfig())

    def jax_resize(x, shape):
        return np.asarray(jax.jit(lambda v: jax.image.resize(v, shape, "bilinear"))(x))

    want = jax_resize(img.astype(np.float32), (th, tw, c))

    def report(name, got):
        d = np.abs(got - want)
        print(f"{name}: {np.mean(got != want):.6f} of values differ, max {d.max():.3g}")

    report("F.interpolate(antialias=True)", R.resample(torch.from_numpy(img), th, tw).numpy())
    # JAX's own weight matrices, read back through an identity image.
    wh = jax_resize(np.eye(h, dtype=np.float32)[:, :, None], (th, h, 1))[:, :, 0].T
    ww = jax_resize(np.eye(w, dtype=np.float32)[:, :, None], (tw, w, 1))[:, :, 0].T
    ph, pw = shrink_weights(h, th), shrink_weights(w, tw)
    print(f"shrink_weights against JAX's matrices: {np.mean(ph != wh):.6f} and "
          f"{np.mean(pw != ww):.6f} of the entries differ")

    def fused_taps(x, wm, axis):
        """Contract `axis` with wm, each output's nonzero taps as a chain of
        fused multiply-adds in index order (float64 products, exact)."""
        x = np.moveaxis(x, axis, 0).astype(np.float64)
        out = np.zeros((wm.shape[1],) + x.shape[1:], np.float32)
        for j in range(wm.shape[1]):
            acc = np.zeros(x.shape[1:], np.float32)
            for k in np.nonzero(wm[:, j])[0]:
                acc = (x[k] * np.float64(wm[k, j]) + acc).astype(np.float32)
            out[j] = acc
        return np.moveaxis(out, 0, axis)

    for name, (a, b) in (("JAX's matrices", (wh, ww)), ("shrink_weights", (ph, pw))):
        report(f"two contractions, H then W, fused taps, {name}",
               fused_taps(fused_taps(img.astype(np.float32), a, 0), b, 1))


# ---- the `hlo` probe -------------------------------------------------------

_HLO_COMP = re.compile(r"^(ENTRY )?%([\w.\-]+) .*\{$")
_HLO_INSTR = re.compile(r"^\s*(ROOT )?%([\w.\-]+) = (\S+?|\(.*?\)) ([\w\-]+)\((.*)$")
# Ops that move an fp32 value without computing on it: followed through.
_MOVES = {"bitcast", "reshape", "copy", "transpose", "slice", "dynamic-slice", "broadcast",
          "concatenate", "pad", "reverse", "dynamic-update-slice"}
# A scope name keeps only [A-Za-z0-9_]: "bias__parseq_245__layers_607".
_SCOPE = re.compile(r"(bias__[A-Za-z0-9_]+)\)*/add$")


def parse_hlo(text):
    """Optimised HLO text -> ({computation: {instruction: fields}}, the
    entry computation's name)."""
    comps, entry, cur = {}, None, None
    for line in text.splitlines():
        m = _HLO_COMP.match(line)
        if m:
            cur = comps.setdefault(m[2], {})
            entry = m[2] if m[1] else entry
            continue
        m = _HLO_INSTR.match(line)
        if m is None or cur is None:
            continue
        rest, depth = m[5], 1
        for i, ch in enumerate(rest):
            depth += {"(": 1, ")": -1}.get(ch, 0)
            if depth == 0:
                break
        attrs = rest[i + 1:]

        def attr(pattern):
            a = re.search(pattern, attrs)
            return a[1] if a else None

        cur[m[2]] = {"root": bool(m[1]), "type": m[3], "op": m[4],
                     "operands": re.findall(r"%([\w.\-]+)", rest[:i]),
                     "op_name": attr(r'op_name="([^"]*)"') or "",
                     "calls": attr(r"calls=%([\w.\-]+)"), "body": attr(r"body=%([\w.\-]+)"),
                     "cond": attr(r"condition=%([\w.\-]+)"), "index": attr(r"index=(\d+)"),
                     "param": rest[:i] if m[4] == "parameter" else None,
                     "literal": rest[:i] if m[4] == "constant" else None}
    return comps, entry


def hlo_graph(text):
    """Optimised HLO text -> (computations, the entry's name, {computation:
    {instruction: [(user, operand position)]}}, {computation: [(caller's
    computation, calling instruction)]}, param(computation, k) -> the name
    of its parameter k)."""
    comps, entry = parse_hlo(text)
    users, callers = {}, {}
    for cname, instrs in comps.items():
        u = users.setdefault(cname, {})
        for iname, ins in instrs.items():
            for pos, o in enumerate(ins["operands"]):
                u.setdefault(o, []).append((iname, pos))
            for callee in (ins["calls"], ins["body"]):
                if callee:
                    callers.setdefault(callee, []).append((cname, iname))

    def param(comp, k):
        return next(n for n, i in comps[comp].items() if i["op"] == "parameter"
                    and i["param"] == str(k))

    return comps, entry, users, callers, param


def _short(op_name):
    """An op name's last two scopes."""
    return "/".join(op_name.split("/")[-2:])


def bias_add_outcomes(text):
    """Each bias add of the optimised HLO (an `add` named `<scope>/add`
    directly under a `bias__...` scope) -> {scope: set of outcomes}:
    "rounded" where a convert to a 16-bit type comes first on a path,
    "rounded (bf16 add)" where the add itself is bf16, else "fp32 <op> (<op
    name>)" for the first op that computes on the unrounded fp32 sum, or
    "fp32 output". Paths are followed through fusions, calls, while loops
    (the body's result back into the body and out of the loop), tuples and
    the ops in _MOVES."""
    comps, entry, users, callers, param = hlo_graph(text)

    found = {}
    for cname, instrs in comps.items():
        for iname, ins in instrs.items():
            m = _SCOPE.search(ins["op_name"])
            if ins["op"] != "add" or m is None:
                continue
            out = found.setdefault(m[1], set())
            if not ins["type"].startswith("f32"):
                out.add(f"rounded ({ins['type'].split('[')[0]} add)")
                continue
            work, seen = [(cname, iname, ())], set()
            while work:
                c, n, path = work.pop()
                if (c, n, path) in seen:
                    continue
                seen.add((c, n, path))
                if comps[c][n]["root"]:
                    if c == entry:
                        out.add("fp32 output")
                    for cc, ci in callers.get(c, []):
                        if comps[cc][ci]["op"] == "while":
                            work.append((c, param(c, 0), path))
                        work.append((cc, ci, path))
                for un, pos in users[c].get(n, []):
                    u = comps[c][un]
                    if u["op"] == "convert" and not path:
                        out.add("rounded" if u["type"].startswith(("bf16", "f16")) else
                                f"fp32 convert ({_short(u['op_name'])})")
                    elif u["op"] == "tuple":
                        work.append((c, un, (pos,) + path))
                    elif u["op"] == "get-tuple-element":
                        if path and str(path[0]) == u["index"]:
                            work.append((c, un, path[1:]))
                    elif u["op"] in _MOVES:
                        if pos == 0 or (u["op"] == "dynamic-update-slice" and pos == 1) or (
                                u["op"] not in ("dynamic-slice", "dynamic-update-slice")):
                            work.append((c, un, path))
                    elif u["op"] in ("fusion", "call"):
                        work.append((u["calls"], param(u["calls"], pos), path))
                    elif u["op"] == "while":
                        work += [(u[k], param(u[k], 0), path) for k in ("body", "cond")]
                    else:
                        out.add(f"fp32 {u['op']} ({_short(u['op_name'])})")
    return found


def _call_site(root):
    """The two innermost frames of the repository's files (under `root`)
    on the stack, without the caller's own -> ([(file, function, line)],
    a scope name "<file>_<line>__<file>_<line>")."""
    frames = [f for f in traceback.extract_stack()[:-2]
              if os.path.abspath(f.filename).startswith(root + os.sep)][::-1][:2]
    sites = [(os.path.basename(f.filename), f.name, f.lineno) for f in frames]
    return sites, "__".join(f"{n[:-3]}_{ln}" for n, _, ln in sites)


class bias_scopes:
    """While open, the JAX package's `linear` and `conv2d` (module
    attributes, which its own functions look up at call time) run inside a
    named scope `bias__<file>_<line>__<file>_<line>` naming the two
    innermost frames of the repository's files that called them; `self.sites` maps each scope to
    those frames [(file, function, line), ...]. CRAFT's decoder sum `ya +
    yb` (`conv1_split`, after its bias-free skip-side conv) is traced in a
    scope of its own, `bias__sum__...` named by that conv's frames (the
    function "conv1_split: ya + yb"), from the conv's return to the next
    call of `batchnorm_train`, `batchnorm`, `linear` or `conv2d` (the
    sum's BatchNorm, or with folded BatchNorms the next conv). The package
    is not edited."""

    def __enter__(self):
        import jax

        from tuatara_tpu.models import layers as JL

        self.sites = {}
        self.saved = (JL.linear, JL.conv2d, JL.batchnorm_train, JL.batchnorm)
        self.open = []
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(JL.__file__))))

        def close():
            while self.open:
                self.open.pop().__exit__(None, None, None)

        def scoped(fn):
            def call(*args, **kwargs):
                close()
                sites, name = _call_site(root)
                scope = "bias__" + name
                self.sites[scope] = sites
                with jax.named_scope(scope):
                    out = fn(*args, **kwargs)
                if sites and sites[0][1] == "conv1_split" and "b" not in args[0]:
                    scope = "bias__sum__" + name
                    self.sites[scope] = [(sites[0][0], "conv1_split: ya + yb", sites[0][2]),
                                         *sites[1:]]
                    self.open.append(jax.named_scope(scope))
                    self.open[-1].__enter__()
                return out
            return call

        def closing(fn):
            def call(*args, **kwargs):
                close()
                return fn(*args, **kwargs)
            return call

        JL.linear, JL.conv2d = scoped(JL.linear), scoped(JL.conv2d)
        JL.batchnorm_train, JL.batchnorm = closing(JL.batchnorm_train), closing(JL.batchnorm)
        self.close = close
        return self

    def __exit__(self, *exc):
        from tuatara_tpu.models import layers as JL

        self.close()
        JL.linear, JL.conv2d, JL.batchnorm_train, JL.batchnorm = self.saved


# The JAX call site of a bias add (the frame that called `linear`, and the
# one above it) -> the port's counterpart: (module, function, a text on the
# line); every unrounded site, and the rounded ones next to the fused
# kernels. Sites not listed are printed with "-".
PORT_SITES = {
    ("parseq.py", 112): ("models.parseq", "Parseq.encode", "residual=self.pos_embed"),
    ("layers.py", 558, "layers.py", 607): ("models.layers", "VitBlock.forward",
                                           "self.attn(h, h, residual"),
    ("layers.py", 445, "layers.py", 608): ("models.layers", "VitBlock.forward",
                                           "self.mlp(self.norm2(x), residual"),
    ("layers.py", 558, "parseq.py", 260): ("models.parseq", "Parseq.decode", "layer.self_attn(qn"),
    ("layers.py", 558, "parseq.py", 262): ("models.parseq", "Parseq.decode",
                                           "layer.cross_attn(layer.norm1(q)"),
    ("parseq.py", 245): ("models.parseq", "DecoderLayer.ff", "linear2(h, residual"),
    ("parseq.py", 442): ("models.parseq", "Parseq.greedy_decode", "self_attn.o("),
    ("layers.py", 582, "parseq.py", 447): ("models.parseq", "Parseq.greedy_decode",
                                           "cross_attn.attend("),
    ("layers.py", 582, "parseq.py", 558): ("models.parseq", "Parseq.beam_decode",
                                           "self_attn.attend("),
    ("layers.py", 582, "parseq.py", 560): ("models.parseq", "Parseq.beam_decode",
                                           "cross_attn.attend("),
    # Next to K7 (the forced-Pallas graph): its memory K/V, rounded.
    ("parseq.py", 369): ("models.parseq", "Parseq.greedy_decode", "ca.k(memory)"),
    ("parseq.py", 370): ("models.parseq", "Parseq.greedy_decode", "ca.v(memory)"),
    # The training graph (the losses' gradients).
    ("parseq.py", 318, "losses.py", 172): ("train.losses", "parseq_plm_loss", "fp32_logits=True"),
}


def port_line(site):
    """A JAX call site [(file, function, line), ...] -> the port's
    counterpart as "tuatara_tpu_torch/<path>:<line> <function>", or "-"."""
    import importlib
    import inspect

    flat = [x for f, _, ln in site for x in (f, ln)]
    hit = PORT_SITES.get(tuple(flat)) or PORT_SITES.get(tuple(flat[:2]))
    if hit is None:
        return "-"
    module, qualname, text = hit
    mod = importlib.import_module(f"tuatara_tpu_torch.{module}")
    obj = mod
    for part in qualname.split("."):
        obj = getattr(obj, part)
    lines, start = inspect.getsourcelines(obj)
    k = next(i for i, ln in enumerate(lines) if text in ln and i > 0)
    return f"tuatara_tpu_torch/{module.replace('.', '/')}.py:{start + k} {qualname}"


def pallas_graph(engine, n=16):
    """The `hlo` probe's graph of a forced-Pallas JAX engine (`jax_config`):
    its greedy `_recognize_body` on n seeded crops, K6 interpreted and K7
    a host callback (`pallas_reference`), as the forced-Pallas records run
    them."""
    crops = np.random.default_rng(0).random((n, *engine.parseq_config.img_size, 3),
                                            dtype=np.float32)
    return ("_recognize_body (greedy, forced Pallas)", engine._recognize_body,
            (engine.parseq_params, crops), False)


def hlo_graphs(pallas=True):
    """[(name, function, args, is a training graph)]: what the JAX engine
    jits at bf16 on the golden weights, and the training losses'
    gradients; with `pallas`, last, the forced-Pallas `latency()` engine's
    recognizer on `evals/production_weights` (`pallas_graph`; the golden
    weights' width, 32, takes no Pallas kernel)."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, HERE)
    from torch_common import GOLDEN, image

    from tuatara_tpu.api import OcrEngine as JaxEngine, _canvas_prep
    from tuatara_tpu.config import OcrConfig as JaxConfig
    from tuatara_tpu.models.craft import craft_forward
    from tuatara_tpu.models.parseq import parseq_encode, quantize_parseq_encoder
    from tuatara_tpu.train.losses import craft_loss, parseq_plm_loss
    from tuatara_tpu.utils import weights as JW

    bf16 = jnp.bfloat16
    engine = JaxEngine(JaxConfig(), weights_dir=GOLDEN)
    pcfg = engine.parseq_config
    rng = np.random.default_rng(0)
    crops = rng.random((8, *pcfg.img_size, 3)).astype(np.float32)
    page = image("resume_example")[:200, :300].copy()
    graphs = []
    for mode in ("greedy", "nar", "beam"):
        eng = JaxEngine(JaxConfig(decode_mode=mode), weights_dir=GOLDEN)
        graphs.append((f"_recognize_body ({mode})", eng._recognize_body,
                       (eng.parseq_params, crops), False))
    qparams = quantize_parseq_encoder(engine.parseq_params)
    graphs.append(("parseq_encode (int8 encoder)",
                   lambda p, x: parseq_encode(p, x, pcfg, compute_dtype=bf16), (qparams, crops),
                   False))
    for preset in ("default", "latency"):
        cfg = JaxConfig() if preset == "default" else JaxConfig.latency()
        canvas = jax.jit(lambda im: _canvas_prep(im, cfg))(page)[None]
        graphs.append((f"craft_forward ({preset}, canvas {tuple(canvas.shape[1:3])})",
                       lambda p, x: craft_forward(p, x, engine.craft_config,
                                                  compute_dtype=bf16)[0],
                       (engine.craft_params, canvas), False))
    T = pcfg.max_label_length + 1
    labels = np.zeros((4, T + 1), np.int32)
    labels[:, 0], labels[:, 1:4] = pcfg.num_tokens - 2, 5
    lengths = np.full(4, 4, np.int32)
    graphs.append(("parseq_plm_loss (its gradient)", jax.value_and_grad(
        lambda p: parseq_plm_loss(p, crops[:4], labels, lengths, jax.random.PRNGKey(0),
                                  pcfg)[0]), (engine.parseq_params,), True))
    tree = jax.tree_util.tree_map(jnp.asarray, JW.load_weights_dir(GOLDEN)[0])
    images = rng.random((2, 64, 64, 3)).astype(np.float32)
    target = rng.random((2, 32, 32, 2)).astype(np.float32)
    graphs.append(("craft_loss (train_bn, its gradient)", jax.value_and_grad(
        lambda p: craft_loss(p, images, target, None, engine.craft_config)[0]), (tree,), True))
    if pallas:
        weights = os.path.join(os.path.dirname(HERE), "evals", "production_weights")
        graphs.append(pallas_graph(JaxEngine(jax_config("latency_pallas"), weights_dir=weights)))
    return graphs


def hlo_sites(training=None):
    """The `hlo` probe (see the module docstring) over `hlo_graphs()` (only
    the serving or the training graphs when `training` is False or True).
    -> [(JAX call site, a tuple of frames; its outcomes)], one a site of a
    graph."""
    import jax

    out = []
    for name, fn, args, train in hlo_graphs():
        if training is not None and train != training:
            continue
        with bias_scopes() as scopes:
            text = jax.jit(fn).lower(*args).compile().as_text()
        found = bias_add_outcomes(text)
        print(f"{name}: {len(found)} bias-add sites")
        for scope in sorted(found, key=lambda k: scopes.sites[k]):
            site = tuple(scopes.sites[scope])
            outcome = found[scope]
            unrounded = any(o.startswith("fp32") for o in outcome)
            out.append((site, outcome))
            print(f"  {'UNROUNDED' if unrounded else 'rounded':9s} {scope}/add  JAX "
                  + " < ".join(f"{f}:{ln} {fn}" for f, fn, ln in site)
                  + f"  port {port_line(site)}  "
                  + f"[{'; '.join(sorted(outcome))}]")
    return out


# ---- the `hlo` probe's GELU backward ---------------------------------------

# The gradient at a bf16 GELU's input x for the output gradient g, as
# `kernels/bias_act.gelu_plain_grad` (and the `gelu_grad` kernel) computes
# it, in `gelu_vjp_form`'s notation: T(.) rounds to bf16, erfc's argument is
# not rounded, every constant is bf16's.
_A = "T(-x)·0.70703125"
GELU_GRAD_FORM = (f"T(T(-T(T(T(T(T(x·0.5)·g)·-1.125)·T(exp(T(-T(T({_A})·T({_A}))))))"
                  f"·0.70703125)) + T(T(g·T(erfc({_A})))·0.5))")
_BINARY = {"multiply": "·", "add": " + ", "subtract": " - ", "divide": " / "}


def gelu_vjp_form(dtype="bfloat16"):
    """The expression XLA's optimised graph computes for the gradient at
    the GELU's input in the gradient of the JAX package's `mlp` (layers.py
    `mlp`, whose `jax.nn.gelu` runs inside a named scope while tracing; the
    package is not edited): followed back from the backward's last add
    through fusions, converts and broadcasts to the GELU's input x and the
    output gradient g. A convert to the 16-bit dtype is T(.) (a negation of
    a value already rounded is written without it: it is exact), XLA's
    erfc polynomial is erfc(.) of its one argument."""
    import jax
    import jax.numpy as jnp

    from tuatara_tpu.models import layers as JL

    dt = jnp.dtype(dtype)
    saved = jax.nn.gelu

    def scoped(*args, **kwargs):
        with jax.named_scope("gelu_site"):
            return saved(*args, **kwargs)

    params = JL.init_mlp(jax.random.PRNGKey(0), 32, 64)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 5, 32)).astype(np.float32))
    jax.nn.gelu = scoped
    try:
        text = jax.jit(jax.grad(lambda p, x: jnp.sum(
            JL.mlp(p, x, compute_dtype=dt).astype(jnp.float32) ** 2))).lower(
                params, x).compile().as_text()
    finally:
        jax.nn.gelu = saved
    comps, entry, users, callers, param = hlo_graph(text)
    short = {"bfloat16": "bf16", "float16": "f16"}[dtype]

    def caller_operand(comp, name):
        cc, ci = callers[comp][0]
        return cc, comps[cc][ci]["operands"][int(comps[comp][name]["param"].split(")")[0]
                                                 .split("(")[-1])]

    def erfc_argument(comp, name):
        """The one op of the GELU that feeds the erfc polynomial at (comp,
        name) (its other inputs are XLA's own constants and selects)."""
        work, seen, args = [(comp, name)], set(), set()
        while work:
            c, n = work.pop()
            if (c, n) in seen:
                continue
            seen.add((c, n))
            ins = comps[c][n]
            if ins["op"] == "parameter" and c != entry:
                work.append(caller_operand(c, n))
            elif ins["op_name"].endswith("/erfc") or ins["op"] in ("constant", "broadcast"):
                work += [(c, o) for o in ins["operands"]]
            else:
                args.add((c, n))
        (arg,) = [a for a in args if "gelu_site" in comps[a[0]][a[1]]["op_name"]]
        return arg

    def bare(ex):
        return ex[1:-1] if ex.startswith("(") else ex

    def rounded(ex):
        return ex if ex in ("x", "g") else f"T({bare(ex)})"

    def expr(comp, name):
        """-> the value at (comp, name) as text; a product, sum or
        difference in parentheses."""
        ins = comps[comp][name]
        op = ins["op"]
        if op == "parameter":
            if comp == entry:
                return ins["op_name"] or name
            return expr(*caller_operand(comp, name))
        if op == "constant":
            return ins["literal"]
        if op == "fusion":
            return expr(ins["calls"], next(n for n, i in comps[ins["calls"]].items()
                                           if i["root"]))
        if op == "get-tuple-element":
            tup = comps[comp][ins["operands"][0]]
            if tup["op"] == "fusion":
                body = tup["calls"]
                root = next(n for n, i in comps[body].items() if i["root"])
                return expr(body, comps[body][root]["operands"][int(ins["index"])])
            return expr(comp, tup["operands"][int(ins["index"])])
        if op in ("bitcast", "broadcast", "reshape", "copy"):
            return expr(comp, ins["operands"][0])
        if op == "convert":
            arg = expr(comp, ins["operands"][0])
            return rounded(arg) if ins["type"].startswith(short) else arg
        if "gelu_site" not in ins["op_name"]:
            return "g" if "transpose(" in ins["op_name"] else "x"
        if ins["op_name"].endswith("/erfc"):
            return f"erfc({bare(expr(*erfc_argument(comp, name)))})"
        args = [expr(comp, o) for o in ins["operands"]]
        if op == "negate":
            out = f"-{args[0]}"
        elif op == "exponential":
            out = f"exp({bare(args[0])})"
        else:
            out = "(" + _BINARY[op].join(args) + ")"
        # An op of the 16-bit type itself rounds its result.
        return rounded(out) if ins["type"].startswith(short) else out

    root = next((c, n) for c, instrs in comps.items() for n, i in instrs.items()
                if "transpose(jvp(gelu_site))/add_any" in i["op_name"] and i["op"] == "add")
    out = expr(*root)
    # The add is rounded by its consumer (a convert to the dtype).
    c, n = root
    if any(comps[c][u]["op"] == "convert" and comps[c][u]["type"].startswith(short)
           for u, _ in users[c].get(n, [])):
        out = rounded(out)
    return out


# ---- the `hlo` probe's int8 graph -----------------------------------------

# Ops that pass a dequant output on to a consumer without computing a new
# value from it: moves, conversions (a bf16 one marks the path rounded),
# the ReLU (`maximum` with 0), the max-pools and the abs before an abs-max.
_PASS = _MOVES | {"convert", "maximum", "reduce-window", "select", "abs"}
_INT8_SCOPE = re.compile(r"((?:deq|sum|bias)__[A-Za-z0-9_]+)\)*/(add|mul)$")


def int8_layer_order(qtree):
    """The quantized layers of a `quantize_craft_trunk` tree in the order
    JAX's int8 forward quantizes their inputs (the port's `Craft.qconvs()`
    order): the trunk after conv1_1, fc6, fc7, each decoder level's conv1a,
    conv1b and conv2, the head's conv1-3."""
    out = [f"vgg/{n}/conv" for n in sorted(qtree["vgg"]) if "wq" in qtree["vgg"][n]["conv"]]
    out += [f"fc/{n}" for n in sorted(qtree["fc"])]
    for lvl in sorted(qtree["up"]):
        out += [f"up/{lvl}/{n}" for n in ("conv1a", "conv1b", "conv2")]
    return out + [f"head/{n}" for n in sorted(qtree["head"]) if "wq" in qtree["head"][n]]


class int8_scopes:
    """While open, the JAX package's int8 layer functions (module attributes,
    which its functions look up at call time) run inside named scopes that
    name the layer (`layers`, the layers in the order their inputs are
    quantized, `int8_layer_order`): `quant__<layer>` around
    `quantize_act_q` (the abs-max, 127 / amax, x * xs and its rounding),
    `deq__<layer>` around `conv2d_q_pre` (the int32 conv, sw / xs, the
    dequant y * (sw / xs) + b and its cast), `sum__<level>` from conv1b's
    dequant to the next layer call (the decoder's `ya + yb` and its ReLU),
    and the float `conv2d` calls (conv1_1, the head's 1x1s) in `bias__`
    scopes named by their frames, as `bias_scopes` names them
    (`self.sites`). The package is not edited."""

    def __init__(self, layers):
        self.layers = list(layers)

    def __enter__(self):
        import jax

        from tuatara_tpu.models import layers as JL

        self.saved = (JL.quantize_act_q, JL.conv2d_q_pre, JL.conv2d)
        self.sites, self.open, self.calls, self.current = {}, [], 0, None
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(JL.__file__))))

        def close():
            while self.open:
                self.open.pop().__exit__(None, None, None)

        def tag(name):
            return re.sub(r"\W", "_", name)

        def quantize(qp, x):
            close()
            self.current = self.layers[self.calls % len(self.layers)]
            self.calls += 1
            with jax.named_scope("quant__" + tag(self.current)):
                return self.saved[0](qp, x)

        def dequant(*args, **kwargs):
            close()
            with jax.named_scope("deq__" + tag(self.current)):
                out = self.saved[1](*args, **kwargs)
            if self.current.endswith("/conv1b"):
                self.open.append(jax.named_scope("sum__" + tag(self.current[:-7])))
                self.open[-1].__enter__()
            return out

        def conv(*args, **kwargs):
            close()
            sites, name = _call_site(root)
            scope = "bias__" + name
            self.sites[scope] = sites
            with jax.named_scope(scope):
                return self.saved[2](*args, **kwargs)

        JL.quantize_act_q, JL.conv2d_q_pre, JL.conv2d = quantize, dequant, conv
        self.close = close
        return self

    def __exit__(self, *exc):
        from tuatara_tpu.models import layers as JL

        self.close()
        JL.quantize_act_q, JL.conv2d_q_pre, JL.conv2d = self.saved


def int8_outcomes(text):
    """The optimised HLO of an int8 forward traced under `int8_scopes` ->
    ({scope: set of consumers}, {scope: set of opcodes of its "div"}).
    A scope's value is its last op (`deq__`: the dequant's `+ b`, or its
    `* (sw / xs)` without a bias; `sum__`: `ya + yb`; `bias__`: the float
    conv's bias add), followed through fusions, tuples and the ops of
    `_PASS` to each op that computes on it: "rounded <op> (<op name>)" where
    a convert to a 16-bit type lies on the way, "UNROUNDED ..." where none
    does, "output" at the graph's result."""
    comps, entry, users, callers, param = hlo_graph(text)

    starts, divs = {}, {}
    for cname, instrs in comps.items():
        for iname, ins in instrs.items():
            name = ins["op_name"]
            m = re.search(r"((?:quant|deq)__[A-Za-z0-9_]+)\)*/div$", name)
            if m and ins["op"] in ("divide", "multiply"):
                divs.setdefault(m[1], set()).add(ins["op"])
            m = _INT8_SCOPE.search(name)
            if m and ins["op"] == {"add": "add", "mul": "multiply"}[m[2]]:
                starts.setdefault(m[1], {}).setdefault(m[2], []).append((cname, iname))
    found = {}
    for scope, ops in starts.items():
        out = found.setdefault(scope, set())
        work, seen = [], set()
        for c, n in ops.get("add") or ops["mul"]:
            work.append((c, n, (), not comps[c][n]["type"].startswith("f32")))
        while work:
            c, n, path, rounded = work.pop()
            if (c, n, path, rounded) in seen:
                continue
            seen.add((c, n, path, rounded))
            if comps[c][n]["root"]:
                if c == entry:
                    out.add(("rounded" if rounded else "UNROUNDED") + " output")
                for cc, ci in callers.get(c, []):
                    work.append((cc, ci, path, rounded))
            for un, pos in users[c].get(n, []):
                u = comps[c][un]
                if u["op"] == "tuple":
                    work.append((c, un, (pos,) + path, rounded))
                elif u["op"] == "get-tuple-element":
                    if path and str(path[0]) == u["index"]:
                        work.append((c, un, path[1:], rounded))
                elif u["op"] in ("fusion", "call"):
                    work.append((u["calls"], param(u["calls"], pos), path, rounded))
                elif u["op"] == "convert" and not path:
                    if u["type"].startswith(("bf16", "f16")):
                        work.append((c, un, path, True))
                    elif u["type"].startswith("f32"):
                        work.append((c, un, path, rounded))
                    else:
                        out.add(f"{'rounded' if rounded else 'UNROUNDED'} convert to "
                                f"{u['type'].split('[')[0]} ({_short(u['op_name'])})")
                elif u["op"] in _PASS and not path:
                    if pos == 0 or u["op"] not in ("dynamic-slice", "dynamic-update-slice"):
                        work.append((c, un, path, rounded))
                else:
                    out.add(f"{'rounded' if rounded else 'UNROUNDED'} {u['op']} "
                            f"({_short(u['op_name'])})")
    return found, divs


def int8_graphs(full=True):
    """[(name, function, args, layer order)]: JAX's int8 `craft_forward` at
    bf16 as the forced-Pallas `production()` engine (`production_pallas`)
    jits it, the canvas prep and CRAFT in one graph, on the engine's
    quantized, BN-folded tree: the golden weights on the probe's 200x300
    crop of resume_example, and with `full` also `evals/production_weights`
    on funsd_0001129658 (canvas 1024x768); dynamic scales; the packed head
    (the canvases' widths allow it)."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, HERE)
    from torch_common import GOLDEN, image

    from tuatara_tpu.api import OcrEngine as JaxEngine, _canvas_prep
    from tuatara_tpu.models.craft import craft_forward

    cases = [(GOLDEN, "golden", image("resume_example")[:200, :300].copy())]
    if full:
        cases.append((os.path.join(os.path.dirname(HERE), "evals", "production_weights"),
                      "production_weights", image("funsd_0001129658")))
    graphs = []
    for weights, tag, page in cases:
        eng = JaxEngine(jax_config("production_pallas"), weights_dir=weights)
        cfg, ccfg = eng.config, eng.craft_config

        def fn(p, im, cfg=cfg, ccfg=ccfg):
            canvases = jax.vmap(lambda i: _canvas_prep(i, cfg))(im)
            return craft_forward(p, canvases, ccfg,
                                 compute_dtype=jnp.dtype(cfg.compute_dtype))[0]

        graphs.append((f"int8 craft_forward (production_pallas, {tag}, page {page.shape[:2]})",
                       fn, (eng.craft_params, page[None]), int8_layer_order(eng.craft_params)))
    return graphs


# The port's counterpart of each int8 site kind: (module, function, a text
# on the line).
INT8_PORT = {"deq": ("models.layers", "QConv.forward",
                     "dequant(acc, scale, self.bias, self.out_dtype)"),
             "sum": ("models.craft", "Craft._double_conv_q", "y = ya + blk[\"conv1b\"](skip)"),
             "div_xs": ("models.layers", "quantize_act",
                        "xs = torch.full_like(amax, 127.0) / amax"),
             "div_scale": ("models.layers", "QConv.sums", "self.sw / xs")}
# The float convs' bias adds of the int8 graph, by the lines of their two
# JAX frames: conv1_1 (kernel SC), the packed head's conv4 and conv5.
INT8_BIAS_PORT = {(307, 446): ("models.craft", "Craft.forward", "stem.stem_conv(h"),
                  (551, 557): ("models.craft", "Craft.forward", 'hd["conv5"](_conv_relu('),
                  (551, 558): ("models.craft", "Craft.forward", 'hd["conv5"](_conv_relu(')}


def source_line(module, qualname, text):
    """-> "tuatara_tpu_torch/<module path>:<line> <qualname>" of the line
    of `qualname` holding `text`."""
    import importlib
    import inspect

    obj = importlib.import_module(f"tuatara_tpu_torch.{module}")
    for part in qualname.split("."):
        obj = getattr(obj, part)
    lines, start = inspect.getsourcelines(obj)
    k = next(i for i, ln in enumerate(lines) if text in ln and i > 0)
    return f"tuatara_tpu_torch/{module.replace('.', '/')}.py:{start + k} {qualname}"


def int8_sites(graphs=None):
    """The `hlo` probe's int8 part: for each graph of `int8_graphs()`, each
    layer's dequant, each decoder sum and each float conv's bias add, with
    the consumers its value reaches and whether a bf16 rounding comes
    first ("rounded") or not ("UNROUNDED"), the opcode of each scale
    division (`127 / amax`, `sw / xs`: "divide" unless XLA rewrote it), and
    the port's counterpart. -> [(graph name, {scope: consumers}, {scope:
    opcodes}, {scope: frames of a bias__ scope})]."""
    import jax

    out = []
    for name, fn, args, layers in graphs if graphs is not None else int8_graphs():
        with int8_scopes(layers) as scopes:
            text = jax.jit(fn).lower(*args).compile().as_text()
        found, divs = int8_outcomes(text)
        n = {k: sum(s.startswith(k) for s in found) for k in ("deq", "sum", "bias")}
        print(f"{name}: {n['deq']} dequant sites, {n['sum']} decoder sums, {n['bias']} float "
              f"bias adds")
        port = {k: source_line(*v) for k, v in INT8_PORT.items()}
        order = {"deq__" + re.sub(r"\W", "_", lay): i for i, lay in enumerate(layers)}
        for scope in sorted(found, key=lambda k: (order.get(k, len(order)), k)):
            cons = sorted(found[scope])
            verdict = "UNROUNDED" if any(c.startswith("UNROUNDED") for c in cons) else "rounded"
            kind = scope.split("__")[0]
            if kind in port:
                where = port[kind]
            else:
                site = scopes.sites[scope]
                hit = INT8_BIAS_PORT.get(tuple(ln for _, _, ln in site))
                where = ((source_line(*hit) if hit else "-") + "  JAX "
                         + " < ".join(f"{f}:{ln} {fn}" for f, fn, ln in site))
            print(f"  {verdict:9s} {scope}  port {where}  [{'; '.join(cons)}]")
        for scope in sorted(divs, key=lambda k: (order.get("deq__" + k.split("__", 1)[1],
                                                            len(order)), k)):
            what = "xs = 127 / amax" if scope.startswith("quant") else "scale = sw / xs"
            key = "div_xs" if scope.startswith("quant") else "div_scale"
            print(f"  scale     {scope}: {what} is {'/'.join(sorted(divs[scope]))}  port "
                  f"{port[key]}")
        out.append((name, found, divs, dict(scopes.sites)))
    return out


# `TrainableCraft`'s sums (the sites of models/craft.py `_train_conv`, and
# `_train_sum`'s "up_sum") in JAX's form, as the `hlo` probe reads the CRAFT
# loss's gradient; in the forms before any followed it: cuDNN's bias inside
# every product, ya + yb in bf16; in the forms `TrainableCraft` takes; the
# `hlo` probe's CRAFT sites (the lines of their two frames) by name.
JAX_SITES = {"vgg": "fp32", "fc": "rounded", "up_conv1": "rounded", "up_sum": "fp32",
             "up_conv2": "fp32", "head": "rounded", "head_out": "fp32"}
FUSED_SITES = {"vgg": "fused", "fc": "fused", "up_conv1": "fused", "up_sum": "rounded",
               "up_conv2": "fused", "head": "fused", "head_out": "fused"}
SHIPPED_SITES = {**FUSED_SITES, "head": "rounded", "head_out": "fp32"}
CRAFT_TRAIN_SITES = {(307, 446): "vgg", (307, 457): "fc", (307, 458): "fc",
                     (497, 505): "up_conv1", (500, 505): "up_sum", (307, 508): "up_conv2",
                     (307, 563): "head", (307, 564): "head", (307, 565): "head",
                     (307, 566): "head", (307, 567): "head_out"}
# Leaves whose gradient is zero in exact arithmetic (a conv bias whose sum
# reaches a batch-statistics BatchNorm through linear ops only): rounding
# noise on both sides, left out as tests/test_torch_train_step.py leaves
# them out.
CRAFT_ZERO_GRAD = re.compile(r"(vgg/conv\d_\d/conv|up/upconv\d/conv\d|fc/fc\d)/b$")


def craft_grad_inputs(width, seed=0):
    """(the port's CraftConfig, JAX's CRAFT tree flat, pages, heat) of the
    training records: "tiny" (tests/test_torch_train_step.py's two 64x64
    pages at the tiny configs, JAX's init: zero conv biases) or "full"
    (`evals/production_weights` on chip_smoke phase 7's 128x128 page);
    another `seed` draws other pages the same way."""
    sys.path.insert(0, HERE)
    import gen_torch_train as G

    if width == "tiny":
        from tuatara_tpu.tokenizer import Tokenizer
        from tuatara_tpu.utils.data import detection_batch

        from tuatara_tpu_torch.config import CraftConfig, ParseqConfig

        cfg, _ = G.tiny_configs(CraftConfig, ParseqConfig)
        batch = G.tiny_batch(detection_batch, Tokenizer(), seed)
        return cfg, G.jax_tiny_params()[0], batch["pages"], batch["heat"]
    from tuatara_tpu.utils.weights import flatten_tree, load_weights_dir

    from tuatara_tpu_torch.utils import weights as W

    weights = os.path.join(os.path.dirname(HERE), "evals", "production_weights")
    cfg = W.load_configs(weights)[0]
    batch = G.fullwidth_batch(seed)
    return cfg, flatten_tree(load_weights_dir(weights)[0]), batch["pages"], batch["heat"]


def jax_craft_grads(cfg, flat, pages, heat):
    """JAX's CRAFT loss gradient at its shipped bf16, compiled on the CPU:
    {JAX path: array}."""
    import jax
    import jax.numpy as jnp

    from tuatara_tpu.config import CraftConfig as JaxCraftConfig
    from tuatara_tpu.train.losses import craft_loss
    from tuatara_tpu.utils.weights import flatten_tree, unflatten_tree

    jcfg = JaxCraftConfig(**dataclasses.asdict(cfg))
    tree = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    grads = jax.jit(jax.grad(lambda p: craft_loss(p, pages, heat, cfg=jcfg)[0]))(tree)
    return {k: np.asarray(v, np.float64) for k, v in flatten_tree(grads).items()}


@contextlib.contextmanager
def site_forms(sites):
    """Inside: `TrainableCraft`'s sums at a 16-bit dtype in the forms
    `sites` gives ({site: form}, every site; `up_sum` "fp32" is ya + yb
    summed in fp32), by wrapping models/craft.py `_train_conv` and
    `_train_sum`."""
    from tuatara_tpu_torch.models import craft as TC

    conv, add = TC._train_conv, TC._train_sum

    def site_conv(site, *args, form="fused", **kw):
        return conv(site, *args, form=sites[site], **kw)

    TC._train_conv = site_conv
    if sites["up_sum"] == "fp32":
        TC._train_sum = lambda ya, yb: ya.float() + yb.float()
    try:
        yield
    finally:
        TC._train_conv, TC._train_sum = conv, add


def site_configs():
    """[(name, {site: form})]: the forms before any followed JAX's graph,
    each site alone in JAX's form, the forms the port takes, all in JAX's."""
    configs = [("fused (before)", dict(FUSED_SITES))]
    configs += [(f"{site} -> {form}", {**FUSED_SITES, site: form})
                for site, form in JAX_SITES.items()]
    return configs + [("shipped", dict(SHIPPED_SITES)), ("all in JAX's form", dict(JAX_SITES))]


def port_craft_grads(cfg, flat, pages, heat, sites):
    """The port's CRAFT loss gradient at bf16 on the CPU with
    `TrainableCraft`'s sums in the forms `sites` gives ({JAX path: array},
    JAX's layout)."""
    from tuatara_tpu_torch.models import craft as TC
    from tuatara_tpu_torch.train.losses import craft_loss
    from tuatara_tpu_torch.weights import load_tree, module_leaves, to_jax

    model = load_tree(TC.TrainableCraft(cfg), flat)
    with site_forms(sites):
        loss, _ = craft_loss(model, torch.from_numpy(pages), torch.from_numpy(heat),
                             compute_dtype=torch.bfloat16)
        loss.backward()
    return {p: to_jax(t.grad, layout).astype(np.float64) for p, t, layout in module_leaves(model)
            if t.grad is not None}


def craft_grads(width="full", seeds=(0, 1, 2, 3)):
    """The `craft_grads` probe (ROADMAP Queue 3 item 19): the CRAFT loss's
    gradient before the optimizer, at bf16 on the CPU, the port's against
    JAX's leaf by leaf (relative L2 error; the exactly-zero leaves and the
    running statistics left out), with `TrainableCraft`'s sums in the
    forms before any followed JAX's graph (`FUSED_SITES`), each site alone
    in JAX's form (`JAX_SITES`), the forms the port takes (`SHIPPED_SITES`)
    and all in JAX's, on the pages of each seed (seed 0: the training
    records' own). Prints, for each configuration, the median and mean
    error over the leaves and seeds, and on how many (leaf, seed) pairs it
    is closer to JAX's than the first. A site keeps JAX's form where alone
    it is closer on most pairs and its mean error is lower.
    -> {configuration: [{leaf: error} a seed]}."""
    configs = site_configs()
    out = {name: [] for name, _ in configs}
    for seed in seeds:
        cfg, flat, pages, heat = craft_grad_inputs(width, seed)
        want = jax_craft_grads(cfg, flat, pages, heat)
        keys = sorted(k for k in want if not CRAFT_ZERO_GRAD.search(k)
                      and not k.endswith(("/mean", "/var")))
        for name, sites in configs:
            got = port_craft_grads(cfg, flat, pages, heat, sites)
            out[name].append({k: float(np.linalg.norm(got[k] - want[k])
                                       / max(np.linalg.norm(want[k]), 1e-30)) for k in keys})
    base = out[configs[0][0]]
    for name, _ in configs:
        errs = out[name]
        v = np.array([e for per_seed in errs for e in per_seed.values()])
        closer = sum(e[k] < b[k] for e, b in zip(errs, base) for k in e)
        worst = max(((k, e[k]) for e in errs for k in e), key=lambda kv: kv[1])
        print(f"{width} seeds {list(seeds)} {name:22s} median {np.median(v):.4e} mean "
              f"{v.mean():.4e}, closer than the first on {closer}/{v.size}; worst "
              f"{worst[0]} {worst[1]:.4e}", flush=True)
    return out


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "crop"
    if what == "pages":
        args = sys.argv[2:]
        presets = ("default", "latency")
        if "--preset" in args:
            i = args.index("--preset")
            presets = tuple(args[i + 1].split(","))
            del args[i:i + 2]
        pages_share(next((a for a in args if a != "--attribute"), None), "--attribute" in args,
                    presets)
    elif what == "residual":
        residual_rounding()
    elif what == "hlo":
        hlo_sites()
        int8_sites()
        form = gelu_vjp_form()
        print(f"GELU backward in mlp's gradient (bf16):\n  XLA:  {form}\n  port: "
              f"{GELU_GRAD_FORM}\n  {'same' if form == GELU_GRAD_FORM else 'DIFFERENT'}")
    elif what == "resample":
        resample_residual()
    elif what == "craft_grads":
        for w in sys.argv[2:] or ["tiny", "full"]:
            craft_grads(w)
    else:
        main()
