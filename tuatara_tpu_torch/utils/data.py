"""Training data and ground truth: the port's own copy of
`tuatara_tpu/utils/data.py`.

* `render_word` / `word_batch` / `render_word_gray` / `word_pool`: rendered
  word crops for the recognizer with encoded labels; `synthetic_text_pages`:
  rendered text pages with heat targets and ground truth. These render with
  PIL, imported inside the functions that draw, as the JAX package does.
* `gaussian_heatmap_targets` / `detection_batch`: CRAFT's region/affinity
  targets and synthetic bar pages, numpy only (the card's machine needs no
  PIL for them).
* `load_funsd_annotations`: ground truth for `utils/metrics.py`.

Given the same `np.random.Generator`, every generator here draws in the
JAX package's order and returns the same arrays, bit for bit.
"""

from __future__ import annotations

import functools
import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tuatara_tpu_torch.tokenizer import Tokenizer


@functools.lru_cache(maxsize=1)
def system_fonts() -> Tuple[str, ...]:
    """Scalable .ttf fonts available for the "font" render style.

    The bitmap default (PIL's built-in ~7x11 font) caps legibility — 'O'/'0'
    and 'l'/'I'/'1' are near-ambiguous at that size, which floors the
    achievable recognizer accuracy. TrueType rendering at realistic glyph
    sizes (DejaVu Sans/Serif/Mono + bolds ship in this image) is both more
    legible and more varied, so it is the production-training style
    of the JAX package's training scripts. Returns () when no
    fonts are installed; callers must then fall back to "bitmap"."""
    roots = ("/usr/share/fonts", "/usr/local/share/fonts",
             os.path.expanduser("~/.fonts"))
    found: List[str] = []
    for r in roots:
        found.extend(sorted(glob.glob(os.path.join(r, "**", "*.ttf"),
                                      recursive=True)))
    return tuple(found)


@functools.lru_cache(maxsize=256)
def _load_font(path: str, size: int):
    from PIL import ImageFont

    return ImageFont.truetype(path, size)


def render_word_gray(
    text: str,
    rng: np.random.Generator,
    height: int = 32,
    width: int = 128,
) -> np.ndarray:
    """TrueType-render one word -> [height, width] uint8 grayscale, NO
    photometric augmentation — the fast pool-renderer core (~2x the RGB
    float path). Random font from `system_fonts`, random size
    16-40 px, tight-cropped with per-side margins proportional to glyph
    height (uniform [-0.18h, +0.27h] — the detector-box margin
    distribution measured at h=11 scaled to every size). Photometrics
    (contrast/brightness/noise/uint8-snap) are applied on DEVICE per step
    (train.run.augment_gray_u8) so a pool entry shows different pixels
    every epoch — re-randomized photometrics block the pixel-level
    memorization a fixed float pool invites."""
    from PIL import Image, ImageDraw

    fonts = system_fonts()
    if not fonts:
        raise RuntimeError("TrueType rendering requires installed .ttf "
                           "fonts (system_fonts() found none)")
    size = int(rng.integers(16, 41))
    font = _load_font(fonts[int(rng.integers(0, len(fonts)))], size)
    pad = size  # generous canvas; we crop to textbbox below
    w0 = int(font.getlength(text)) + 2 * pad
    img = Image.new("L", (max(w0, 2 * pad + 2), 3 * size), 255)
    d = ImageDraw.Draw(img)
    d.text((pad, pad), text, fill=0, font=font)
    x0, y0, x1, y1 = d.textbbox((pad, pad), text, font=font)
    h = max(y1 - y0, 1)
    ml, mt, mr, mb = (int(round(v)) for v in
                      rng.uniform(-0.18, 0.27, 4) * h)
    if (x1 + mr) - (x0 - ml) < 2:
        ml, mr = 1, 1
    if (y1 + mb) - (y0 - mt) < 2:
        mt, mb = 1, 1
    img = img.crop((x0 - ml, y0 - mt, x1 + mr, y1 + mb)).resize(
        (width, height), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def word_pool(
    n: int,
    tokenizer: Tokenizer,
    rng: np.random.Generator,
    max_length: int = 25,
    min_len: int = 1,
    max_len: int = 12,
    charset: Optional[str] = None,
    out: Optional[Dict[str, np.ndarray]] = None,
    start: int = 0,
    width: int = 128,
) -> Dict[str, np.ndarray]:
    """Render n TrueType word crops into a compact uint8-grayscale pool:
    {"crops_u8" [n,32,width] uint8, "labels" [n,L+2] i32, "lengths" [n] i32}.

    12x smaller than `word_batch`'s float RGB output — the format the
    production trainer keeps host-side and refreshes from a background
    thread. Pass `out` (+ `start`) to
    overwrite rows of an existing pool in place (the refresher path).
    `width` follows the serving crop geometry (OcrConfig.rec_width /
    ParseqConfig.img_size — e.g. 64 for the half-width serving preset)."""
    pool_chars = charset or tokenizer.charset[:62]
    if out is None:
        out = {
            "crops_u8": np.zeros((n, 32, width), np.uint8),
            "labels": np.zeros((n, max_length + 2), np.int32),
            "lengths": np.zeros((n,), np.int32),
        }
    for i in range(n):
        k = int(rng.integers(min_len, max_len + 1))
        text = "".join(pool_chars[int(j)]
                       for j in rng.integers(0, len(pool_chars), k))
        ids, ln = tokenizer.encode(text, max_length)
        j = start + i
        out["crops_u8"][j] = render_word_gray(text, rng, width=width)
        out["labels"][j] = ids
        out["lengths"][j] = ln
    return out


def render_word(
    text: str,
    rng: np.random.Generator,
    height: int = 32,
    width: int = 128,
    tight: bool = False,
    style: str = "bitmap",
) -> np.ndarray:
    """Render one word -> [height, width, 3] float32 in [0, 1].

    `tight=False` (default): draw at native bitmap-font size with position
    jitter inside the canvas — the cheap smoke-train recipe.
    `tight=True`: draw at native size, crop to the text's bounding box with
    independent random per-side margins in [-2, 3] px — the margin
    distribution MEASURED from the trained detector's boxes on rendered
    pages (mean +-0.5 px, up to 2 px of padding and up to 2 px of glyph
    CLIPPING per side) — then resize to [height, width], the geometry the
    serving pipeline produces (a detected word box stretched to the
    recognizer's 32x128 input, ops/warp.extract_crops). Training under the
    detector's actual margin distribution is what closes the word-level ->
    end-to-end accuracy gap (symmetric 0-7 px margins left a 6.5% -> 22%
    CER cliff on engine-extracted crops).

    `style="font"`: TrueType rendering (random system font, random size
    16-40 px) instead of the tiny bitmap font — the production-training
    style (see `system_fonts`). Always tight-cropped, with per-side margins
    drawn PROPORTIONAL to glyph height (uniform in [-0.18h, +0.27h]) so the
    detector-box margin distribution the bitmap path measured at h=11
    (+-2-3 px) covers every rendered size."""
    from PIL import Image, ImageDraw

    if style == "font":
        gray = render_word_gray(text, rng, height, width)
        arr = gray.astype(np.float32) / 255.0
        arr = arr * rng.uniform(0.6, 1.0) + rng.uniform(0.0, 0.3)
        arr = np.clip(arr + rng.normal(0, 0.03, arr.shape), 0, 1)
        arr = np.round(arr * 255.0) / 255.0
        return np.repeat(arr[..., None], 3, axis=-1).astype(np.float32)
    elif not tight:
        img = Image.new("L", (width, height), 255)
        d = ImageDraw.Draw(img)
        # Default bitmap font; jitter position and scale via resize.
        d.text((int(rng.integers(2, 12)), int(rng.integers(2, 12))), text,
               fill=0)
    else:
        # Native-size canvas with margin, then bbox-crop + resize.
        pad = 12
        w0 = 7 * max(len(text), 1) + 2 * pad
        img = Image.new("L", (w0, 11 + 2 * pad), 255)
        d = ImageDraw.Draw(img)
        d.text((pad, pad), text, fill=0)
        x0, y0, x1, y1 = d.textbbox((pad, pad), text)
        ml, mt, mr, mb = (int(v) for v in rng.integers(-2, 4, 4))
        # clipping margins must never invert a narrow glyph's box
        if (x1 + mr) - (x0 - ml) < 2:
            ml, mr = 1, 1
        if (y1 + mb) - (y0 - mt) < 2:
            mt, mb = 1, 1
        img = img.crop((x0 - ml, y0 - mt, x1 + mr, y1 + mb)).resize(
            (width, height), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    # random contrast/brightness + noise
    arr = arr * rng.uniform(0.6, 1.0) + rng.uniform(0.0, 0.3)
    arr = np.clip(arr + rng.normal(0, 0.03, arr.shape), 0, 1)
    # snap to the uint8 grid: serving crops are gathered from uint8 pages
    # (/255), so training off-grid values would be a (small) domain shift
    arr = np.round(arr * 255.0) / 255.0
    return np.repeat(arr[..., None], 3, axis=-1).astype(np.float32)


def word_batch(
    n: int,
    tokenizer: Tokenizer,
    rng: np.random.Generator,
    max_length: int = 25,
    min_len: int = 1,
    max_len: int = 8,
    charset: Optional[str] = None,
    tight: bool = False,
    style: str = "bitmap",
    width: int = 128,
) -> Dict[str, np.ndarray]:
    """Random word crops + encoded labels for PARSEQ training.

    Returns {"crops" [n,32,width,3], "labels" [n,max_length+2],
    "lengths" [n], "texts" list[str]}.
    """
    # Default pool: alphanumerics (robust to tiny-font rendering).
    pool = charset or tokenizer.charset[:62]
    texts, crops, labels, lengths = [], [], [], []
    for _ in range(n):
        k = int(rng.integers(min_len, max_len + 1))
        text = "".join(pool[int(i)] for i in rng.integers(0, len(pool), k))
        ids, ln = tokenizer.encode(text, max_length)
        texts.append(text)
        crops.append(render_word(text, rng, tight=tight, style=style,
                                 width=width))
        labels.append(ids)
        lengths.append(ln)
    return {
        "crops": np.stack(crops),
        "labels": np.stack(labels).astype(np.int32),
        "lengths": np.asarray(lengths, np.int32),
        "texts": texts,
    }


def gaussian_heatmap_targets(
    boxes: Sequence[Sequence[float]],
    char_counts: Sequence[int],
    height: int,
    width: int,
) -> np.ndarray:
    """CRAFT-style [height, width, 2] region/affinity targets at heatmap
    resolution from word boxes [(x0, y0, x1, y1)] in heatmap coordinates.

    Each word is split into `char_counts[i]` equal character slots; a
    Gaussian splat per slot builds the region channel, one between adjacent
    slot centers builds the affinity channel.
    """
    target = np.zeros((height, width, 2), np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)

    def splat(cx, cy, sx, sy, ch):
        g = np.exp(-(((xx - cx) / max(sx, 1e-3)) ** 2 + ((yy - cy) / max(sy, 1e-3)) ** 2))
        np.maximum(target[:, :, ch], g, out=target[:, :, ch])

    for (x0, y0, x1, y1), k in zip(boxes, char_counts):
        k = max(int(k), 1)
        w = (x1 - x0) / k
        cy = (y0 + y1) / 2
        sy = (y1 - y0) / 3
        centers = [(x0 + (i + 0.5) * w, cy) for i in range(k)]
        for cx, cyy in centers:
            splat(cx, cyy, w / 2.5, sy, 0)
        for (ax, ay), (bx, by) in zip(centers[:-1], centers[1:]):
            splat((ax + bx) / 2, (ay + by) / 2, w / 2.5, sy, 1)
    return target


def detection_batch(
    b: int,
    rng: np.random.Generator,
    size: int = 64,
    words_per_page: int = 3,
) -> Dict[str, np.ndarray]:
    """Synthetic detection pages + heatmap targets for CRAFT training.

    Pages are white with dark word-bars at the box locations; targets are
    Gaussian splats at half resolution. Returns {"pages" [b,size,size,3],
    "heat" [b,size/2,size/2,2]}.
    """
    pages = np.ones((b, size, size, 3), np.float32)
    heats = np.zeros((b, size // 2, size // 2, 2), np.float32)
    for i in range(b):
        boxes, counts = [], []
        for _ in range(words_per_page):
            w = int(rng.integers(12, 28))
            h = int(rng.integers(5, 9))
            x0 = int(rng.integers(0, size - w))
            y0 = int(rng.integers(0, size - h))
            pages[i, y0:y0 + h, x0:x0 + w] = rng.uniform(0.0, 0.3)
            boxes.append((x0 / 2, y0 / 2, (x0 + w) / 2, (y0 + h) / 2))
            counts.append(max(w // 6, 1))
        heats[i] = gaussian_heatmap_targets(boxes, counts, size // 2, size // 2)
        pages[i] = np.clip(pages[i] + rng.normal(0, 0.02, pages[i].shape), 0, 1)
    return {"pages": pages, "heat": heats}


def synthetic_text_pages(
    b: int,
    tokenizer: Tokenizer,
    rng: np.random.Generator,
    size: int = 256,
    words_per_page: int = 8,
    min_len: int = 2,
    max_len: int = 8,
    charset: Optional[str] = None,
    upscale: int = 1,
    style: str = "bitmap",
) -> Dict:
    """Labeled synthetic TEXT pages: real rendered glyphs, heat targets,
    and per-page ground truth — the full train->eval substrate.

    Unlike `detection_batch` (featureless dark bars), every word here is
    actual PIL-rendered text, so a detector trained on these pages must
    localize glyph patterns and the words can then be READ by a trained
    recognizer and scored with utils/metrics.evaluate_engine.

    Words are placed non-overlapping with a separation margin (CRAFT's
    per-component dilation merges close components; the margin keeps the
    ground-truth box count meaningful). `upscale` renders glyphs at native
    bitmap size on a size/upscale canvas and bilinearly upscales — larger
    apparent font without needing scalable fonts.

    Returns {"pages" [b,S,S,3] float32 0..1, "heat" [b,S/2,S/2,2],
    "truths" list[b] of [{text, bbox}]} with bboxes in page pixels.

    `style="font"` draws each word in a random TrueType font at a random
    size (10-22 px on the base canvas; see `system_fonts`) instead of the
    tiny bitmap font — the production-training style, matching
    `render_word(style="font")` crops.
    """
    from PIL import Image, ImageDraw

    pool = charset or tokenizer.charset[:62]
    fonts = system_fonts() if style == "font" else ()
    if style == "font" and not fonts:
        raise RuntimeError("style='font' requires installed .ttf fonts")
    base = size // upscale
    pages = np.ones((b, size, size, 3), np.float32)
    heats = np.zeros((b, size // 2, size // 2, 2), np.float32)
    truths: List[List[Dict]] = []
    sep = 6  # min gap between word boxes, base-canvas pixels
    for i in range(b):
        img = Image.new("L", (base, base), 255)
        d = ImageDraw.Draw(img)
        occupied: List[Tuple[float, float, float, float]] = []
        boxes, counts, truth = [], [], []
        for _ in range(words_per_page):
            k = int(rng.integers(min_len, max_len + 1))
            text = "".join(pool[int(j)] for j in rng.integers(0, len(pool), k))
            font = None
            if fonts:
                font = _load_font(fonts[int(rng.integers(0, len(fonts)))],
                                  int(rng.integers(10, 23)))
            x0t, y0t, x1t, y1t = d.textbbox((0, 0), text, font=font)
            w, h = x1t - x0t, y1t - y0t
            if w + 2 * sep >= base or h + 2 * sep >= base:
                continue
            for _try in range(25):
                x = int(rng.integers(sep, base - w - sep))
                y = int(rng.integers(sep, base - h - sep))
                cand = (x - sep, y - sep, x + w + sep, y + h + sep)
                if all(cand[2] < o[0] or cand[0] > o[2] or
                       cand[3] < o[1] or cand[1] > o[3] for o in occupied):
                    break
            else:
                continue
            occupied.append(cand)
            d.text((x - x0t, y - y0t), text, fill=0, font=font)
            bbox = [float(v * upscale) for v in (x, y, x + w, y + h)]
            truth.append({"text": text, "bbox": bbox})
            boxes.append(tuple(v / 2 for v in bbox))
            counts.append(len(text))
        if upscale > 1:
            img = img.resize((size, size), Image.BILINEAR)
        heats[i] = gaussian_heatmap_targets(boxes, counts, size // 2, size // 2)
        arr = np.asarray(img, np.float32) / 255.0
        arr = np.clip(arr + rng.normal(0, 0.02, arr.shape), 0, 1)
        pages[i] = np.repeat(arr[..., None], 3, axis=-1)
        truths.append(truth)
    return {"pages": pages, "heat": heats, "truths": truths}


def load_funsd_annotations(path: str, level: str = "word") -> List[Dict]:
    """One FUNSD annotation file ({"form": [{"text", "box": [x0, y0, x1,
    y1], "words": [{"text", "box"}, ...]}, ...]}) -> [{"text", "bbox"}] at
    `level`: "word" (one entry a word, what the engine emits) or "entity"
    (one a form field, for line-level output). Entries with empty text
    (checkboxes, empty fields) are dropped."""
    with open(path) as f:
        form = json.load(f)["form"]
    out: List[Dict] = []
    if level == "word":
        for field in form:
            for wrd in field.get("words", []):
                if wrd.get("text", "").strip():
                    out.append({"text": wrd["text"], "bbox": [float(v) for v in wrd["box"]]})
    elif level == "entity":
        for field in form:
            if field.get("text", "").strip():
                out.append({"text": field["text"], "bbox": [float(v) for v in field["box"]]})
    else:
        raise ValueError(f"level must be 'word' or 'entity', got {level!r}")
    return out
