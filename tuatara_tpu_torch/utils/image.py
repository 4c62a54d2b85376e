"""PNG reading and writing with the standard library and numpy.

The engine's input contract is an [H, W, 3] uint8 RGB array (or [H, W]
grayscale). This reader covers the PNGs the repo ships: 8-bit samples,
non-interlaced, colour types gray (0), RGB (2), gray+alpha (4) and RGBA (6),
scanline filters 0-4. It converts like PIL's `convert("RGB")`: gray is
tripled and alpha is dropped, so the port reads the same pixels as the JAX
package's `load_image` without needing PIL.

`save_image` writes 8-bit gray, RGB or RGBA PNGs (filter 0). `annotate`
renders results as three side-by-side panels, as the JAX package's does:
the page with green boxes, the boxes on white, and the reading order. With
no font renderer (no PIL), a word's text is drawn as a dark bar inside its
box, one bar a character, and the third panel lists the words as such bars
in reading order.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# The repo's test pages, after $TUATARA_IMAGES when that is set.
_REPO_IMAGES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "images")


def asset_path(name: str) -> str:
    """A test page's file name (e.g. "resume_example.png") -> its path, from
    $TUATARA_IMAGES or the repo's images/ (JAX `utils.image.asset_path`).
    Raises FileNotFoundError naming the directories searched."""
    dirs = [d for d in (os.environ.get("TUATARA_IMAGES", ""), _REPO_IMAGES) if d]
    for d in dirs:
        path = os.path.join(d, name)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"test image {name!r} not found in any of {dirs}")


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, C] uint8 with the file's own channels."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} (8-bit non-interlaced gray/RGB/RGBA only)")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG data length does not match its header")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    filters = rows[:, 0]
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        line = rows[y, 1:]
        f = filters[y]
        if f == 0:
            cur = line.copy()
        elif f == 1:  # Sub: a running sum along the row, per channel
            cur = (np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint64)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif f == 2:  # Up
            cur = line + prev
        elif f in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if f == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {f} in row {y}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, bpp)


def load_image(path: str, keep_gray: bool = False) -> np.ndarray:
    """Read a PNG -> [H, W, 3] uint8 RGB (gray tripled, alpha dropped), or
    [H, W] uint8 for a gray file when `keep_gray` is set."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    c = img.shape[2]
    if c in (1, 2):  # gray, gray+alpha
        g = img[:, :, 0]
        return g.copy() if keep_gray else np.repeat(g[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def encode_png(image: np.ndarray) -> bytes:
    """[H, W] / [H, W, 1|3|4] uint8 -> PNG bytes (8-bit, filter 0)."""
    a = np.asarray(image, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    kind = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, kind, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def save_image(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def reading_order(results: List[Dict]) -> List[Dict]:
    """Results sorted by (y, x) of the bbox's top-left corner."""
    return sorted(results, key=lambda r: (r["bbox"][1], r["bbox"][0]))


def _rect(panel: np.ndarray, box, color, width: int) -> None:
    h, w = panel.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in box)
    x0, x1 = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
    y0, y1 = max(min(y0, y1), 0), min(max(y0, y1), h - 1)
    if x0 > x1 or y0 > y1:
        return
    panel[y0:y0 + width, x0:x1 + 1] = color
    panel[max(y1 - width + 1, y0):y1 + 1, x0:x1 + 1] = color
    panel[y0:y1 + 1, x0:x0 + width] = color
    panel[y0:y1 + 1, max(x1 - width + 1, x0):x1 + 1] = color


def _text_bars(panel: np.ndarray, x: int, y: int, text: str, char_w: int, char_h: int,
               x_end: int) -> None:
    """One dark bar a non-space character, left to right from (x, y)."""
    h = panel.shape[0]
    for i, ch in enumerate(text):
        cx = x + i * char_w
        if cx + char_w - 1 > x_end:
            break
        if not ch.isspace():
            panel[max(y, 0):min(y + char_h, h), cx:cx + char_w - 1] = 40


def annotate(image: np.ndarray, results: List[Dict]) -> np.ndarray:
    """[H, W, 3] uint8 page + results -> [H, 3W, 3] uint8 render: the page
    with green boxes, each box on white holding its text as character
    bars, and the words in reading order as bars down the third panel."""
    page = np.asarray(image, np.uint8)
    if page.ndim == 2:
        page = page[..., None]
    if page.shape[-1] == 1:
        page = np.repeat(page, 3, axis=-1)
    h, w = page.shape[:2]
    boxes, text = page.copy(), np.full_like(page, 255)
    listing = np.full_like(page, 255)
    ordered = reading_order(results)
    for r in ordered:
        _rect(boxes, r["bbox"], (0, 200, 0), 2)
        _rect(text, r["bbox"], (220, 220, 220), 1)
        x0, y0, x1, y1 = (int(v) for v in r["bbox"])
        n = max(len(r["text"]), 1)
        _text_bars(text, x0 + 1, y0 + 2, r["text"], max((x1 - x0 - 2) // n, 2),
                   max(y1 - y0 - 4, 1), x1 - 1)
    y = 4
    for r in ordered:
        if y > h - 12:
            break
        _text_bars(listing, 4, y, r["text"], 6, 8, w - 4)
        y += 12
    return np.concatenate([boxes, text, listing], axis=1)
