"""PNG reader for the benchmark's source pages.

Frozen copy of `decode_png` and its helpers from
`tuatara_tpu_torch/utils/image.py` at commit d849d6a (8-bit, non-interlaced
gray, gray+alpha, RGB, RGBA; filters 0-4), so that the traffic the
benchmark generates does not change when the program's reader does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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
