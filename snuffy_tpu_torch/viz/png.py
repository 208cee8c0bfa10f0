"""A PNG writer and reader on zlib and struct alone: 8-bit gray, RGB and
RGBA, in place of `plt.imsave` (the heat maps) and PIL's PNG (the tiler's
`-f png`).

`write_png` stores each row unfiltered (filter type 0) in one zlib
stream. `read_png` decodes any 8-bit, non-interlaced gray, RGB or RGBA
PNG, each row under any of the five filters (none, Sub, Up, Average,
Paeth), so a run with neither PIL nor matplotlib reads its own images
back, and the SSL image folders' PNGs (`ssl/data.py`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels → PNG colour type
COLOR_TYPES = {1: 0, 3: 2, 4: 6}
CHANNELS = {v: k for k, v in COLOR_TYPES.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """(H, W) gray or (H, W, 1|3|4) uint8 → the bytes of a PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"an 8-bit image, not {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[2] not in COLOR_TYPES:
        raise ValueError(f"(H, W) or (H, W, 1|3|4), not {image.shape}")
    h, w, c = image.shape
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0                                   # filter type: none
    rows[:, 1:] = image.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPES[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor, element-wise on int arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered rows → (h, stride) bytes, by the PNG
    specification's reconstruction of filter types 0-4 (bpp bytes a
    pixel). Sub, Average and Paeth run along the row a pixel at a time."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:].astype(np.int32)
        if kind == 0:
            row = line
        elif kind == 2:
            row = (line + prior) & 0xFF
        elif kind in (1, 3, 4):
            row = line.copy()
            for x in range(0, stride, bpp):
                a = row[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prior[x:x + bpp]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = (prior[x - bpp:x] if x
                         else np.zeros(bpp, np.int32))
                    pred = _paeth(a, b, c)
                row[x:x + bpp] = (row[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"row {y}: unknown PNG filter type {kind}")
        out[y] = prior = row
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of an 8-bit, non-interlaced gray, RGB or RGBA PNG, rows
    under any of the five filters → (H, W) or (H, W, 3|4) uint8. Other
    kinds (palette, gray + alpha, 16-bit, interlaced) raise ValueError."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("a PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in CHANNELS or interlace:
        raise ValueError(f"only 8-bit non-interlaced gray/RGB/RGBA, not "
                         f"depth {depth}, colour type {color}, interlace "
                         f"{interlace}")
    c = CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    if raw[:, 0].any():
        rows = _unfilter(raw, c)
    else:
        rows = raw[:, 1:]
    img = rows.reshape(h, w, c).copy()
    return img[..., 0] if c == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
