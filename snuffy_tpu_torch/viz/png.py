"""A PNG writer and reader on zlib and struct alone: 8-bit gray, RGB and
RGBA, in place of `plt.imsave` (the heat maps) and PIL's PNG (the tiler's
`-f png`).

`write_png` stores each row unfiltered (filter type 0) in one zlib
stream; `read_png` decodes what `write_png` writes (8-bit, not
interlaced, unfiltered rows), so a run with neither PIL nor matplotlib
can read its own images back.
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


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of an 8-bit, non-interlaced, unfiltered gray, RGB or RGBA
    PNG (what `encode_png` writes) → (H, W) or (H, W, 3|4) uint8. Other
    kinds raise ValueError."""
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
        raise ValueError("only unfiltered rows (filter type 0), as "
                         "write_png writes them")
    img = raw[:, 1:].reshape(h, w, c).copy()
    return img[..., 0] if c == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
