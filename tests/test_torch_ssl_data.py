"""The port's SSL image streaming against `snuffy_tpu/ssl/data.py`.

The JAX `_decode` opens images with PIL; the port decodes JPEGs with its
libjpeg decoder, PNGs with its zlib reader, and resizes with its numpy
copy of PIL's BILINEAR. Batches are held to the JAX ones bit for bit, in
the same order for a seed; the PNG reader to PIL under each of the five
row filters.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from snuffy_tpu.ssl import data as jdata
from snuffy_tpu_torch.ssl import data
from snuffy_tpu_torch.viz import png


def image_folder(root, n=6, seed=0):
    """Two classes of JPEGs at 32², 48×40 and gray, and PNGs in RGB, RGBA
    and gray (PIL's encoder picks its row filters)."""
    rng = np.random.default_rng(seed)
    for c in ("a", "b"):
        os.makedirs(os.path.join(root, c, "sub"), exist_ok=True)
        for i in range(n):
            h, w = ((32, 32), (48, 40), (20, 36))[i % 3]
            arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            arr = (arr // 4 + np.arange(w, dtype=np.uint8)[None, :, None] * 3)
            kind = i % 4
            if kind == 0:
                Image.fromarray(arr).save(os.path.join(root, c, f"{i}.jpeg"),
                                          quality=75)
            elif kind == 1:
                Image.fromarray(arr[..., 0]).save(
                    os.path.join(root, c, "sub", f"{i}.jpg"))
            elif kind == 2:
                rgba = np.concatenate([arr, arr[..., :1]], axis=-1)
                Image.fromarray(rgba).save(os.path.join(root, c, f"{i}.png"))
            else:
                Image.fromarray(arr[..., 1]).save(
                    os.path.join(root, c, f"{i}.png"))
    return root


def test_decode_is_jaxs_bitwise(tmp_path):
    root = image_folder(str(tmp_path / "imgs"))
    paths, labels = data.list_image_folder(root)
    assert (paths, labels) == jdata.list_image_folder(root)
    assert {os.path.splitext(p)[1] for p in paths} == {".jpeg", ".jpg",
                                                       ".png"}
    for p in paths:
        for size in (32, 24):
            np.testing.assert_array_equal(data.decode(p, size),
                                          jdata._decode((p, size)))


@pytest.mark.parametrize("workers", [0, 3])
def test_batches_are_jaxs_in_order(tmp_path, workers):
    root = image_folder(str(tmp_path / "imgs"), n=7)
    paths, _ = data.list_image_folder(root)
    ours = data.ImageBatcher(paths, 4, 32, num_workers=workers, seed=3)
    theirs = jdata.ImageBatcher(paths, 4, 32, num_workers=0, seed=3)
    assert len(ours) == len(theirs) == 3
    for _ in range(2):                       # a new order each epoch
        got, want = list(ours.epoch()), list(theirs.epoch())
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == np.uint8 and a.shape == (4, 32, 32, 3)
            np.testing.assert_array_equal(a, b)
    ours.close()


def raw_png(img, filters, interlace=0, depth=8):
    """An 8-bit PNG of `img` with row y under filter filters[y % len]."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c).astype(np.int32)
    out, prior = [], np.zeros(w * c, np.int32)
    for y in range(h):
        kind, line = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) >> 1
        else:
            pred = png._paeth(left, prior, upleft)
        out.append(bytes([kind]) + ((line - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prior = line

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (png.SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_png_reader_matches_pil_under_each_filter(channels, filters):
    rng = np.random.default_rng(channels)
    shape = (9, 13) if channels == 1 else (9, 13, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    blob = raw_png(img, filters)
    want = np.asarray(Image.open(io.BytesIO(blob)))
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(png.decode_png(blob), img)


def test_png_reader_refuses_other_kinds(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="interlace 1"):
        png.decode_png(raw_png(img, (0,), interlace=1))
    sixteen = tmp_path / "deep.png"
    Image.fromarray(np.full((4, 4), 4000, np.uint16)).save(sixteen)
    palette = tmp_path / "pal.png"
    Image.fromarray(img).convert("P").save(palette)
    for path in (sixteen, palette):
        with pytest.raises(ValueError, match=str(path)):
            data.decode(str(path), 4)
