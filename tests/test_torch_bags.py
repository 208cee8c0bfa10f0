"""The port's bag loaders against the JAX package's.

`native.parse_bag_csv_fast` (the port's strtof parser) is held bit for bit
to `snuffy_tpu.native.parse_bag_csv_fast`, and refuses a bag over its row
cap where the JAX parser returns the first rows. The JAX parser's library
builds in place at first use, and parallel test processes race on that
build: the `jax_native` fixture waits for a library that loads whichever
process built it, and fails (never skips) if none does. `load_split` is held to
the JAX `load_split` on the per-bag CSVs the port's `extract_dataset`
writes, feature-only and with label/position columns: the same bags,
rows in the same order, feats bit for bit.
"""

import fcntl
import os
import tempfile
import time

import numpy as np
import pandas as pd
import pytest
import torch

from snuffy_tpu.data.bags import load_split as jax_load_split
from snuffy_tpu_torch import native
from snuffy_tpu_torch.data.bags import load_split
from snuffy_tpu_torch.embed.pipeline import extract_dataset


def load_jax_native(mp: pytest.MonkeyPatch, seconds: float = 300.0):
    """`snuffy_tpu.native`'s library, or None after `seconds`. Another
    process may be building or writing `libsnuffy_native.so` when this one
    first asks, and the JAX module then remembers the failure for the
    whole process (`_build_failed`): under a lock that keeps the test
    processes to one build at a time, clear the flag (by `mp`) and ask
    again until a complete library loads."""
    from snuffy_tpu import native as jax_mod

    lock_path = os.path.join(tempfile.gettempdir(),
                             "snuffy_tpu_native_build.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + seconds
            lib = jax_mod.get_lib()
            while lib is None and time.monotonic() < deadline:
                time.sleep(1.0)
                mp.setattr(jax_mod, "_build_failed", False)
                lib = jax_mod.get_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


@pytest.fixture(scope="module")
def jax_native():
    """`snuffy_tpu.native` with its library loaded (`load_jax_native`), or
    the test fails."""
    from snuffy_tpu import native as jax_mod

    with pytest.MonkeyPatch.context() as mp:
        if load_jax_native(mp) is None:
            pytest.fail(f"snuffy_tpu.native could not build or load "
                        f"{jax_mod._SO} within 300 s")
        yield jax_mod


def write(path, text):
    with open(path, "w", newline="") as f:
        f.write(text)
    return str(path)


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name, text", [
    ("plain", None),
    ("crlf", "0,1,2\r\n1.5,-2.25e-3,7\r\n\r\n3,4,5\r\n"),
    ("extremes", "0,1,2\n3.4028235e38,-1.1754944e-38,1e-45\n-0,nan,-inf\n"
                 "0x1p-3, 2.5 ,x\n"),
    ("ragged", "0,1,2\n1,2\n3,4,5\n\n6\n"),
    ("no newline at the end", "0,1\n1.25,2.5\n3.75,5"),
    ("header only", "0,1,2\n"),
])
def test_parse_bag_csv_fast_is_jaxs_bitwise(tmp_path, jax_native, name,
                                            text):
    if text is None:
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((300, 24))
             * 10.0 ** rng.integers(-12, 12, (300, 24))).astype(np.float32)
        text = ",".join(map(str, range(24))) + "\n" + "".join(
            ",".join(np.format_float_positional(v) if i % 2 else repr(
                float(v)) for i, v in enumerate(row)) + "\n" for row in x)
    path = write(tmp_path / "bag.csv", text)
    got, want = native.parse_bag_csv_fast(path), \
        jax_native.parse_bag_csv_fast(path)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(bits(got), bits(want))


def test_parse_bag_csv_fast_refuses_a_bag_over_the_row_cap(tmp_path,
                                                           jax_native):
    text = "0,1\n" + "".join(f"{i},{i / 7}\n" for i in range(50))
    path = write(tmp_path / "bag.csv", text)
    assert jax_native.parse_bag_csv_fast(path, max_rows=40).shape == (40, 2)
    with pytest.raises(ValueError, match="over the cap of 40"):
        native.parse_bag_csv_fast(path, max_rows=40)
    assert native.parse_bag_csv_fast(path, max_rows=50).shape == (50, 2)
    wide = write(tmp_path / "wide.csv", "0,1\n1,2\n3,4,5\n")
    with pytest.raises(ValueError, match="wider|cells"):
        native.parse_bag_csv_fast(wide)


class TinyEmbedder(torch.nn.Module):
    """uint8 tiles (m, 32, 32, 3) → (m, 12) f32: 8×8 block means through a
    seeded linear map; stands in for the ViT."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(48, 12)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            self.proj.weight.copy_(torch.randn(12, 48, generator=gen))

    def forward(self, tiles):
        x = tiles.float().reshape(-1, 4, 8, 4, 8, 3).mean(dim=(2, 4))
        return self.proj(x.reshape(len(x), 48) / 255.0), None


def jpeg_tree(root):
    """<root>/single/fold1/{train,test}/{0_normal,1_tumor}/<slide>/c_r.jpeg:
    8 slides of 5-23 tiles, and the headerless tile-label CSV."""
    rng = np.random.default_rng(1)
    labels = []
    for s in range(8):
        split, cls = ("train", "test")[s % 2], ("0_normal", "1_tumor")[s // 4]
        slide = f"slide_{s}"
        d = os.path.join(root, "single", "fold1", split, cls, slide)
        os.makedirs(d)
        for t in range(int(rng.integers(5, 24))):
            tile = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            native.write_jpeg(os.path.join(d, f"{t % 6}_{t // 6}.jpeg"),
                              tile, quality=90)
            labels.append(f"{slide}_{t % 6}_{t // 6},{int(t % 3 == 0)}")
    return write(os.path.join(root, "tile_label.csv"),
                 "\n".join(labels) + "\n")


@pytest.mark.parametrize("labelled", [False, True])
@pytest.mark.parametrize("num_classes", [1, 2])
def test_load_split_matches_jax_on_extract_dataset_csvs(tmp_path, labelled,
                                                        num_classes):
    tile_labels = jpeg_tree(str(tmp_path / "data"))
    rows = extract_dataset(
        TinyEmbedder().eval(), str(tmp_path / "data"), "fold1",
        str(tmp_path / "out"), class_labels={"0_normal": 0, "1_tumor": 1},
        tile_label_csv=tile_labels if labelled else None, batch_size=8,
        img_size=32)
    assert len(rows) == 8
    got = load_split(rows, num_classes, use_mp=False, seed=3)
    want = jax_load_split(pd.DataFrame(rows, columns=["0", "label"]),
                          num_classes, use_mp=False, seed=3)
    assert len(got.labels) == len(want) == 8
    assert got.slide_names == want.slide_names
    for a, b in zip(got.labels, want.labels):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.feats, want.feats):
        assert a.shape == b.shape and a.shape[1] == 12
        np.testing.assert_array_equal(bits(a), bits(b))
    if not labelled:
        assert got.feats_labels is got.positions is want.feats_labels is None
        return
    for a, b in zip(got.feats_labels, want.feats_labels):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.positions == [list(p) for p in want.positions]


def test_load_split_pool_gives_the_serial_bags(tmp_path):
    rng = np.random.default_rng(2)
    rows = []
    for i in range(3):
        path = tmp_path / f"bag_{i}.csv"
        x = rng.standard_normal((10 + i, 4)).astype(np.float32)
        write(path, "0,1,2,3\n" + "".join(
            ",".join(map(repr, map(float, r))) + "\n" for r in x))
        rows.append((str(path), i % 2))
    serial = load_split(rows, 1, use_mp=False, seed=5)
    pooled = load_split(rows, 1, num_processes=2, use_mp=True, seed=5)
    for a, b in zip(serial.feats, pooled.feats):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no bags"):
        load_split([], 1)
