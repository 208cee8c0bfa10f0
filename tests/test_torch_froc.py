"""The port's Camelyon16 FROC (`snuffy_tpu_torch.eval.froc`, the
`froc.py` CLI) against `snuffy_tpu.eval.froc`.

Evaluation masks and ITC sets equal, and curves and scores exactly equal
on the same detections, through in-memory readers; the port's
`NativeMaskReader` against the JAX one on a multi-page mask written with
the port's label writer (the JAX reader opens `snuffy_tpu.native.
NativeSlide`, pointed here at the port's reader, so no test builds the
JAX package's library); `EvalMaskCache` with the three faults of its JAX
original fixed (one npz per mask after a re-export, no temporary file
after a failed write); and the CLI: the JAX CLI's score, and `--result`
bytes equal to pandas'.
"""

import os

import numpy as np
import pandas as pd
import pytest

import froc as root_froc
from snuffy_tpu import native as jax_native
from snuffy_tpu.eval import froc as jax_froc
from snuffy_tpu_torch import froc as froc_cli
from snuffy_tpu_torch import native
from snuffy_tpu_torch.eval import froc


@pytest.fixture
def jax_uses_the_port_reader(monkeypatch):
    monkeypatch.setattr(jax_native, "NativeSlide", native.NativeSlide)
    monkeypatch.setattr(jax_native, "available", lambda: True)


def random_mask(seed, shape=(160, 200), blobs=6, itcs=3):
    """A level-5-like label image: blobs of tumour (2), a few 1-pixel
    ITCs, a ring with a hole, background 0 and other labels (1)."""
    rng = np.random.default_rng(seed)
    arr = np.zeros(shape, np.uint8)
    arr[rng.random(shape) < 0.05] = 1
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    for _ in range(blobs):
        cy, cx = rng.integers(10, shape[0] - 10), rng.integers(10, shape[1]
                                                               - 10)
        ry, rx = rng.integers(3, 14, 2)
        arr[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 2
    for _ in range(itcs):
        arr[rng.integers(0, shape[0]), rng.integers(0, shape[1])] = 2
    arr[60:80, 60:80] = 2
    arr[65:75, 65:75] = 0
    return arr


def readers(arr, down=32.0, spacing=0.243):
    lv = {5: (arr, down, spacing)}
    return (froc.ArrayMaskReader({k: froc.MaskLevel(*v)
                                  for k, v in lv.items()}),
            jax_froc.ArrayMaskReader({k: jax_froc.MaskLevel(*v)
                                      for k, v in lv.items()}))


@pytest.mark.parametrize("seed, spacing", [(0, 0.243), (1, 0.5), (2, 2.0),
                                           (3, 0.243)])
@pytest.mark.parametrize("include_itcs", [False, True])
def test_evaluation_masks_and_itcs_equal_jax(seed, spacing, include_itcs):
    ours, theirs = readers(random_mask(seed), spacing=spacing)
    ev, itcs = froc.compute_evaluation_mask(ours, 5, include_itcs)
    want_ev, want_itcs = jax_froc.compute_evaluation_mask(theirs, 5,
                                                          include_itcs)
    np.testing.assert_array_equal(ev, want_ev)
    assert itcs == want_itcs
    assert include_itcs or itcs
    n = int(ev.max())
    np.testing.assert_array_equal(froc.major_axis_lengths(ev, n),
                                  jax_froc.major_axis_lengths(ev, n))


def detections(seed, shape, down, n=60):
    rng = np.random.default_rng(seed)
    ps = np.round(rng.random(n), 3)        # ties across slides
    ys = rng.integers(-2, shape[0] + 2, n) * down
    xs = rng.integers(-2, shape[1] + 2, n) * down
    return [(float(p), float(x), float(y)) for p, x, y in zip(ps, xs, ys)]


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_curves_and_scores_exactly_equal_jax(seed):
    masks = {f"tumor_{i}": readers(random_mask(seed + i))
             for i in range(3)}
    dets = {s: detections(seed * 10 + i, (160, 200), 32.0)
            for i, s in enumerate(list(masks) + ["normal_0", "normal_1"])}
    types = {s: ("tumor" if s.startswith("tumor") else "normal")
             for s in dets}
    got = froc.froc_for_slides(dets, lambda s: masks[s][0], types, 5)
    want = jax_froc.froc_for_slides(dets, lambda s: masks[s][1], types, 5)
    assert got == want
    assert 0.0 <= got[0] <= 1.0 and len(got[1]) > 2
    ev, itcs = froc.compute_evaluation_mask(masks["tumor_0"][0], 5, False)
    items = froc.scale_detections(dets["tumor_0"], 32.0)
    assert items == jax_froc.scale_detections(dets["tumor_0"], 32.0)
    assert froc.compute_probabilities(items, ev, itcs) == \
        jax_froc.compute_probabilities(items, ev, itcs)


def write_mask_pyramid(path, spacing=0.243 * 32):
    """Odd level-0 dims (non-power-of-2 page ratios), a tumour and an ITC
    at level 5, floor-divided pages as scanner files have them."""
    arr0 = np.zeros((3999, 3001), np.uint8)
    arr0[300:1000, 400:1100] = 2
    arr0[2400:2410, 2200:2210] = 2
    levels = [arr0]
    for _ in range(6):
        levels.append(levels[-1][::2, ::2].copy())
    native.write_tiled_tiff_gray(path, levels, tile=64, spacing_um=spacing)
    return levels


def test_native_mask_reader_matches_the_jax_one(tmp_path,
                                                jax_uses_the_port_reader):
    path = str(tmp_path / "tumor_r_mask.tif")
    levels = write_mask_pyramid(path)
    ours, theirs = froc.NativeMaskReader(path), jax_froc.NativeMaskReader(
        path)
    for level in (0, 3, 5, 6, 8):
        got, want = ours.read(level), theirs.read(level)
        np.testing.assert_array_equal(got.array, want.array)
        assert (got.downsample, got.spacing_um) == (want.downsample,
                                                    want.spacing_um)
        if level < len(levels):
            np.testing.assert_array_equal(got.array, levels[level])
            assert got.downsample == 3001 / levels[level].shape[1]
    assert got.spacing_um == pytest.approx(0.243 * 32, rel=1e-6)
    s = native.NativeSlide(path)
    assert s.page_spacing_um(5) == pytest.approx(
        0.243 * 32 * 3001 / levels[5].shape[1], rel=1e-6)
    ev, itcs = froc.compute_evaluation_mask(ours, 5, False)
    want_ev, want_itcs = jax_froc.compute_evaluation_mask(theirs, 5, False)
    np.testing.assert_array_equal(ev, want_ev)
    assert itcs == want_itcs and itcs
    ours.close()


def test_open_mask_has_no_pil_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: (_ for _ in ()).throw(
        RuntimeError("native slide reader unavailable: no g++")))
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        froc.open_mask(str(tmp_path / "x_mask.tif"))


def test_eval_mask_cache_keeps_one_npz_per_mask(tmp_path):
    path = str(tmp_path / "tumor_001_mask.tif")
    arr = np.zeros((2048, 2048), np.uint8)
    arr[:1200, :1200] = 2
    native.write_tiled_tiff_gray(path, [arr, arr[::32, ::32].copy()],
                                 tile=64)
    cache_dir = str(tmp_path / "cache")
    dets = {"tumor_001": [(0.9, 256.0, 256.0), (0.3, 1800.0, 1800.0)]}
    types = {"tumor_001": "tumor"}
    base = froc.froc_for_slides(dets, lambda s: path, types, 1)
    cache = froc.EvalMaskCache(cache_dir)
    for _ in range(3):
        assert froc.froc_for_slides(dets, lambda s: path, types, 1,
                                    mask_cache=cache) == base
    assert len(cache._mem) == 1
    assert len(os.listdir(cache_dir)) == 1

    # a fresh cache reads the npz, without recomputing
    cache2 = froc.EvalMaskCache(cache_dir)
    real = froc.compute_evaluation_mask
    froc.compute_evaluation_mask = None
    try:
        assert froc.froc_for_slides(dets, lambda s: path, types, 1,
                                    mask_cache=cache2) == base
    finally:
        froc.compute_evaluation_mask = real

    # the mask exported again: recomputed, and its npz overwritten (the
    # JAX cache adds a second npz for each export)
    arr2 = np.zeros_like(arr)
    arr2[:600, :600] = 2
    native.write_tiled_tiff_gray(path, [arr2, arr2[::32, ::32].copy()],
                                 tile=64)
    os.utime(path, ns=(os.stat(path).st_atime_ns,
                       os.stat(path).st_mtime_ns + 10 ** 9))
    fresh = froc.froc_for_slides(dets, lambda s: path, types, 1)
    cache3 = froc.EvalMaskCache(cache_dir)
    assert froc.froc_for_slides(dets, lambda s: path, types, 1,
                                mask_cache=cache3) == fresh
    assert len(os.listdir(cache_dir)) == 1
    # and the stale entry in a live cache is not served either
    assert froc.froc_for_slides(dets, lambda s: path, types, 1,
                                mask_cache=cache) == fresh


def test_eval_mask_cache_leaves_no_temporary_file(tmp_path, monkeypatch):
    path = str(tmp_path / "m_mask.tif")
    arr = np.zeros((64, 64), np.uint8)
    arr[:20, :20] = 2
    native.write_tiled_tiff_gray(path, [arr], tile=64)
    real = np.savez_compressed

    def half_write(file, **arrays):
        real(file, **arrays)          # the temporary file is on disk ...
        raise OSError("disk full")    # ... when the write fails

    monkeypatch.setattr(froc.np, "savez_compressed", half_write)
    cache = froc.EvalMaskCache(str(tmp_path / "cache"))
    with pytest.raises(OSError, match="disk full"):
        cache.get(path, 0, False)
    assert os.listdir(tmp_path / "cache") == []


def test_eval_mask_cache_mem_key_carries_the_stamp(tmp_path):
    path = str(tmp_path / "m_mask.tif")
    native.write_tiled_tiff_gray(path, [np.full((8, 8), 2, np.uint8)])
    cache = froc.EvalMaskCache()
    cache.get(path, 0, True)
    (key,) = cache._mem
    st = os.stat(path)
    # (path, level, include_itcs, stamp): four parts, as `_mem`'s
    # annotation now says (the JAX one names three)
    assert key == (path, 0, True, (st.st_mtime_ns, st.st_size))


def write_cli_inputs(tmp_path):
    masks = tmp_path / "masks"
    masks.mkdir()
    arr = np.zeros((2048, 2048), np.uint8)
    arr[:1200, :1200] = 2
    arr[1500:1510, 1600:1610] = 2
    levels = [arr]
    for _ in range(5):
        levels.append(levels[-1][::2, ::2].copy())
    native.write_tiled_tiff_gray(str(masks / "tumor_001_mask.tif"), levels,
                                 tile=64, spacing_um=0.243)
    dets = tmp_path / "detections"
    dets.mkdir()
    rng = np.random.default_rng(0)
    pd.DataFrame({"p": np.round(rng.random(40), 4),
                  "x": rng.integers(0, 2048, 40),
                  "y": rng.integers(0, 2048, 40)}).to_csv(
        dets / "tumor_001.csv", index=False)
    pd.DataFrame({"p": [0.5, 0.25], "x": [100, 7], "y": [100, 9]}).to_csv(
        dets / "normal_001.csv", index=False)
    ref = tmp_path / "reference.csv"
    pd.DataFrame({"image": ["tumor_001.tif", "normal_001.tif",
                            "test_009.tif"],
                  "type": ["Tumor", "Normal", "tumor"]}).to_csv(
        ref, index=False)
    return ["--reference", str(ref), "--masks", str(masks), "--detections",
            str(dets), "--level", "5"]


def test_froc_cli_matches_the_root_cli(tmp_path, jax_uses_the_port_reader,
                                       capsys):
    args = write_cli_inputs(tmp_path)
    want = root_froc.main(args + ["--result", str(tmp_path / "jax.csv")])
    got = froc_cli.main(args + ["--result", str(tmp_path / "port.csv"),
                                "--cache_dir", str(tmp_path / "cache"),
                                "--plot", str(tmp_path / "froc.png")])
    assert got == want and 0.0 < got <= 1.0
    assert open(tmp_path / "port.csv", "rb").read() == \
        open(tmp_path / "jax.csv", "rb").read()
    assert os.path.getsize(tmp_path / "froc.png") > 0
    assert f"Score: {got}" in capsys.readouterr().out


def test_froc_cli_has_the_root_flags():
    a, b = froc_cli.get_args_parser(), root_froc.get_args_parser()
    assert [(x.dest, x.option_strings, x.default, x.type, x.required)
            for x in a._actions] == \
        [(x.dest, x.option_strings, x.default, x.type, x.required)
         for x in b._actions]
