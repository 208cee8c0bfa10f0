"""The port's heat maps (`snuffy_tpu_torch.viz`) and ROI CLI against the
JAX package's.

Grid, contour and blended RGB bit-equal to `snuffy_tpu.viz.heatmap` on the
same scores; the jet table byte-equal to matplotlib's; the PNG writer
decoding (PIL and the port's reader) to `plt.imsave`'s pixels; `roi.main`
on the CPU against the JAX `roi.main` from the same weights (f32,
instance scores within 1e-5), and the refusal of both at the root's
`--num_heads 6` / `--feats_size 512` defaults before any bag is read. The
JAX CLI opens `snuffy_tpu.native.NativeSlide`, pointed here at the port's
reader.
"""

import io
import os

import jax
import matplotlib
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

import roi as root_roi
from snuffy_tpu import native as jax_native
from snuffy_tpu.configs import SnuffyModelConfig
from snuffy_tpu.embed import pipeline as jax_pipeline
from snuffy_tpu.models.snuffy import init_milnet_params
from snuffy_tpu.viz import heatmap as jax_heatmap
from snuffy_tpu_torch import native, roi
from snuffy_tpu_torch.bridge import milnet_state_dict
from snuffy_tpu_torch.tiling import deepzoom as dz
from snuffy_tpu_torch.viz import heatmap, png
from tests.test_torch_cli_embedders import resnet18_pth
from tests.test_torch_tiling import write_slide

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def scores_and_positions(seed, cols=9, rows=7, keep=0.7):
    rng = np.random.default_rng(seed)
    cells = [(c, r) for r in range(rows) for c in range(cols)
             if rng.random() < keep]
    return rng.random(len(cells)), [f"{c}_{r}" for c, r in cells]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_contour_and_blend_equal_jax(seed):
    scores, names = scores_and_positions(seed)
    pos = heatmap.parse_positions(names + ["x", "tumor_12_3-9.jpeg"])
    assert pos == jax_heatmap.parse_positions(names + ["x",
                                                       "tumor_12_3-9.jpeg"])
    grid, occ = heatmap.scores_to_grid(pos[:-2], scores,
                                       return_occupancy=True)
    want_grid, want_occ = jax_heatmap.scores_to_grid(pos[:-2], scores,
                                                     return_occupancy=True)
    np.testing.assert_array_equal(grid, want_grid)
    np.testing.assert_array_equal(occ, want_occ)
    rng = np.random.default_rng(seed + 10)
    h, w = rng.integers(20, 90, 2)
    gray = rng.integers(0, 256, (h, w), np.uint8)
    tumor = (rng.random((h, w)) < 0.02).astype(np.uint8)
    tumor[h // 4:h // 2, : w // 3] = 1          # touching the image edge
    contour = heatmap.mask_contour(tumor)
    np.testing.assert_array_equal(contour, jax_heatmap.mask_contour(tumor))
    for c, o in ((contour, occ), (None, None)):
        np.testing.assert_array_equal(
            heatmap.blend_heatmap(gray, grid, c, occupancy=o),
            jax_heatmap.blend_heatmap(gray, grid, c, occupancy=o))


def test_resize_nearest_is_cv2_inter_nearest():
    import cv2

    rng = np.random.default_rng(3)
    for _ in range(60):
        sh, sw = rng.integers(1, 40, 2)
        h, w = rng.integers(1, 200, 2)
        src = rng.random((sh, sw)).astype(np.float32)
        np.testing.assert_array_equal(
            heatmap.resize_nearest(src, w, h),
            cv2.resize(src, (int(w), int(h)),
                       interpolation=cv2.INTER_NEAREST))


def test_the_jet_table_is_matplotlibs():
    cmap = matplotlib.colormaps["jet"]
    cmap._init()
    np.testing.assert_array_equal(heatmap.JET_LUT, cmap._lut)
    x = np.concatenate([np.linspace(0, 1, 4099),
                        [-0.5, 1.5, np.nan, 255.5 / 256, 1 / 256]])
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(heatmap.jet_colors(x.astype(dtype)),
                                      cmap(x.astype(dtype)))
        np.testing.assert_array_equal(
            heatmap.jet_colors(x.astype(dtype), as_bytes=True),
            cmap(x.astype(dtype), bytes=True))


@pytest.mark.parametrize("with_thumbnail", [True, False])
def test_visualize_attentions_png_is_plt_imsaves(tmp_path, with_thumbnail):
    scores, names = scores_and_positions(4)
    gray = tumor = None
    if with_thumbnail:
        rng = np.random.default_rng(5)
        gray = rng.integers(0, 256, (70, 90), np.uint8)
        tumor = np.zeros((70, 90), np.uint8)
        tumor[20:40, 30:60] = 1
    got = heatmap.visualize_attentions(scores, names,
                                       str(tmp_path / "port.png"), gray, tumor)
    want = jax_heatmap.visualize_attentions(scores, names,
                                            str(tmp_path / "jax.png"), gray,
                                            tumor)
    np.testing.assert_array_equal(got, want)
    ours = np.asarray(Image.open(tmp_path / "port.png"))
    np.testing.assert_array_equal(ours, np.asarray(Image.open(
        tmp_path / "jax.png")))
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "port.png")),
                                  ours)


@pytest.mark.parametrize("shape", [(5, 7), (6, 4, 3), (3, 9, 4), (1, 1, 3)])
def test_png_writer_decodes_to_its_pixels(tmp_path, shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    data = png.encode_png(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(png.decode_png(data), img)
    if img.ndim == 3 and img.shape[2] == 3:   # imsave's pixels
        plt.imsave(str(tmp_path / "p.png"), img)
        rgba = np.concatenate([img, np.full(img.shape[:2] + (1,), 255,
                                            np.uint8)], axis=-1)
        png.write_png(str(tmp_path / "q.png"), rgba)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "q.png")),
            np.asarray(Image.open(tmp_path / "p.png")))


def roi_fixture(tmp_path):
    """A tiled bag, its slide (4 levels) and a label mask, a seeded
    ResNet-18 `.pth`, and one MILNet as the JAX `.msgpack` and its
    reference `.pth` (d=512, 4 heads, Λ=8, depth 2)."""
    slides = tmp_path / "slides"
    masks = tmp_path / "masks"
    slides.mkdir()
    masks.mkdir()
    write_slide(str(slides / "tumor_007.tif"), levels=(2, 4, 8), quality=80)
    dz.tile_slide(str(slides / "tumor_007.tif"),
                  str(tmp_path / "bags" / "tumor_007"),
                  dz.TilerConfig(tile_size=256, objective_power=20,
                                 base_mag=20, background_threshold=5.0,
                                 workers=0))
    lab = np.zeros((1024, 1024), np.uint8)
    lab[300:700, 280:520] = 2
    lab[100:130, 800:900] = 1
    native.write_tiled_tiff_gray(
        str(masks / "tumor_007_mask.tif"),
        [lab] + [lab[::k, ::k].copy() for k in (2, 4, 8)], tile=64)
    resnet18_pth(str(tmp_path / "resnet18.pth"))
    cfg = SnuffyModelConfig(feats_size=512, num_classes=1, num_heads=4,
                            big_lambda=8, random_patch_share=0.0, depth=2)
    params = jax.tree_util.tree_map(np.asarray,
                                    init_milnet_params(cfg, 5, n_example=64))
    with open(tmp_path / "milnet.msgpack", "wb") as f:
        f.write(serialization.to_bytes({"params": params,
                                        "w": np.float32(0.5),
                                        "step": np.int32(0)}))
    torch.save({k: torch.from_numpy(v)
                for k, v in milnet_state_dict(params).items()},
               tmp_path / "milnet.pth")
    return ["--embedder_weights", str(tmp_path / "resnet18.pth"),
            "--num_heads", "4", "--big_lambda", "8", "--depth", "2",
            "--batch_size", "8", "--bags_path", str(tmp_path / "bags" / "*"),
            "--slides_path", str(slides), "--masks_path", str(masks)]


def test_roi_matches_the_root_roi(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "NativeSlide", native.NativeSlide)
    args = roi_fixture(tmp_path)
    captured = {}
    real = jax_heatmap.visualize_attentions

    def capture(scores, *a, **k):
        captured["scores"] = np.asarray(scores)
        return real(scores, *a, **k)

    monkeypatch.setattr(jax_heatmap, "visualize_attentions", capture)
    want_bags = root_roi.main(args + [
        "--aggregator_weights", str(tmp_path / "milnet.msgpack"),
        "--output", str(tmp_path / "jax")])
    (got,) = roi.main(args + ["--aggregator_weights",
                              str(tmp_path / "milnet.pth"),
                              "--output", str(tmp_path / "port"),
                              "--device", "cpu"])
    assert [got["bag"]] == want_bags
    assert len(got["scores"]) == 4 == len(captured["scores"])
    np.testing.assert_allclose(got["scores"], captured["scores"], rtol=0,
                               atol=1e-5)
    assert got["embed_s"] > 0 and got["classify_s"] > 0
    ours = png.read_png(got["png"])
    theirs = np.asarray(Image.open(tmp_path / "jax" / "tumor_007.png"))
    assert ours.shape == theirs.shape == (128, 128, 4)
    green = (ours[..., :3] == (0, 255, 0)).all(-1)
    np.testing.assert_array_equal(
        green, (theirs[..., :3] == (0, 255, 0)).all(-1))
    # the contour lies on the tumour's boundary band at the thumbnail
    tumor = np.zeros((128, 128), np.uint8)
    tumor[38:88, 35:65] = 1
    np.testing.assert_array_equal(green, heatmap.mask_contour(tumor))
    # away from scores that round to a jet entry's edge the blend is equal
    assert (ours != theirs).any(-1).mean() < 0.01


def test_roi_refuses_the_root_defaults_before_reading_a_bag(tmp_path,
                                                            monkeypatch):
    """`--num_heads 6` beside `--feats_size 512` (roi.py:39-40): 512 is not
    a multiple of 6. The root CLI fails its MILNet's d % h assertion
    before any bag is read; the port refuses at the same point."""
    bags = tmp_path / "bags" / "tumor_001"
    bags.mkdir(parents=True)
    (bags / "0_0.jpeg").write_bytes(b"")

    def no_bag(*a, **k):
        raise AssertionError("a bag was read")

    monkeypatch.setattr(roi, "compute_bag_feats", no_bag)
    monkeypatch.setattr(jax_pipeline, "compute_bag_feats", no_bag)
    argv = ["--aggregator_weights", str(tmp_path / "absent.pth"),
            "--bags_path", str(tmp_path / "bags" / "*")]
    with pytest.raises(ValueError, match="divisible by num_heads"):
        roi.main(argv + ["--device", "cpu"])
    with pytest.raises(AssertionError, match="divisible by num_heads"):
        root_roi.main(argv)


def test_roi_refuses_a_flax_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="export_torch_checkpoint"):
        roi.main(["--aggregator_weights", str(tmp_path / "a.msgpack"),
                  "--num_heads", "4", "--bags_path", str(tmp_path / "*"),
                  "--device", "cpu"])


def test_roi_has_the_root_flags_plus_device():
    a, b = roi.get_args_parser(), root_roi.get_args_parser()
    rows = [(x.dest, x.option_strings, x.default, x.type, x.required)
            for x in a._actions]
    assert rows[:-1] == [(x.dest, x.option_strings, x.default, x.type,
                          x.required) for x in b._actions]
    assert rows[-1][:3] == ("device", ["--device"], "cuda")
