"""The port's streaming slide path and its codecs vs the JAX package.

The C reader (`snuffy_tpu_torch/native`) against `snuffy_tpu.native` on
the same TIFFs: grid tiles, energies and the M/8 scaled decode bit for
bit, the writers byte for byte, and `codec_abi.h` against the system
headers. The numpy twins of the JAX package's cv2 calls (`edge_energy`,
`area_resize`) against cv2 bit for bit; `decode_jpeg` and the PIL-bilinear
copy against PIL bit for bit (libjpeg's ISLOW IDCT and Pillow's integer
resample leave no rounding to differ). Then `predict_slide`, streaming, on
the CPU in f32 at ρ=0 against the JAX `predict_slide` on the same slide
and weights, and the JAX package's own slide tests mirrored on the port.
"""

import os
import shutil
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu import native as jax_native
from snuffy_tpu.embed.registry import Embedder as JaxEmbedder
from snuffy_tpu.models.snuffy import build_milnet as jax_build_milnet
from snuffy_tpu.models.snuffy import init_milnet_params
from snuffy_tpu.models.vit import VisionTransformer as JaxViT
from snuffy_tpu.pipeline import slide_inference as jax_slide
from snuffy_tpu.tiling import deepzoom as jax_deepzoom
from snuffy_tpu_torch import native
from snuffy_tpu_torch.bridge import milnet_from_jax, vit_from_jax
from snuffy_tpu_torch.embed.pipeline import pil_bilinear_resize
from snuffy_tpu_torch.embed.registry import Embedder
from snuffy_tpu_torch.models.vit import VisionTransformer
from snuffy_tpu_torch.pipeline.slide_inference import (
    predict_slide,
    predict_tiles,
    read_slide_tiles,
)
from snuffy_tpu_torch.tiling.deepzoom import (
    TilerConfig,
    area_resize,
    edge_energy,
)
from tests.test_torch_bags import load_jax_native
from tests.test_torch_serve import CFG, REPO, TOL, VIT



@pytest.fixture(scope="module")
def native_libs():
    """The port's slide reader and the JAX package's library, both loaded:
    the JAX build is waited for as tests/test_torch_bags.py waits for it
    (another test process may be writing it), and a library that does not
    load fails the test."""
    if not native.available():
        pytest.fail("the port's slide reader did not build or load (g++, "
                    "libtiff or libjpeg)")
    with pytest.MonkeyPatch.context() as mp:
        if load_jax_native(mp) is None:
            pytest.fail("snuffy_tpu.native did not build or load in 300 s")
        yield


needs_native = pytest.mark.usefixtures("native_libs")
NATIVE_DIR = os.path.dirname(native.SOURCE)
# The slide geometry of tests/test_slide_inference.py: level 0 read at its
# own size, so the tile grid is aligned and the streaming path applies.
TILER = dict(objective_power=20.0, base_mag=20.0, tile_size=256,
             background_threshold=5.0)


def make_jpeg_slide(path, grid=6, tile=256, seed=0, quality=75,
                    pyramid=True):
    """`tests/test_slide_inference.py:_make_jpeg_slide`'s recipe with the
    port's writer: smooth textured tissue on every other tile of a flat
    background. Returns the tissue (col, row) set and level 0."""
    rng = np.random.default_rng(seed)
    side = grid * tile
    level0 = np.full((side, side, 3), 245, np.uint8)
    tissue = set()
    yy, xx = np.mgrid[0:tile, 0:tile] / tile
    for r in range(grid):
        for c in range(grid):
            if (r + c) % 2 == 0:
                continue
            smooth = (120 + 60 * np.sin(4 * np.pi * (xx + 0.3 * r))
                      + 40 * np.cos(3 * np.pi * (yy + 0.2 * c)))[..., None]
            tex = smooth + rng.normal(0, 12, (tile, tile, 3))
            level0[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = (
                np.clip(tex, 0, 255).astype(np.uint8))
            tissue.add((c, r))
    levels = [level0, level0[::2, ::2]] if pyramid else [level0]
    native.write_tiled_tiff(path, levels, tile=tile, jpeg_quality=quality)
    return tissue, level0


# ------------------------------------------------------------ native reader

@needs_native
@pytest.mark.parametrize("quality", [0, 75], ids=["uncompressed", "jpeg75"])
def test_grid_reads_match_the_jax_reader(tmp_path, quality):
    path = str(tmp_path / "slide.tif")
    tissue, level0 = make_jpeg_slide(path, grid=4, quality=quality)
    with native.NativeSlide(path) as ours, \
            jax_native.NativeSlide(path) as theirs:
        assert ours.level_count == theirs.level_count == 2
        for row0, n_rows in ((0, 4), (1, 2), (3, 1)):
            got = ours.read_grid(0, 256, 4, n_rows, row0)
            want = theirs.read_grid(0, 256, 4, n_rows, row0)
            assert got[0].shape == (4 * n_rows, 256, 256, 3)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        # the level-1 grid (128² tiles of a 256-tiled level: region path)
        got = ours.read_grid(1, 128, 4, 4, 0)
        want = theirs.read_grid(1, 128, 4, 4, 0)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert ours.scaled_grid_ok(0, 256, 224) is bool(quality)
        if quality:
            got = ours.read_grid_scaled(0, 256, 4, 4, 0, 224)
            want = theirs.read_grid_scaled(0, 256, 4, 4, 0, 224)
            assert got[0].shape == (16, 224, 224, 3)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    if not quality:   # lossless: the tiles are the written pixels
        tiles, _ = native.NativeSlide(path).read_grid(0, 256, 4, 1, 2)
        np.testing.assert_array_equal(tiles[1], level0[512:768, 256:512])


@needs_native
@pytest.mark.parametrize("read,out,ok", [(256, 224, True), (256, 100, False),
                                         (128, 112, False), (256, 64, True)])
def test_scaled_decode_eligibility(tmp_path, read, out, ok):
    path = str(tmp_path / "slide.tif")
    make_jpeg_slide(path, grid=2)
    assert native.NativeSlide.scale_num_for(read, out) == \
        jax_native.NativeSlide.scale_num_for(read, out)
    with native.NativeSlide(path) as ours, \
            jax_native.NativeSlide(path) as theirs:
        assert ours.scaled_grid_ok(0, read, out) is ok
        assert theirs.scaled_grid_ok(0, read, out) is ok
        if not native.NativeSlide.scale_num_for(read, out):
            with pytest.raises(ValueError):
                ours.read_grid_scaled(0, read, 2, 2, 0, out)


@needs_native
def test_writers_match_the_jax_writers_byte_for_byte(tmp_path):
    rng = np.random.default_rng(3)
    levels = [rng.integers(0, 256, (300, 520, 3), dtype=np.uint8)]
    levels.append(levels[0][::2, ::2])
    for quality in (0, 75):
        ours, theirs = tmp_path / f"a{quality}.tif", tmp_path / f"b{quality}.tif"
        native.write_tiled_tiff(str(ours), levels, tile=128,
                                jpeg_quality=quality)
        jax_native.write_tiled_tiff(str(theirs), levels, tile=128,
                                    jpeg_quality=quality)
        assert ours.read_bytes() == theirs.read_bytes()
    native.write_jpeg(str(tmp_path / "a.jpeg"), levels[1], quality=80)
    jax_native.jpeg_write(str(tmp_path / "b.jpeg"), levels[1], quality=80)
    assert (tmp_path / "a.jpeg").read_bytes() == \
        (tmp_path / "b.jpeg").read_bytes()
    with pytest.raises(FileNotFoundError):
        native.NativeSlide(str(tmp_path / "missing.tif"))
    with pytest.raises(IOError):
        native.decode_jpeg(str(tmp_path / "missing.jpeg"))
    for bad in (levels[0][..., 0], levels[0][..., :2]):  # not (H, W, 3)
        with pytest.raises(ValueError):
            native.write_jpeg(str(tmp_path / "c.jpeg"), bad)
        with pytest.raises(ValueError):
            native.write_tiled_tiff(str(tmp_path / "c.tif"), [bad])
    with pytest.raises(ValueError):
        native.edge_energy(levels[0][:64, :32])


def test_codec_declarations_match_the_system_headers(tmp_path):
    """codec_abi.h stands in for tiffio.h and jpeglib.h: every constant,
    struct size and used field offset equals the system headers' (a
    compile-time check, here where the headers exist)."""
    headers = ("/usr/include/x86_64-linux-gnu/tiffio.h",
               "/usr/include/jpeglib.h")
    if shutil.which("g++") is None or not all(map(os.path.exists, headers)):
        pytest.skip("g++ or the libtiff/libjpeg headers are absent")
    consts = ("TIFFTAG_IMAGEWIDTH TIFFTAG_IMAGELENGTH TIFFTAG_BITSPERSAMPLE "
              "TIFFTAG_COMPRESSION TIFFTAG_PHOTOMETRIC TIFFTAG_SAMPLESPERPIXEL "
              "TIFFTAG_XRESOLUTION TIFFTAG_YRESOLUTION TIFFTAG_PLANARCONFIG "
              "TIFFTAG_RESOLUTIONUNIT TIFFTAG_TILEWIDTH TIFFTAG_TILELENGTH "
              "TIFFTAG_TILEBYTECOUNTS TIFFTAG_JPEGTABLES TIFFTAG_JPEGQUALITY "
              "TIFFTAG_JPEGCOLORMODE COMPRESSION_NONE COMPRESSION_JPEG "
              "PHOTOMETRIC_MINISBLACK PHOTOMETRIC_RGB PHOTOMETRIC_YCBCR "
              "PLANARCONFIG_CONTIG RESUNIT_INCH RESUNIT_CENTIMETER "
              "JPEGCOLORMODE_RGB ORIENTATION_TOPLEFT JPEG_LIB_VERSION "
              "JPEG_HEADER_OK JPEG_HEADER_TABLES_ONLY JCS_GRAYSCALE JCS_RGB "
              "JCS_YCbCr JCS_CMYK JCS_YCCK JDCT_ISLOW").split()
    fields = {
        "jpeg_error_mgr": "error_exit msg_parm trace_level last_addon_message",
        "jpeg_compress_struct": "err dest image_width image_height "
                                "input_components in_color_space "
                                "next_scanline script_space_size",
        "jpeg_decompress_struct": "err src image_width image_height "
                                  "num_components jpeg_color_space "
                                  "out_color_space scale_num scale_denom "
                                  "output_width output_height "
                                  "output_components output_scanline "
                                  "cquantize",
    }
    lines = ["#include <cstddef>", "#include <cstdint>", "#include <cstdio>",
             "namespace own {", "#define SNUFFY_CODEC_ABI_TYPES_ONLY",
             '#include "codec_abi.h"', "}"]
    lines += [f"constexpr long own_{c} = (long)own::{c};" for c in consts]
    lines += ["#include <tiffio.h>", "#include <jpeglib.h>"]
    lines += [f'static_assert(own_{c} == (long){c}, "{c}");' for c in consts]
    for t in ("tmsize_t", "ttile_t", "tdir_t"):
        lines.append(f'static_assert(sizeof(own::{t}) == sizeof({t}), "{t}");')
    for struct, names in fields.items():
        lines.append(f"static_assert(sizeof(own::{struct}) == "
                     f'sizeof(::{struct}), "{struct}");')
        lines += [f"static_assert(offsetof(own::{struct}, {f}) == "
                  f'offsetof(::{struct}, {f}), "{struct}.{f}");'
                  for f in names.split()]
    src = tmp_path / "abi_check.cpp"
    src.write_text("\n".join(lines) + "\n")
    out = subprocess.run(
        ["g++", "-std=c++17", "-fsyntax-only", "-Werror", f"-I{NATIVE_DIR}",
         "-I/usr/include/x86_64-linux-gnu", str(src)],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@needs_native
def test_bundled_libraries_give_the_same_bytes(tmp_path):
    """The route a machine without system libtiff/libjpeg takes: the reader
    linked against a Pillow wheel's bundled copies by path decodes the
    same tiles, energies and JPEG pixels as the system build."""
    libs = native.bundled_codec_libraries()
    if libs is None:
        pytest.skip("no pillow.libs with libtiff.so.6 and libjpeg.so.62")
    path = str(tmp_path / "slide.tif")
    make_jpeg_slide(path, grid=2)
    native.write_jpeg(str(tmp_path / "t.jpeg"),
                      np.random.default_rng(0).integers(
                          0, 256, (40, 30, 3), dtype=np.uint8))
    # a fresh process: two builds of one source in one process would share
    # their symbols
    code = (
        "import numpy as np\n"
        "from snuffy_tpu_torch import native\n"
        f"libs = tuple({libs!r})\n"
        "lib, why = native.build(libs)\n"
        "assert lib is not None, why\n"
        "native.get_lib = lambda: lib\n"
        f"s = native.NativeSlide({path!r})\n"
        "t, e = s.read_grid(0, 256, 2, 2, 0)\n"
        "t2, e2 = s.read_grid_scaled(0, 256, 2, 2, 0, 224)\n"
        f"j = native.decode_jpeg({str(tmp_path / 't.jpeg')!r})\n"
        f"np.savez({str(tmp_path / 'bundled.npz')!r}, t=t, e=e, t2=t2, "
        "e2=e2, j=j)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = np.load(tmp_path / "bundled.npz")
    with native.NativeSlide(path) as s:
        want = (*s.read_grid(0, 256, 2, 2, 0),
                *s.read_grid_scaled(0, 256, 2, 2, 0, 224))
    for key, w in zip(("t", "e", "t2", "e2"), want):
        np.testing.assert_array_equal(got[key], w)
    np.testing.assert_array_equal(
        got["j"], native.decode_jpeg(str(tmp_path / "t.jpeg")))


# ------------------------------------------------- cv2 and PIL, in numpy

def threshold_tiles():
    """Tiles whose energy sits exactly at 15.0, the Camelyon16 threshold,
    and one gray level either side: one isolated pixel at 240 on a black
    16² tile gives |8·240| + 8·240 over 256 pixels = 15.0."""
    out = []
    for v in (239, 240, 241):
        t = np.zeros((16, 16, 3), np.uint8)
        t[7, 9] = v
        out.append(t)
    t = np.zeros((256, 256, 3), np.uint8)
    t[2::16, 3::16] = 240     # 256 isolated pixels: 15.0 again
    out.append(t)
    return out


@pytest.mark.parametrize("case", range(7))
def test_edge_energy_is_cv2s_bit_for_bit(case):
    rng = np.random.default_rng(case)
    if case < 4:
        side = (64, 224, 256, 17)[case]
        tiles = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8),
                 np.clip(rng.normal(200, 3, (side, side, 3)), 0, 255
                         ).astype(np.uint8)]
    else:
        tiles = threshold_tiles()[case - 4:case - 3] if case < 6 else \
            threshold_tiles()[2:]
    for tile in tiles:
        want = jax_deepzoom.edge_energy(tile)
        got = edge_energy(tile)
        assert got == want, (got, want)
        if native.available():
            # the C reader sums exactly in doubles; numpy's f32 mean is a
            # pairwise sum: within one f32 ulp of each other
            diff = abs(native.edge_energy(tile) - got)
            assert diff <= np.spacing(np.float32(got)), diff
    if case == 5:
        assert edge_energy(threshold_tiles()[1]) == 15.0
        assert not edge_energy(threshold_tiles()[1]) > 15.0


@pytest.mark.parametrize("ratio", [2, 3, 4])
def test_area_resize_is_cv2_inter_area(ratio):
    import cv2

    rng = np.random.default_rng(ratio)
    for side in (64, 128):
        tile = rng.integers(0, 256, (side * ratio, side * ratio, 3),
                            dtype=np.uint8)
        want = cv2.resize(tile, (side, side), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(area_resize(tile, side), want)


def test_area_resize_refuses_other_ratios():
    """Fractional and rectangular shrinks take cv2's area taps (they were
    refused before the tiler needed them); a growing axis, which cv2
    interpolates linearly, is the ratio still refused."""
    import cv2

    tile = np.random.default_rng(5).integers(0, 256, (384, 384, 3),
                                             dtype=np.uint8)
    np.testing.assert_array_equal(
        area_resize(tile, 256),
        cv2.resize(tile, (256, 256), interpolation=cv2.INTER_AREA))  # 1.5
    np.testing.assert_array_equal(
        area_resize(tile[:256, :128], 64),
        cv2.resize(tile[:256, :128], (64, 64), interpolation=cv2.INTER_AREA))
    with pytest.raises(ValueError):
        area_resize(tile, 512)
    with pytest.raises(ValueError):
        area_resize(tile, 128, 400)
    np.testing.assert_array_equal(area_resize(tile, 384), tile)


@needs_native
@pytest.mark.parametrize("mode", ["RGB", "L", "RGB-420-q95", "RGB-444"])
def test_decode_jpeg_is_pils(tmp_path, mode):
    from PIL import Image

    rng = np.random.default_rng(len(mode))
    arr = rng.integers(0, 256, (67, 45, 3), dtype=np.uint8)
    arr[20:40] = np.clip(arr[20:40] // 3 + 90, 0, 255)
    path = str(tmp_path / "t.jpeg")
    if mode == "L":
        Image.fromarray(arr[..., 1]).save(path, quality=75)
    elif mode == "RGB-444":
        Image.fromarray(arr).save(path, quality=75, subsampling=0)
    else:
        Image.fromarray(arr).save(path, quality=95 if "q95" in mode else 75)
    want = np.asarray(Image.open(path).convert("RGB"))
    for hint in (16, 67, 256):
        got = native.decode_jpeg(path, size_hint=hint)
        assert got.shape == (67, 45, 3) and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)


@needs_native
def test_decode_jpeg_refuses_cmyk(tmp_path):
    from PIL import Image

    path = str(tmp_path / "cmyk.jpeg")
    Image.new("CMYK", (8, 8), (10, 20, 30, 40)).save(path)
    with pytest.raises(ValueError, match="CMYK"):
        native.decode_jpeg(path)


@pytest.mark.parametrize("shape,size", [
    ((256, 256), (224, 224)), ((160, 160), (224, 224)),
    ((300, 200), (224, 224)), ((37, 53), (64, 20)), ((512, 512), (224, 224)),
])
def test_pil_bilinear_copy_is_pils(shape, size):
    from PIL import Image

    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(pil_bilinear_resize(img, size), want)


# ---------------------------------------------- the streaming slide path

def models():
    """The JAX embed + MILNet pair of the root predict_slide.py and the
    port's models with the same weights (test_torch_serve's widths)."""
    jvit = JaxViT(**VIT)
    vparams = jvit.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 224, 224, 3)))["params"]
    jemb = JaxEmbedder(lambda p, im: jvit.apply({"params": p}, im, True),
                       64, 1, params=vparams)
    jemb.init_head(0)
    mparams = init_milnet_params(CFG, seed=0, n_example=64)
    jmodel = jax_build_milnet(CFG)

    @jax.jit
    def milnet_apply(p, feats, mask):  # root predict_slide.py:97-103
        ins_logits, bag_logits, _ = jmodel.apply(
            {"params": p}, feats, mask, True,
            rngs={"sparse": jax.random.PRNGKey(0)})
        return jax.nn.sigmoid(ins_logits[:, 0]), jax.nn.sigmoid(bag_logits[0])

    jax_kwargs = dict(embed_fn=jemb.jit_apply(), embedder_params=vparams,
                      embedder_head_params=jemb.head_params,
                      milnet_apply=milnet_apply, milnet_params=mparams)
    vit = VisionTransformer(**VIT)
    vit.load_state_dict({k: torch.from_numpy(v)
                         for k, v in vit_from_jax(vparams).items()})
    return jax_kwargs, Embedder(vit, 64, 1).eval(), milnet_from_jax(
        mparams, CFG, device="cpu")


@pytest.fixture(scope="module")
def jpeg_slide(native_libs):
    d = tempfile.mkdtemp()
    path = os.path.join(d, "tumor_002.tif")
    tissue, _ = make_jpeg_slide(path, grid=6)
    yield path, tissue
    shutil.rmtree(d)


@pytest.mark.parametrize("scaled_decode", [None, False])
def test_streaming_matches_the_jax_streaming_path(jpeg_slide, scaled_decode):
    """Same slide, same weights, f32, ρ=0: the same kept tiles in the same
    order, the same decode path, scores within TOL. 18 tissue tiles in
    batches of 8 (a padded tail) from blocks of two grid rows."""
    path, tissue = jpeg_slide
    jax_kwargs, embedder, milnet = models()
    want = jax_slide.predict_slide(
        path, tiler_cfg=jax_deepzoom.TilerConfig(**TILER), embed_batch=8,
        embed_size=224, workers=0, scaled_decode=scaled_decode, **jax_kwargs)
    got = predict_slide(path, embedder, milnet, TilerConfig(**TILER),
                        embed_batch=8, embed_size=224, workers=0,
                        scaled_decode=scaled_decode)
    assert got.timings["decode_path"] == want.timings["decode_path"] == (
        "grid" if scaled_decode is False else "grid_jpeg_scaled")
    assert got.positions == want.positions
    assert set(got.positions) == tissue
    assert got.timings["n_patches"] == want.timings["n_patches"] == 18
    for key in ("read_filter_s", "read_decode_s", "embed_s", "classify_s",
                "total_s"):
        assert got.timings[key] >= 0.0
    np.testing.assert_allclose(got.instance_scores, want.instance_scores,
                               **TOL)
    np.testing.assert_allclose(got.bag_score, want.bag_score, **TOL)


@needs_native
def test_streaming_matches_per_tile(tmp_path):
    """tests/test_slide_inference.py:35-68 on the port: a strip-layout
    slide (the grid reader's region branch) through the streaming path and
    through the per-tile reader + predict_tiles."""
    from tests.test_tiling import make_slide

    slide = str(tmp_path / "tumor_002.tif")
    make_slide(slide)
    _, embedder, milnet = models()
    cfg = TilerConfig(**TILER)
    fast = predict_slide(slide, embedder, milnet, cfg, embed_batch=4,
                         embed_size=224, workers=0)
    tiles, positions = read_slide_tiles(slide, cfg, workers=0)
    slow = predict_tiles(torch.from_numpy(tiles), embedder, milnet,
                         embed_batch=4, embed_size=224)
    assert fast.timings["decode_path"] == "grid"
    assert fast.positions == positions and len(positions) == 4
    assert fast.timings["n_patches"] == slow.timings["n_patches"]
    np.testing.assert_allclose(fast.instance_scores, slow.instance_scores,
                               **TOL)
    np.testing.assert_allclose(fast.bag_score, slow.bag_score, **TOL)


def test_prefetch_on_and_off_agree_bit_for_bit(jpeg_slide):
    path, _ = jpeg_slide
    _, embedder, milnet = models()
    runs = [predict_slide(path, embedder, milnet, TilerConfig(**TILER),
                          embed_batch=8, workers=0, prefetch=p,
                          scaled_decode=s)
            for p in (True, False) for s in (None, False)]
    for on, off in ((runs[0], runs[2]), (runs[1], runs[3])):
        assert on.positions == off.positions
        np.testing.assert_array_equal(on.instance_scores,
                                      off.instance_scores)
        assert on.bag_score == off.bag_score


def test_scaled_decode_matches_the_resize_path(jpeg_slide):
    """tests/test_slide_inference.py:132-181 on the port: the 7/8 IDCT
    against decode at 256 + the device resize; the tolerances are that
    test's (the two decodes differ in the top frequency band)."""
    path, tissue = jpeg_slide
    _, embedder, milnet = models()
    kw = dict(tiler_cfg=TilerConfig(**TILER), embed_batch=8, workers=0)
    scaled = predict_slide(path, embedder, milnet, **kw)
    resize = predict_slide(path, embedder, milnet, scaled_decode=False, **kw)
    assert scaled.timings["decode_path"] == "grid_jpeg_scaled"
    assert resize.timings["decode_path"] == "grid"
    assert set(scaled.positions) == set(resize.positions) == tissue
    np.testing.assert_allclose(scaled.instance_scores,
                               resize.instance_scores, atol=0.05)
    assert abs(scaled.bag_score - resize.bag_score) < 0.02


@needs_native
def test_all_background_slide_has_no_patches(tmp_path):
    path = str(tmp_path / "blank.tif")
    native.write_tiled_tiff(path, [np.full((512, 768, 3), 245, np.uint8)],
                            tile=256, jpeg_quality=75)
    _, embedder, milnet = models()
    for scaled_decode in (None, False):
        pred = predict_slide(path, embedder, milnet, TilerConfig(**TILER),
                             embed_batch=4, workers=0,
                             scaled_decode=scaled_decode)
        assert pred.timings["n_patches"] == 0 and pred.positions == []
        assert pred.bag_score == 0.0 and pred.instance_scores.shape == (0,)
        assert pred.timings["classify_s"] == 0.0


@needs_native
def test_residual_resize_takes_the_per_tile_path(tmp_path):
    """objective 40 over base 20 on a slide with only level 0: the grid is
    read at 512 and shrunk 2× (area_resize), so no streaming."""
    path = str(tmp_path / "slide.tif")
    make_jpeg_slide(path, grid=4, pyramid=False)
    _, embedder, milnet = models()
    cfg = TilerConfig(**{**TILER, "objective_power": 40.0})
    pred = predict_slide(path, embedder, milnet, cfg, embed_batch=4,
                         workers=0)
    assert pred.timings["decode_path"] == "per_tile"
    tiles, positions = read_slide_tiles(path, cfg, workers=0)
    assert pred.positions == positions and len(positions) > 0
    assert tiles.shape[1:] == (256, 256, 3)
