"""The port's tiler (`snuffy_tpu_torch.tiling.deepzoom`) and its two CLIs
against the JAX package's.

The numpy twins against cv2 bit for bit: `fill_poly`/
`rasterize_annotations` against `cv2.fillPoly` (hypothesis: concave,
touching and off-canvas polygons), `area_resize` against
`cv2.resize(INTER_AREA)` at the tiler's shapes (overlap and fractional
level ratios). Then `tile_slide` and `tile_slide_nested` against the JAX
tiler on pyramids written with the port's writer: the same kept tuples,
labels and file names, and the same pixels. The JAX tiler opens
`snuffy_tpu.native.NativeSlide` and `jpeg_write`; the tests point those
names at the port's reader and writer (held bit for bit to the JAX ones
by tests/test_torch_slide.py), so both sides read the same pixels and no
test builds the JAX package's library. The CLIs run in a subprocess with
cv2, PIL, pandas and JAX blocked.
"""

import os
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import deepzoom_tiler_camelyon16 as root_c16
import deepzoom_tiler_tcga_lung_cancer as root_tcga
from snuffy_tpu import native as jax_native
from snuffy_tpu.tiling import deepzoom as jax_dz
from snuffy_tpu_torch import native
from snuffy_tpu_torch.tiling import deepzoom as dz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "snuffy_tpu", "pandas",
           "sklearn", "cv2", "PIL")


@pytest.fixture
def jax_uses_the_port_reader(monkeypatch):
    monkeypatch.setattr(jax_native, "NativeSlide", native.NativeSlide)
    monkeypatch.setattr(jax_native, "jpeg_write", native.write_jpeg)


def write_slide(path, size=1024, tissue=(256, 768), levels=(2,), seed=0,
                tile=128, quality=0):
    """Level 0 of `size`² (a textured tissue box on a flat 245
    background) and one level per entry of `levels`, each that many times
    smaller, as a tiled TIFF (uncompressed at quality 0)."""
    rng = np.random.default_rng(seed)
    arr = np.full((size, size, 3), 245, np.uint8)
    a, b = tissue
    arr[a:b, a:b] = (rng.random((b - a, b - a, 3)) * 180 + 40).astype(
        np.uint8)
    pyramid = [arr] + [dz.area_resize(arr, size // k) for k in levels]
    native.write_tiled_tiff(path, pyramid, tile=tile, jpeg_quality=quality)
    return arr


def write_xml(path, polygons):
    """ASAP XML with one Annotation per polygon."""
    anns = "".join(
        '<Annotation Name="_%d" Type="Polygon" PartOfGroup="Tumor">'
        "<Coordinates>%s</Coordinates></Annotation>" % (
            j, "".join(f'<Coordinate Order="{i}" X="{x}" Y="{y}"/>'
                       for i, (x, y) in enumerate(poly)))
        for j, poly in enumerate(polygons))
    with open(path, "w") as f:
        f.write("<ASAP_Annotations><Annotations>" + anns
                + "</Annotations></ASAP_Annotations>")


# ------------------------------------------------------------- fillPoly

CONCAVE = [(2, 2), (30, 3), (12, 12), (28, 28), (3, 25)]
TOUCHING = [[(0, 0), (10, 0), (10, 10), (0, 10)],
            [(10, 5), (20, 5), (20, 15), (10, 15)]]
OFF_CANVAS = [(-13, 40), (-9, 21), (51, 54), (1, -15), (19, 47), (29, -15)]


@pytest.mark.parametrize("polygons", [[CONCAVE], TOUCHING, [OFF_CANVAS],
                                      [[(5, 5)]], [[(3, 4), (20, 9)]],
                                      [CONCAVE, OFF_CANVAS]],
                         ids=["concave", "touching", "off-canvas", "point",
                              "segment", "two"])
def test_fill_poly_is_cv2_fillpoly(polygons):
    pts = [np.asarray(p, np.int32) for p in polygons]
    for h, w in ((32, 32), (17, 41), (1, 9)):
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, pts, 1)
        got = dz.fill_poly(np.zeros((h, w), np.uint8), pts, 1)
        np.testing.assert_array_equal(got, want)


polygon = st.lists(st.tuples(st.integers(-25, 70), st.integers(-25, 70)),
                   min_size=1, max_size=9)


@settings(max_examples=300, deadline=None)
@given(st.lists(polygon, min_size=1, max_size=3), st.integers(1, 48),
       st.integers(1, 48))
def test_fill_poly_is_cv2_fillpoly_on_random_polygons(polygons, h, w):
    pts = [np.asarray(p, np.int32) for p in polygons]
    want = np.zeros((h, w), np.uint8)
    cv2.fillPoly(want, pts, 1)
    got = dz.fill_poly(np.zeros((h, w), np.uint8), pts, 1)
    np.testing.assert_array_equal(got, want)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.lists(st.tuples(st.floats(-600, 3000), st.floats(-600,
                                                                      3000)),
                         min_size=3, max_size=8), max_size=3),
       st.integers(32, 2500), st.integers(32, 2500))
def test_rasterize_annotations_matches_jax(polygons, w0, h0):
    polys = [np.asarray(p, np.float64) for p in polygons]
    got, down = dz.rasterize_annotations(polys, (w0, h0))
    want, want_down = jax_dz.rasterize_annotations(polys, (w0, h0))
    assert down == want_down
    np.testing.assert_array_equal(got, want)


def test_parse_xml_matches_jax(tmp_path):
    path = str(tmp_path / "a.xml")
    write_xml(path, [[(1.5, 2), (30, 4.25), (7, 9)], [(0, 0), (1, 1)],
                     CONCAVE])
    got, want = dz.parse_camelyon16_xml(path), jax_dz.parse_camelyon16_xml(
        path)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------- INTER_AREA

# (h, w) → (out_h, out_w) as the tiler gives them: 256 tiles at residual 2
# with and without a 16-px overlap (edge tiles are rectangular), whole
# ratios 3 and 4, the fractional ratios of a pyramid whose level ratio is
# not whole (residual 4/3: 341 → 256) or whose dimensions are odd
# (residual 1.998: 511 → 256), overlap at a fractional ratio, and gray.
AREA_SHAPES = [((512, 512), (256, 256)), ((544, 576), (272, 288)),
               ((576, 544), (288, 272)), ((768, 768), (256, 256)),
               ((1024, 1024), (256, 256)), ((341, 341), (256, 256)),
               ((511, 511), (256, 256)), ((362, 384), (272, 288)),
               ((300, 257), (256, 256)), ((96, 64), (32, 64))]


@pytest.mark.parametrize("shape, out", AREA_SHAPES)
@pytest.mark.parametrize("channels", [3, 0])
def test_area_resize_is_cv2_inter_area_at_the_tilers_shapes(shape, out,
                                                            channels):
    rng = np.random.default_rng(shape[0] * 7 + out[1] + channels)
    img = rng.integers(0, 256, shape + ((channels,) if channels else ()),
                       dtype=np.uint8)
    want = cv2.resize(img, out[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(dz.area_resize(img, out[1], out[0]), want)


def test_area_resize_names_the_ratio_it_does_not_reproduce():
    with pytest.raises(ValueError, match="ratio of 0.5 × 0.5"):
        dz.area_resize(np.zeros((128, 128, 3), np.uint8), 256)


# -------------------------------------------------------------- tilers


def listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_tiles(got_dir, want_dir, fmt):
    names = listing(want_dir)
    assert listing(got_dir) == names and names
    for name in names:
        a, b = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if fmt == "jpeg":
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
        else:
            np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                          np.asarray(Image.open(b)))


# objective/base magnification and the pyramid's level ratios: level 0
# read as it is, a whole residual of 2 (level ratio 3 leaves level 0), and
# a fractional residual of 4/3 (target 4 read from the 3x level)
TILER_CASES = {
    "level0": dict(objective_power=20, base_mag=20, levels=(2,)),
    "residual2": dict(objective_power=40, base_mag=20, levels=(3,)),
    "residual4/3": dict(objective_power=80, base_mag=20, levels=(3,)),
    "overlap-png": dict(objective_power=40, base_mag=20, levels=(3,),
                        overlap=16, image_format="png"),
}


@pytest.mark.parametrize("case", list(TILER_CASES))
def test_tile_slide_matches_the_jax_tiler(tmp_path, jax_uses_the_port_reader,
                                          case):
    kw = dict(TILER_CASES[case])
    levels = kw.pop("levels")
    slide = str(tmp_path / "tumor_001.tif")
    write_slide(slide, size=1536, tissue=(300, 1200), levels=levels)
    xml = str(tmp_path / "tumor_001.xml")
    write_xml(xml, [[(400, 380), (900, 420), (700, 900), (620, 600),
                     (380, 860)]])
    cfg = dict(tile_size=256, background_threshold=5.0, workers=0, **kw)
    want = jax_dz.tile_slide(slide, str(tmp_path / "jax"),
                             jax_dz.TilerConfig(**cfg), annotation_xml=xml)
    # the port's spawned pool in one case, in-process in the others
    workers = 2 if case == "residual4/3" else 0
    got = dz.tile_slide(slide, str(tmp_path / "port"),
                        dz.TilerConfig(**{**cfg, "workers": workers}),
                        annotation_xml=xml)
    assert got == want and got
    # the polygon covers some kept tiles and not others where the grid
    # has more than one tile
    assert {lab for _, _, lab in got} == ({0, 1} if len(got) > 1 else {1})
    assert_same_tiles(str(tmp_path / "port"), str(tmp_path / "jax"),
                      kw.get("image_format", "jpeg"))
    rows = []
    for i, kept in enumerate((got, want)):
        csv = str(tmp_path / f"tile_label_{i}.csv")
        (dz if i == 0 else jax_dz).append_tile_labels(csv, "tumor_001", kept)
        rows.append(open(csv).read())
    assert rows[0] == rows[1] and rows[0]


def test_tile_slide_nested_matches_the_jax_tiler(tmp_path,
                                                 jax_uses_the_port_reader):
    slide = str(tmp_path / "s.tif")
    write_slide(slide, quality=80)
    xml = str(tmp_path / "s.xml")
    write_xml(xml, [[(256, 256), (450, 256), (450, 450), (256, 450)]])
    cfg = dict(tile_size=256, objective_power=20, base_mag=20,
               background_threshold=5.0, workers=0, name_with_level=True)
    want = jax_dz.tile_slide_nested(slide, str(tmp_path / "jax"),
                                    jax_dz.TilerConfig(**cfg), xml,
                                    mag_levels=(0, 1))
    got = dz.tile_slide_nested(slide, str(tmp_path / "port"),
                               dz.TilerConfig(**cfg), xml, mag_levels=(0, 1))
    assert got == want and got
    assert any(os.path.isdir(os.path.join(tmp_path, "port", f))
               for f in os.listdir(tmp_path / "port"))
    assert_same_tiles(str(tmp_path / "port"), str(tmp_path / "jax"), "jpeg")


def make_c16_tree(root):
    base = os.path.join(root, "datasets", "camelyon16")
    for cls in ("0_normal", "1_tumor", "annotations"):
        os.makedirs(os.path.join(base, cls))
    write_slide(os.path.join(base, "1_tumor", "tumor_001.tif"), seed=1,
                quality=75)
    write_slide(os.path.join(base, "0_normal", "normal_001.tif"), seed=2,
                quality=75)
    write_xml(os.path.join(base, "annotations", "tumor_001.xml"),
              [[(256, 256), (450, 256), (450, 450), (256, 450)]])
    return base


def make_tcga_tree(root):
    base = os.path.join(root, "datasets", "tcga")
    for cls, seed in (("0_luad", 3), ("1_lusc", 4)):
        os.makedirs(os.path.join(base, cls))
        write_slide(os.path.join(base, cls, f"TCGA-{seed}.svs"), seed=seed,
                    levels=(2, 4), quality=75)
    return base


def run_blocked(cwd, module, argv):
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        import runpy
        sys.argv = ["tiler"] + {list(argv)!r}
        runpy.run_module({module!r}, run_name="__main__")
        leaked = [m for m, mod in sys.modules.items()
                  if m.split(".")[0] in {BLOCKED!r} and mod is not None]
        assert not leaked, leaked
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("cli", ["camelyon16", "tcga"])
def test_tiler_clis_match_the_root_clis_with_cv2_pil_pandas_blocked(
        tmp_path, monkeypatch, jax_uses_the_port_reader, cli):
    make = make_c16_tree if cli == "camelyon16" else make_tcga_tree
    flags = ["-t", "5", "-o", "20", "-b", "20"] if cli == "camelyon16" \
        else ["-t", "5"]
    for side in ("jax", "port"):
        make(str(tmp_path / side))
    monkeypatch.chdir(tmp_path / "jax")
    root = root_c16 if cli == "camelyon16" else root_tcga
    root.main(flags + ["-j", "0"])
    module = ("snuffy_tpu_torch.deepzoom_tiler_camelyon16"
              if cli == "camelyon16"
              else "snuffy_tpu_torch.deepzoom_tiler_tcga_lung_cancer")
    out = run_blocked(str(tmp_path / "port"), module, flags + ["-j", "2"])
    assert "kept" in out
    got = os.path.join(tmp_path, "port", "datasets")
    want = os.path.join(tmp_path, "jax", "datasets")
    assert listing(got) == listing(want)
    sub = "camelyon16" if cli == "camelyon16" else "tcga"
    assert_same_tiles(os.path.join(got, sub, "single"),
                      os.path.join(want, sub, "single"), "jpeg")
    if cli == "camelyon16":
        labels = open(os.path.join(got, sub, "tile_label.csv")).read()
        assert labels == open(os.path.join(want, sub,
                                           "tile_label.csv")).read()
        assert "tumor_001_1_1,1" in labels


def test_tiler_clis_have_the_root_flags():
    from snuffy_tpu_torch import (
        deepzoom_tiler_camelyon16,
        deepzoom_tiler_tcga_lung_cancer,
    )

    for ours, theirs in ((deepzoom_tiler_camelyon16, root_c16),
                         (deepzoom_tiler_tcga_lung_cancer, root_tcga)):
        a, b = ours.get_args_parser(), theirs.get_args_parser()
        assert [(x.dest, x.option_strings, x.default, x.type, x.choices,
                 x.nargs) for x in a._actions] == \
            [(x.dest, x.option_strings, x.default, x.type, x.choices,
              x.nargs) for x in b._actions]
