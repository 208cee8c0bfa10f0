"""Whole-slide tiling: pyramidal TIFF → per-bag patch images + labels.

The port's copy of `snuffy_tpu/tiling/deepzoom.py` (the reference
deepzoom tilers, deepzoom_tiler_camelyon16.py and
deepzoom_tiler_tcga_lung_cancer.py), with its cv2 and PIL calls replaced
by numpy twins that give their bytes, and its native reader and writers
by the port's (`snuffy_tpu_torch.native`, `viz.png`):

  * the read level is the deepest stored level whose downsample is at most
    objective/target magnification, and the residual factor is shrunk
    after the read (`area_resize`, cv2's INTER_AREA; the DeepZoomGenerator
    arithmetic, reference deepzoom_tiler_camelyon16.py:219-224);
  * a tile is background when its mean 8-neighbour edge energy is at most
    the threshold (`edge_energy`, cv2's fixed-point gray and Laplacian;
    the PIL FIND_EDGES rule, reference deepzoom_tiler_camelyon16.py:81-85);
  * Camelyon16 patch labels: the annotation polygons are rasterized once
    into a low-resolution tumour mask (`fill_poly`, cv2.fillPoly) and each
    kept patch reads its overlap; workers return labels and one writer
    appends them to tile_label.csv;
  * a spawned process pool of tile workers, each with its own slide handle.

Names: `{col}_{row}-{level}.jpeg` (camelyon16), `{col}_{row}.jpeg` (tcga);
tile_label.csv rows `{slide}_{col}_{row},label`.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
import shutil
import tempfile
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class TilerConfig:
    tile_size: int = 256
    quality: int = 75
    background_threshold: float = 15.0  # camelyon16: 15, tcga: 20
    objective_power: float = 40.0
    base_mag: float = 20.0
    workers: int = 4
    name_with_level: bool = True  # camelyon16 `{col}_{row}-{level}.jpeg`
    tumor_coverage: float = 0.0   # patch labeled tumor if overlap > this
    # DeepZoomGenerator-style overlap (reference `-e/--overlap`): the grid
    # steps by tile_size and each tile gains `overlap` pixels on every side
    # that abuts another tile.
    overlap: int = 0
    image_format: str = "jpeg"    # 'jpeg' or 'png' (reference `-f`)


def edge_energy(tile: np.ndarray) -> float:
    """Mean |8-neighbour Laplacian| over the grayscale tile, as
    `np.abs(cv2.filter2D(cv2.cvtColor(tile, RGB2GRAY).astype(f32), -1,
    EDGE_KERNEL)).mean()` gives it: cv2's fixed-point gray, the Laplacian
    in integers with reflect-101 borders (exact: its sums stay below
    2^24), cast to f32, and numpy's f32 mean of the same (h, w) array."""
    t = tile.astype(np.int32)
    gray = (t[..., 0] * 9798 + t[..., 1] * 19235 + t[..., 2] * 3735
            + (1 << 14)) >> 15
    h, w = gray.shape
    pad = np.pad(gray, 1, mode="reflect")   # numpy's reflect is reflect-101
    box = sum(pad[i:i + h, j:j + w] for i in range(3) for j in range(3))
    edges = (9 * gray - box).astype(np.float32)
    return float(np.abs(edges).mean())


# ----------------------------------------------------------- INTER_AREA


def _area_taps(ssize: int, dsize: int, scale: float):
    """cv2's computeResizeAreaTab: for each output index, its (source
    index, f32 weight) taps in cv2's order."""
    taps = []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - fs1 > 1e-3:
            row.append((s1 - 1, np.float32((s1 - fs1) / cell)))
        row.extend((s, np.float32(1.0 / cell)) for s in range(s1, s2))
        if fs2 - s2 > 1e-3:
            row.append((s2, np.float32(min(min(fs2 - s2, 1.0), cell) / cell)))
        taps.append(row)
    return taps


def _area_axis(src: np.ndarray, axis: int, taps) -> np.ndarray:
    """Σ taps along `axis` in f32, each output's taps added in cv2's order
    (one rank of taps at a time, over every output that has it)."""
    src = np.moveaxis(src, axis, 0)
    out = np.zeros((len(taps),) + src.shape[1:], np.float32)
    for rank in range(max(len(t) for t in taps)):
        dst = np.array([d for d, t in enumerate(taps) if len(t) > rank])
        idx = np.array([taps[d][rank][0] for d in dst])
        w = np.array([taps[d][rank][1] for d in dst], np.float32)
        w = w.reshape((-1,) + (1,) * (src.ndim - 1))
        out[dst] = out[dst] + src[idx] * w
    return np.moveaxis(out, 0, axis)


def area_resize(tile: np.ndarray, out_w: int,
                out_h: Optional[int] = None) -> np.ndarray:
    """(h, w[, c]) uint8 → (out_h, out_w[, c]), as `cv2.resize(tile,
    (out_w, out_h), interpolation=cv2.INTER_AREA)` gives it when it
    shrinks or keeps both axes (out_h defaults to out_w). Whole ratios
    (cv2's `is_area_fast`) take block means: 2×2 rounded half up,
    (s + 2) >> 2, others s · (1/area) in f32 rounded half to even. Any
    other ratio takes cv2's area taps in f32: each source row's taps summed
    along x, then the rows' along y, rounded half to even. An axis that
    grows (cv2 interpolates it linearly) raises ValueError."""
    out_h = out_w if out_h is None else out_h
    h, w = tile.shape[:2]
    if not (0 < out_w <= w and 0 < out_h <= h):
        raise ValueError(
            f"area_resize shrinks: {tile.shape[:2]} → ({out_h}, {out_w}) "
            f"is a ratio of {h / max(out_h, 1):.6g} × {w / max(out_w, 1):.6g}"
            f" (h × w), and cv2 interpolates a growing axis linearly, "
            f"which is not reproduced")
    if (out_h, out_w) == (h, w):
        return tile.copy()
    scale_x, scale_y = 1.0 / (out_w / w), 1.0 / (out_h / h)
    kx, ky = round(scale_x), round(scale_y)
    if (abs(scale_x - kx) < np.finfo(np.float64).eps
            and abs(scale_y - ky) < np.finfo(np.float64).eps):
        s = tile.reshape((out_h, ky, out_w, kx) + tile.shape[2:]).astype(
            np.int32).sum(axis=(1, 3))
        if (kx, ky) == (2, 2):
            return ((s + 2) >> 2).astype(np.uint8)
        scaled = s.astype(np.float32) * np.float32(1.0 / (kx * ky))
        return np.rint(scaled).astype(np.uint8)
    rows = _area_axis(tile.astype(np.float32), 1, _area_taps(w, out_w,
                                                             scale_x))
    taps_y = _area_taps(h, out_h, scale_y)
    out = np.empty((out_h,) + rows.shape[1:], np.float32)
    for d, taps in enumerate(taps_y):
        acc = None
        for s, beta in taps:
            term = beta * rows[s]
            acc = term if acc is None else acc + term
        out[d] = acc
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


# ------------------------------------------------------------- fillPoly

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv::clipLine on an image of w × h: (inside?, x1, y1, x2, y2), the
    points moved as cv2 moves them (also when it returns False)."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _draw_line(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int,
               value: int) -> None:
    """cv2's 8-connected line (LineIterator, left to right), clipped."""
    h, w = mask.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    x, y = x1, y1
    for _ in range(major + 1):
        mask[y, x] = value
        step_minor = err < 0
        err += -2 * minor + (2 * major if step_minor else 0)
        if vert:
            y += sy
            x += 1 if step_minor else 0
        else:
            x += 1
            y += sy if step_minor else 0


def _tdiv(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_poly(mask: np.ndarray, polygons: Sequence[np.ndarray],
              value: int = 1) -> np.ndarray:
    """`cv2.fillPoly(mask, polygons, value)` (8-connected, shift 0) in
    place, bit for bit: each edge drawn as an 8-connected line, then cv2's
    even-odd scanline fill over every polygon's edges at once, with edge
    x in 16.16 fixed point (an edge with an end outside the image runs
    through its clipped ends), each span from the ceiling of its left x to
    the floor of its right x, clipped to the image."""
    h, w = mask.shape[:2]
    edges = []   # (y0, x, dx, y1) as cv2's PolyEdge
    for poly in polygons:
        pts = np.asarray(poly, np.int64).reshape(-1, 2)
        if not len(pts):
            continue
        x0, y0 = (int(v) for v in pts[-1])
        for x1, y1 in ((int(a), int(b)) for a, b in pts):
            _draw_line(mask, x0, y0, x1, y1, value)
            c0x, c0y, c1x, c1y = x0 << _XY_SHIFT, y0, x1 << _XY_SHIFT, y1
            if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h
                    and 0 <= y1 < h):
                # the edge takes the clipped ends' x, and their y unless
                # clipping left it flat (cv2 does so also when the line
                # misses the image)
                _, t0x, t0y, t1x, t1y = _clip_line(w, h, x0, y0, x1, y1)
                c0x, c1x = t0x << _XY_SHIFT, t1x << _XY_SHIFT
                if t0y != t1y:
                    c0y, c1y = t0y, t1y
            if y0 != y1:
                dx = _tdiv(c1x - c0x, c1y - c0y)
                if y0 < y1:
                    edges.append((y0, c0x + (y0 - c0y) * dx, dx, y1))
                else:
                    edges.append((y1, c1x + (y1 - c1y) * dx, dx, y0))
            x0, y0 = x1, y1
    if len(edges) < 2:
        return mask
    e = np.array(edges, np.int64)
    ends = e[:, 1] + (e[:, 3] - e[:, 0]) * e[:, 2]
    y_min, y_max = int(e[:, 0].min()), int(e[:, 3].max())
    x_min = int(min(e[:, 1].min(), ends.min()))
    x_max = int(max(e[:, 1].max(), ends.max()))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << _XY_SHIFT):
        return mask
    for y in range(max(y_min, 0), min(y_max, h)):
        live = (e[:, 0] <= y) & (y < e[:, 3])
        xs = np.sort(e[live, 1] + (y - e[live, 0]) * e[live, 2])
        for lo, hi in zip(xs[0::2], xs[1::2]):
            x1 = (int(lo) + _XY_ONE - 1) >> _XY_SHIFT   # ceil, floor
            x2 = int(hi) >> _XY_SHIFT
            if x1 < w and x2 >= 0:
                mask[y, max(x1, 0):min(x2, w - 1) + 1] = value
    return mask


# ------------------------------------------------------------ annotations


def parse_camelyon16_xml(xml_path: str) -> List[np.ndarray]:
    """ASAP annotation XML → list of (N, 2) level-0 (x, y) polygons
    (reference deepzoom_tiler_camelyon16.py:110-132)."""
    tree = ET.parse(xml_path)
    polygons = []
    for ann in tree.iter("Annotation"):
        coords = []
        for c in ann.iter("Coordinate"):
            coords.append((float(c.get("X")), float(c.get("Y"))))
        if len(coords) >= 3:
            polygons.append(np.asarray(coords, np.float64))
    return polygons


def rasterize_annotations(
    polygons: Sequence[np.ndarray], level0_size: Tuple[int, int],
    mask_downsample: float = 32.0,
) -> Tuple[np.ndarray, float]:
    """Rasterize level-0 polygons into a low-res uint8 tumor mask."""
    w0, h0 = level0_size
    mw, mh = int(np.ceil(w0 / mask_downsample)), int(np.ceil(h0 / mask_downsample))
    mask = np.zeros((mh, mw), np.uint8)
    pts = [
        np.round(poly / mask_downsample).astype(np.int32) for poly in polygons
    ]
    if pts:
        fill_poly(mask, pts, 1)
    return mask, mask_downsample


def pick_read_level(slide, target_downsample: float) -> Tuple[int, float]:
    """Deepest stored level with downsample ≤ target; returns (level,
    residual factor to shrink by after reading)."""
    best, best_down = 0, 1.0
    for lvl in range(slide.level_count):
        d = slide.level_downsample(lvl)
        if d <= target_downsample + 1e-6 and d > best_down:
            best, best_down = lvl, d
    return best, target_downsample / best_down


def _grid(slide, level: int, residual: float, tile: int):
    lw, lh = slide.level_dimensions(level)
    read = int(round(tile * residual))
    cols = lw // read
    rows = lh // read
    return read, cols, rows


# ---------------------------------------------------------------- workers

_worker_state: dict = {}


def _init_worker(slide_path, mask_info=None):
    from snuffy_tpu_torch.native import NativeSlide

    _worker_state["slide"] = NativeSlide(slide_path)
    _worker_state["mask_info"] = mask_info


def _write_tile(path: str, region: np.ndarray, quality: int, fmt: str):
    if fmt == "jpeg":
        from snuffy_tpu_torch.native import write_jpeg

        write_jpeg(path, region, quality)
    elif fmt == "png":
        from snuffy_tpu_torch.viz.png import write_png

        write_png(path, region)
    else:
        raise ValueError(f"tile format {fmt!r}: jpeg or png")


def _tile_one(args):
    (col, row, level, read, tile, out_path, threshold,
     name_with_level, quality, tumor_coverage, dz_level, overlap, fmt,
     cols, rows) = args
    mask_info = _worker_state.get("mask_info")
    slide = _worker_state["slide"]
    # Overlap extends the read window on every side that has a neighbour
    # (DeepZoomGenerator semantics); the scale between stored-level pixels
    # and output pixels is read/tile.
    scale = read / tile
    ov_l = int(round(overlap * scale)) if col > 0 else 0
    ov_t = int(round(overlap * scale)) if row > 0 else 0
    ov_r = int(round(overlap * scale)) if col < cols - 1 else 0
    ov_b = int(round(overlap * scale)) if row < rows - 1 else 0
    x0 = col * read - ov_l
    y0 = row * read - ov_t
    w = read + ov_l + ov_r
    h = read + ov_t + ov_b
    region = slide.read_region(level, x0, y0, w, h)
    out_w = tile + (overlap if col > 0 else 0) + (overlap if col < cols - 1 else 0)
    out_h = tile + (overlap if row > 0 else 0) + (overlap if row < rows - 1 else 0)
    if region.shape[:2] != (out_h, out_w):
        region = area_resize(region, out_w, out_h)
    if edge_energy(region) <= threshold:
        return None  # background
    name = (f"{col}_{row}-{dz_level}.{fmt}" if name_with_level
            else f"{col}_{row}.{fmt}")
    _write_tile(os.path.join(out_path, name), region, quality, fmt)

    label = None
    if mask_info is not None:
        mask, mask_down, level_down = mask_info
        # patch rect in mask coords
        scale = level_down * read / mask_down
        x0 = int(col * scale)
        y0 = int(row * scale)
        x1 = max(x0 + 1, int((col + 1) * scale))
        y1 = max(y0 + 1, int((row + 1) * scale))
        patch_mask = mask[y0:min(y1, mask.shape[0]), x0:min(x1, mask.shape[1])]
        coverage = float(patch_mask.mean()) if patch_mask.size else 0.0
        label = 1 if coverage > tumor_coverage else 0
    return col, row, label


def tile_slide(
    slide_path: str,
    out_dir: str,
    cfg: TilerConfig,
    annotation_xml: Optional[str] = None,
    mag_level: int = 0,
) -> List[Tuple[int, int, Optional[int]]]:
    """Tile one slide into out_dir. Returns kept (col, row, label) tuples
    in row-scan order (label None without annotations). `mag_level` counts
    halvings below base_mag (the reference's per-magnification deepzoom
    levels, deepzoom_tiler_camelyon16.py:152-159). With cfg.workers > 1 a
    spawned pool of that many processes reads and writes the tiles."""
    from snuffy_tpu_torch.native import NativeSlide

    os.makedirs(out_dir, exist_ok=True)
    slide = NativeSlide(slide_path)
    target_down = cfg.objective_power / cfg.base_mag * (2 ** mag_level)
    level, residual = pick_read_level(slide, target_down)
    read, cols, rows = _grid(slide, level, residual, cfg.tile_size)
    level_down = slide.level_downsample(level)
    # The file name's deepzoom level: DeepZoomGenerator counts
    # 1 + ceil(log2(max(w, h))) levels, and the target sits
    # log2(downsample) below the top (reference
    # deepzoom_tiler_camelyon16.py:152,219-224).
    w0, h0 = slide.level_dimensions(0)
    dz_max = int(np.ceil(np.log2(max(w0, h0, 1))))
    dz_level = dz_max - int(round(np.log2(max(target_down, 1.0))))

    mask_info = None
    if annotation_xml is not None and os.path.exists(annotation_xml):
        polygons = parse_camelyon16_xml(annotation_xml)
        mask, mask_down = rasterize_annotations(
            polygons, slide.level_dimensions(0)
        )
        mask_info = (mask, mask_down, level_down)
    slide.close()

    # The mask rides in the pool's initializer, not in each job.
    jobs = [
        (c, r, level, read, cfg.tile_size, out_dir, cfg.background_threshold,
         cfg.name_with_level, cfg.quality, cfg.tumor_coverage, dz_level,
         cfg.overlap, cfg.image_format, cols, rows)
        for r in range(rows)
        for c in range(cols)
    ]
    if cfg.workers > 1:
        with mp.get_context("spawn").Pool(
                cfg.workers, initializer=_init_worker,
                initargs=(slide_path, mask_info)) as pool:
            results = pool.map(_tile_one, jobs)
    else:
        _init_worker(slide_path, mask_info)
        try:
            results = [_tile_one(j) for j in jobs]
        finally:
            _worker_state["slide"].close()
            _worker_state.clear()
    return [r for r in results if r is not None]


def tile_slide_nested(
    slide_path: str,
    out_dir: str,
    cfg: TilerConfig,
    annotation_xml: Optional[str] = None,
    mag_levels: Sequence[int] = (0,),
) -> List[Tuple[int, int, Optional[int]]]:
    """Two-magnification tiling into one bag directory (the reference's
    `nested_patches` mode, deepzoom_tiler_camelyon16.py:256-295, whose own
    branch cannot run: this is the DSMIL nested-bag layout it aims at).
    The low-magnification patches sit at the bag root and each low patch
    `{c}_{r}-{lvl}` owns a folder of the (2^Δ)² high-magnification patches
    it covers.

    With one level this is `tile_slide`. Returns the kept tuples of the
    finest level that were moved under a kept low patch (a high tile whose
    parent was background stays in the temporary directory, so a row for
    it would name a file that does not exist)."""
    if len(mag_levels) == 1:
        return tile_slide(slide_path, out_dir, cfg, annotation_xml,
                          mag_level=mag_levels[0])
    if len(mag_levels) != 2:
        raise ValueError("nested tiling supports 1 or 2 magnification levels")
    lo, hi = max(mag_levels), min(mag_levels)  # lo = more downsampled
    factor = 2 ** (lo - hi)

    with tempfile.TemporaryDirectory() as tmp:
        hi_dir = os.path.join(tmp, "hi")
        kept_hi = tile_slide(slide_path, hi_dir, cfg, annotation_xml,
                             mag_level=hi)
        kept_lo = tile_slide(slide_path, out_dir, cfg, None, mag_level=lo)

        hi_names = {}  # (col, row) -> filename
        for f in os.listdir(hi_dir):
            stem = f.split(".")[0].split("-")[0]
            c, r = stem.split("_")
            hi_names[(int(c), int(r))] = f
        moved = set()
        for col, row, _ in kept_lo:
            sub = None
            for dc in range(factor):
                for dr in range(factor):
                    key = (col * factor + dc, row * factor + dr)
                    if key in hi_names:
                        if sub is None:
                            # folder named after the low patch's stem
                            low_name = [
                                f for f in os.listdir(out_dir)
                                if f.split(".")[0].split("-")[0]
                                == f"{col}_{row}"
                                and os.path.isfile(os.path.join(out_dir, f))
                            ]
                            stem = low_name[0].split(".")[0]
                            sub = os.path.join(out_dir, stem)
                            os.makedirs(sub, exist_ok=True)
                        fname = hi_names.pop(key)
                        shutil.move(os.path.join(hi_dir, fname),
                                    os.path.join(sub, fname))
                        moved.add(key)
    return [(c, r, lab) for c, r, lab in kept_hi if (c, r) in moved]


def append_tile_labels(
    csv_path: str, slide_name: str,
    kept: Sequence[Tuple[int, int, Optional[int]]],
):
    """Single-writer tile_label.csv append ('{slide}_{col}_{row},label')."""
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    with open(csv_path, "a") as f:
        for col, row, label in kept:
            if label is not None:
                f.write(f"{slide_name}_{col}_{row},{label}\n")
