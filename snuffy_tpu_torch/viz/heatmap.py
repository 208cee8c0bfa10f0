"""Attention/score heat maps over whole slides.

The port of `snuffy_tpu/viz/heatmap.py` (reference roi.py:230-294
`blend_and_visualize` and utils.py:297-310 `visualize_attentions`): patch
scores are scattered into a (rows, cols) grid by their tile positions,
min-max rescaled, coloured with matplotlib's `jet`, resized onto a slide
thumbnail and blended over its gray levels with an optional tumour-mask
contour, then written as a PNG (`viz.png`).

The JAX module's cv2 and matplotlib calls become numpy twins that give
their bytes: `mask_contour` (cv2's 3×3 MORPH_GRADIENT, then a 3×3 dilate,
with cv2's default morphology borders: erosion does not erode at the image
edge and dilation does not grow from outside it), `resize_nearest`
(cv2.resize INTER_NEAREST: source index floor(i · src/dst)), `JET_LUT`
(matplotlib's 256-entry `jet` table, built from its segment data as
`LinearSegmentedColormap` builds it) and `jet_colors` (index int(x·256)
with 1.0 in the top entry, values outside [0, 1] clipped, NaN
transparent black).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from snuffy_tpu_torch.viz.png import write_png

_POS_RE = re.compile(r"[^\d]*(\d+)[^\d]*(\d+)")

# matplotlib's `jet` segment data (matplotlib/_cm.py) and table size
# (rcParams["image.lut"]).
JET_DATA = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
              (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.00, 0, 0)),
}
LUT_SIZE = 256


def _lookup_table(n: int, data) -> np.ndarray:
    """matplotlib's `_create_lookup_table` for segment data, gamma 1."""
    adata = np.array(data)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n) ** 1.0
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([
        [y1[0]],
        distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
        [y0[-1]],
    ])
    return np.clip(lut, 0.0, 1.0)


def _jet_lut() -> np.ndarray:
    """(N + 3, 4) f64: the N colours, then under (the first), over (the
    last) and bad (transparent black), as a fresh matplotlib Colormap."""
    lut = np.ones((LUT_SIZE + 3, 4), float)
    for i, name in enumerate(("red", "green", "blue")):
        lut[:-3, i] = _lookup_table(LUT_SIZE, JET_DATA[name])
    lut[-3] = lut[0]
    lut[-2] = lut[LUT_SIZE - 1]
    lut[-1] = 0.0
    return lut


JET_LUT = _jet_lut()


def jet_colors(x: np.ndarray, as_bytes: bool = False) -> np.ndarray:
    """`matplotlib.colormaps["jet"](x, bytes=as_bytes)` for a float array:
    (..., 4) RGBA, f64 in [0, 1] or uint8."""
    xa = np.array(x, copy=True)
    xa *= LUT_SIZE
    xa[xa == LUT_SIZE] = LUT_SIZE - 1
    under, over, bad = xa < 0, xa >= LUT_SIZE, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = LUT_SIZE
    idx[over] = LUT_SIZE + 1
    idx[bad] = LUT_SIZE + 2
    lut = (JET_LUT * 255).astype(np.uint8) if as_bytes else JET_LUT
    return lut.take(idx, axis=0, mode="clip")


def parse_positions(position_strings: Sequence[str]) -> List[Tuple[int, int]]:
    """'col_row' strings → [(col, row)] (reference train.py:312-320 regex)."""
    out = []
    for s in position_strings:
        m = _POS_RE.search(str(s))
        out.append((int(m.group(1)), int(m.group(2))) if m else (0, 0))
    return out


def scores_to_grid(
    positions: Sequence[Tuple[int, int]],
    scores: np.ndarray,
    grid_shape: Optional[Tuple[int, int]] = None,
    return_occupancy: bool = False,
):
    """Scatter per-patch scores into a (rows, cols) float grid. Scores are
    min-max rescaled over the occupied cells (reference roi.py:246-258
    rescales instance logits to a color map). Empty cells hold 0, which is
    NOT a score — pass `return_occupancy=True` to also get the (rows, cols)
    bool occupancy mask (the reference overlays only occupied tiles)."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    if grid_shape is None:
        rows = max(r for _, r in positions) + 1
        cols = max(c for c, _ in positions) + 1
    else:
        rows, cols = grid_shape
    grid = np.zeros((rows, cols), np.float64)
    occ = np.zeros((rows, cols), bool)
    lo, hi = scores.min(), scores.max()
    scaled = (scores - lo) / (hi - lo) if hi > lo else np.zeros_like(scores)
    for (col, row), v in zip(positions, scaled):
        if 0 <= row < rows and 0 <= col < cols:
            grid[row, col] = v
            occ[row, col] = True
    if return_occupancy:
        return grid, occ
    return grid


def _window3(m: np.ndarray, border: int, op) -> np.ndarray:
    """op (max or min) over each pixel's 3×3 window, outside pixels
    `border`."""
    h, w = m.shape
    pad = np.pad(m, 1, constant_values=border)
    out = pad[0:h, 0:w].copy()
    for i in range(3):
        for j in range(3):
            out = op(out, pad[i:i + h, j:j + w])
    return out


def mask_contour(mask: np.ndarray) -> np.ndarray:
    """Binary mask → contour band (the reference's FIND_EDGES + MaxFilter,
    roi.py:268-275): cv2's 3×3 MORPH_GRADIENT, dilated by 3×3, > 0."""
    m = (mask > 0).astype(np.uint8)
    edges = _window3(m, 0, np.maximum) - _window3(m, 1, np.minimum)
    return _window3(edges, 0, np.maximum) > 0


def resize_nearest(src: np.ndarray, w: int, h: int) -> np.ndarray:
    """`cv2.resize(src, (w, h), interpolation=cv2.INTER_NEAREST)`: output
    (y, x) takes source (min(floor(y·sh/h), sh − 1), min(floor(x·sw/w),
    sw − 1)), the scale taken as cv2 takes it, 1/(dst/src) in f64."""
    sh, sw = src.shape[:2]
    ifx, ify = 1.0 / (w / sw), 1.0 / (h / sh)
    xs = np.minimum(np.floor(np.arange(w) * ifx).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * ify).astype(np.int64), sh - 1)
    return src[ys[:, None], xs[None, :]]


def blend_heatmap(
    slide_gray: np.ndarray,        # (H, W) uint8 grayscale thumbnail
    grid: np.ndarray,              # (rows, cols) scores in [0, 1]
    contour: Optional[np.ndarray] = None,   # (H, W) bool
    alpha: float = 0.5,
    colormap: str = "jet",
    occupancy: Optional[np.ndarray] = None,  # (rows, cols) bool
) -> np.ndarray:
    """Colormapped score grid resized onto the thumbnail → RGB uint8.

    Cells without any patch (background / filtered tiles) stay the bare
    grayscale slide instead of being painted as score-0 "cold" — the
    reference overlays only occupied tiles (roi.py:246-258)."""
    if colormap != "jet":
        raise ValueError(f"colormap {colormap!r}: only jet is built in")
    h, w = slide_gray.shape[:2]
    heat = resize_nearest(grid.astype(np.float32), w, h)
    rgba = jet_colors(heat)
    heat_rgb = (rgba[..., :3] * 255).astype(np.uint8)
    base = np.stack([slide_gray] * 3, axis=-1).astype(np.float32)
    out = (1 - alpha) * base + alpha * heat_rgb.astype(np.float32)
    if occupancy is not None:
        occ_px = resize_nearest(occupancy.astype(np.uint8), w,
                                h).astype(bool)
        out = np.where(occ_px[..., None], out, base)
    out = out.astype(np.uint8)
    if contour is not None:
        out[contour] = (0, 255, 0)
    return out


def grid_rgba(grid: np.ndarray) -> np.ndarray:
    """The grid as `plt.imsave(path, grid, cmap="jet")` colours it: min-max
    normalised in f64 (all 0 when flat), jet bytes."""
    g = np.asarray(grid, np.float64)
    lo, hi = g.min(), g.max()
    norm = np.zeros_like(g) if lo == hi else (g - lo) / (hi - lo)
    return jet_colors(norm, as_bytes=True)


def visualize_attentions(
    scores: np.ndarray,
    position_strings: Sequence[str],
    out_path: str,
    slide_gray: Optional[np.ndarray] = None,
    tumor_mask: Optional[np.ndarray] = None,
):
    """Save a heatmap PNG for one bag (reference utils.py:297-310 /
    roi.py:230-294): the blend over the thumbnail, or without one the raw
    grid in jet, as RGBA (the pixels `plt.imsave` writes). Returns the
    grid."""
    positions = parse_positions(position_strings)
    grid, occ = scores_to_grid(positions, scores, return_occupancy=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if slide_gray is not None:
        contour = mask_contour(tumor_mask) if tumor_mask is not None else None
        img = blend_heatmap(slide_gray, grid, contour, occupancy=occ)
        rgba = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    else:
        rgba = grid_rgba(grid)
    write_png(out_path, rgba)
    return grid
