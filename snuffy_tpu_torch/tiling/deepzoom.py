"""What the slide reader needs of the tiler: the port's copy of
`TilerConfig`, `edge_energy` and `pick_read_level` from
`snuffy_tpu/tiling/deepzoom.py:44-113`, and `area_resize`, all in numpy:
the JAX package's cv2 calls become integer arithmetic that gives cv2's
bytes.

The read level is the deepest stored level whose downsample is at most
objective/target magnification; the residual factor is shrunk after the
read (the DeepZoomGenerator arithmetic, reference
deepzoom_tiler_camelyon16.py:219-224). A tile is background when its mean
8-neighbour edge energy is at most the threshold (the PIL FIND_EDGES
rule, reference deepzoom_tiler_camelyon16.py:81-85).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

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
    overlap: int = 0
    image_format: str = "jpeg"


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


def area_resize(tile: np.ndarray, out: int) -> np.ndarray:
    """(n, n, c) uint8 → (out, out, c), as `cv2.resize(tile, (out, out),
    interpolation=cv2.INTER_AREA)` gives it when n is a whole multiple k of
    out: the mean of each k×k block, rounded half up when k is 2 (cv2's
    2×2 path, (s + 2) >> 2) and, for larger k, as cv2 rounds s · (1/k²)
    in f32 (half to even). Other ratios raise ValueError."""
    n = tile.shape[0]
    if tile.shape[1] != n or out <= 0 or n % out:
        raise ValueError(f"area_resize takes whole ratios of a square "
                         f"tile, not {tile.shape[:2]} → {out}")
    k = n // out
    if k == 1:
        return tile.copy()
    s = tile.reshape(out, k, out, k, -1).astype(np.int32).sum(axis=(1, 3))
    if k == 2:
        return ((s + 2) >> 2).astype(np.uint8)
    scaled = s.astype(np.float32) * np.float32(1.0 / (k * k))
    return np.rint(scaled).astype(np.uint8)


def pick_read_level(slide, target_downsample: float) -> Tuple[int, float]:
    """Deepest stored level with downsample ≤ target; returns (level,
    residual factor to shrink by after reading)."""
    best, best_down = 0, 1.0
    for lvl in range(slide.level_count):
        d = slide.level_downsample(lvl)
        if d <= target_downsample + 1e-6 and d > best_down:
            best, best_down = lvl, d
    return best, target_downsample / best_down
