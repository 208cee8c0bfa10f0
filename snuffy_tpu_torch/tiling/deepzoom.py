"""What the slide reader needs of the tiler: the port's copy of
`TilerConfig`, `edge_energy` and `pick_read_level` from
`snuffy_tpu/tiling/deepzoom.py:44-113`.

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

EDGE_KERNEL = np.array(
    [[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], dtype=np.float32
)


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
    """Mean |8-neighbour Laplacian| over the grayscale tile."""
    import cv2

    gray = cv2.cvtColor(tile, cv2.COLOR_RGB2GRAY).astype(np.float32)
    edges = cv2.filter2D(gray, -1, EDGE_KERNEL)
    return float(np.abs(edges).mean())


def pick_read_level(slide, target_downsample: float) -> Tuple[int, float]:
    """Deepest stored level with downsample ≤ target; returns (level,
    residual factor to shrink by after reading)."""
    best, best_down = 0, 1.0
    for lvl in range(slide.level_count):
        d = slide.level_downsample(lvl)
        if d <= target_downsample + 1e-6 and d > best_down:
            best, best_down = lvl, d
    return best, target_downsample / best_down
