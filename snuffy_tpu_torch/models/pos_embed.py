"""Fixed 2-D sine-cosine positional embeddings (MAE-style).

Semantics of the reference's sin-cos grid (reference
mae_adapter/util/pos_embed.py, used at models_mae.py:87-96): half the
channels encode the grid row, half the column; each half splits into
sin/cos of geometrically-spaced frequencies (base 10000). Computed once in
numpy at model build — never on device.
"""

from __future__ import annotations

import numpy as np


def sincos_1d(dim: int, positions: np.ndarray) -> np.ndarray:
    assert dim % 2 == 0
    omega = 1.0 / (10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)))
    out = np.einsum("p,d->pd", positions.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int, cls_token: bool = True) -> np.ndarray:
    """(1, [1+]grid², embed_dim) float32.

    Channel layout matches the MAE reference exactly: its
    `np.meshgrid(grid_w, grid_h)` ('w goes first') puts the COLUMN
    coordinate in the first half of the channels and the row in the second
    (reference mae_adapter/util/pos_embed.py:27-47) — required for
    checkpoint-interoperable embeddings.
    """
    assert embed_dim % 2 == 0
    coords = np.arange(grid_size, dtype=np.float64)
    gy, gx = np.meshgrid(coords, coords, indexing="ij")
    emb = np.concatenate(
        [sincos_1d(embed_dim // 2, gx), sincos_1d(embed_dim // 2, gy)], axis=1
    )
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb[None].astype(np.float32)
