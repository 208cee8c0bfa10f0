"""Per-bag preprocessing of the MIL trainer: the port's copy of
`snuffy_tpu/data/bags.py:156-174` (reference train.py:251-253)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def l2_normalize_rows(feats: np.ndarray) -> np.ndarray:
    """Per-patch L2 norm (reference train.py:251-252)."""
    return feats / np.linalg.norm(feats, axis=1, keepdims=True)


def dropout_patches(
    feats: np.ndarray, p: float, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Drop-and-repad patch augmentation (reference utils.py:244-250):
    keep a (1−p) sample, then append p·N rows re-sampled from the keepers
    so the bag size is preserved."""
    if p <= 0:
        return feats
    rng = rng or np.random.default_rng()
    n = feats.shape[0]
    keep = rng.choice(np.arange(n), int(n * (1 - p)), replace=False)
    sampled = feats[keep]
    pad = rng.choice(np.arange(sampled.shape[0]), int(n * p), replace=False)
    return np.concatenate([sampled, sampled[pad]], axis=0)
