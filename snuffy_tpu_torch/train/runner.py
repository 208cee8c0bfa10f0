"""Bags to the trainer's buckets: `bucket_bags`, the port's copy of
`snuffy_tpu/train/runner.py:43-77`. The rest of the JAX runner (epochs,
metrics, checkpoints) is not ported yet."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from snuffy_tpu_torch.data.bags import dropout_patches, l2_normalize_rows
from snuffy_tpu_torch.data.bucketing import DEFAULT_BUCKETS, pad_bag


def bucket_bags(
    labels: List[np.ndarray],
    feats: List[np.ndarray],
    l2norm: bool = False,
    dropout_patch: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    buckets=DEFAULT_BUCKETS,
) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Group bags by bucket length → {n_pad: (feats, masks, labels, index)}.

    Applies the reference's per-bag preprocessing: optional row L2-norm
    (train.py:251-252) and dropout_patches augmentation (train.py:253).
    """
    rng = rng or np.random.default_rng()
    groups: Dict[int, list] = {}
    for i, (lab, f) in enumerate(zip(labels, feats)):
        f = np.asarray(f, np.float32)
        if l2norm:
            f = l2_normalize_rows(f)
        if dropout_patch > 0:
            f = dropout_patches(f, dropout_patch, rng)
        padded, mask = pad_bag(f, buckets)
        groups.setdefault(padded.shape[0], []).append(
            (padded, mask, np.asarray(lab, np.float32), i)
        )
    out = {}
    for n_pad, items in groups.items():
        fs, ms, ls, idx = zip(*items)
        out[n_pad] = (
            np.stack(fs),
            np.stack(ms),
            np.stack(ls),
            np.asarray(idx, np.int64),
        )
    return out
