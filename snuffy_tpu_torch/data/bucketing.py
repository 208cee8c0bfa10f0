"""Ragged bag → fixed-length bucket: the port's copy of
`snuffy_tpu/data/bucketing.py`.

Each bag (N, D) is padded to the smallest bucket length strictly greater
than N (so at least one padding row always exists: dead selection slots
scatter into it) and paired with a validity mask. Buckets grow by at most
4/3, so padding waste stays bounded and the shapes stay few.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# {16, 20, 24}·2^k, 16 .. 49152; 10240 holds a ~10k-tile slide.
DEFAULT_BUCKETS = tuple(
    sorted(m * 2**i for m in (16, 20, 24) for i in range(12))
)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket strictly greater than n (≥1 guaranteed pad row)."""
    for b in buckets:
        if b > n:
            return b
    raise ValueError(f"bag of {n} patches exceeds largest bucket {buckets[-1]}")


def pad_bag(
    feats: np.ndarray, buckets: Sequence[int] = DEFAULT_BUCKETS
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (N, D) to (bucket, D) and return (padded, mask)."""
    n, d = feats.shape
    b = bucket_length(n, buckets)
    padded = np.zeros((b, d), dtype=feats.dtype)
    padded[:n] = feats
    mask = np.zeros(b, dtype=bool)
    mask[:n] = True
    return padded, mask
