"""SSL representation evaluation: weighted kNN, PCA whitening, mAP.

The port's copy of `snuffy_tpu/ssl/retrieval.py`, numpy alone: the
reference's DINO evaluation helpers (reference dino_adapter/utils.py:670-830:
PCA whitening, retrieval average precision) and DINO's weighted-kNN probe,
which score an embedder checkpoint without training a head.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def knn_classify(
    train_feats: np.ndarray,    # (N, D) L2-normalized or raw
    train_labels: np.ndarray,   # (N,)
    test_feats: np.ndarray,     # (M, D)
    k: int = 20,
    temperature: float = 0.07,
    num_classes: int | None = None,
) -> np.ndarray:
    """DINO's weighted kNN: cosine similarity, exp(sim/T)-weighted votes of
    the k nearest train samples. Returns predicted labels (M,)."""
    def l2(x):
        return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)

    tr, te = l2(train_feats), l2(test_feats)
    sims = te @ tr.T                                     # (M, N)
    k = min(k, tr.shape[0])
    idx = np.argpartition(-sims, k - 1, axis=1)[:, :k]   # (M, k)
    top_sims = np.take_along_axis(sims, idx, axis=1)
    top_labels = train_labels[idx]
    weights = np.exp(top_sims / temperature)
    c = num_classes or int(train_labels.max()) + 1
    votes = np.zeros((te.shape[0], c))
    for cls in range(c):
        votes[:, cls] = np.sum(weights * (top_labels == cls), axis=1)
    return votes.argmax(axis=1)


class PCA:
    """PCA with optional whitening (reference dino_adapter/utils.py PCA):
    fit on (N, D), apply as projection to `dim` components."""

    def __init__(self, dim: int = 256, whit: float = 0.5):
        self.dim = dim
        self.whit = whit
        self.mean: np.ndarray | None = None
        self.dvt: np.ndarray | None = None

    def train_pca(self, feats: np.ndarray):
        self.mean = feats.mean(axis=0)
        x = feats - self.mean
        cov = (x.T @ x) / max(x.shape[0] - 1, 1)
        eigval, eigvec = np.linalg.eigh(cov)
        order = np.argsort(-eigval)
        eigval = np.clip(eigval[order][: self.dim], 1e-12, None)
        eigvec = eigvec[:, order][:, : self.dim]
        self.dvt = (eigvec / (eigval[None, :] ** self.whit)).T  # (dim, D)

    def apply(self, feats: np.ndarray) -> np.ndarray:
        return (feats - self.mean) @ self.dvt.T


def compute_ap(ranks: np.ndarray, num_positive: int) -> float:
    """Average precision from the sorted ranks of the positives (reference
    dino_adapter/utils.py compute_ap: trapezoidal precision interpolation)."""
    if num_positive == 0:
        return 0.0
    ap = 0.0
    recall_step = 1.0 / num_positive
    for i, rank in enumerate(np.sort(np.asarray(ranks))):
        precision_0 = i / rank if rank > 0 else 1.0
        precision_1 = (i + 1) / (rank + 1)
        ap += (precision_0 + precision_1) * recall_step / 2.0
    return ap


def compute_map(
    ranked_lists: Sequence[np.ndarray],   # per query: DB indices best→worst
    positives: Sequence[set],             # per query: set of positive DB ids
) -> Tuple[float, List[float]]:
    """Mean average precision over queries."""
    aps = []
    for ranked, pos in zip(ranked_lists, positives):
        pos_ranks = np.asarray(
            [i for i, db_id in enumerate(ranked) if db_id in pos]
        )
        aps.append(compute_ap(pos_ranks, len(pos)))
    return float(np.mean(aps)) if aps else 0.0, aps


def retrieval_map(
    query_feats: np.ndarray,
    db_feats: np.ndarray,
    positives: Sequence[set],
) -> float:
    """Cosine-similarity retrieval → mAP."""
    def l2(x):
        return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)

    sims = l2(query_feats) @ l2(db_feats).T
    ranked = np.argsort(-sims, axis=1)
    m, _ = compute_map(list(ranked), positives)
    return m
