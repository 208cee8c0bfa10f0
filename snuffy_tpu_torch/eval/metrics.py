"""Evaluation metrics: ROC/AUC with optimal thresholds, accuracy, ECE.

The port's copy of `snuffy_tpu/eval/metrics.py`, in numpy alone: the card's
machine has no scikit-learn, so `roc_curve` and `roc_auc_score` are
rebuilt here as scikit-learn 1.9 computes them for binary labels
(`metrics/_ranking.py`), bit for bit:

  * scores sorted descending, ties kept in a stable order; one point per
    distinct score, with true and false positives counted in float64;
  * `drop_intermediate`: points collinear with both neighbours dropped;
  * a first point (0, 0) at threshold +inf, thresholds in float64;
  * a class absent from the labels warns (`UndefinedMetricWarning`) and
    gives NaN rates; the AUC of a one-class split is NaN;
  * the AUC is the trapezoid over the dropped curve.

`optimal_thresh` takes the first argmin over that exact threshold list,
so it must be the same list. `compute_pos_weight` of an empty list
returns 1.0, where the JAX copy raises a TypeError.
"""

from __future__ import annotations

import warnings
from typing import List, Sequence, Tuple

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class UndefinedMetricWarning(UserWarning):
    """A metric is undefined for these labels (scikit-learn's class of the
    same name)."""


def _binary_inputs(y_true, y_score) -> Tuple[np.ndarray, np.ndarray]:
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    if y_true.shape != y_score.shape:
        raise ValueError(f"{y_true.size} labels for {y_score.size} scores")
    for name, a in (("y_true", y_true), ("y_score", y_score)):
        if a.dtype.kind in "fc" and not np.isfinite(a).all():
            raise ValueError(f"Input {name} contains NaN or infinity.")
    if not np.isin(y_true, (0, 1)).all():
        raise ValueError("y_true must hold binary labels 0 and 1")
    return y_true, y_score


def roc_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) of binary labels (positive label 1), as
    `sklearn.metrics.roc_curve(y_true, y_score, pos_label=1)` gives them."""
    y_true, y_score = _binary_inputs(y_true, y_score)
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], (y_true[order] == 1).astype(np.float64)
    distinct = np.nonzero(np.diff(y_score))[0]
    idx = np.concatenate([distinct, [y_true.size - 1]])
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    thresholds = y_score[idx]
    if fps.shape[0] > 2:
        keep = np.nonzero(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]
        ))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    if fps[-1] <= 0:
        warnings.warn("No negative samples in y_true, false positive value "
                      "should be meaningless", UndefinedMetricWarning)
        fpr = np.full(fps.shape, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn("No positive samples in y_true, true positive value "
                      "should be meaningless", UndefinedMetricWarning)
        tpr = np.full(tps.shape, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve of binary labels, as
    `sklearn.metrics.roc_auc_score` gives it: NaN, with a warning, when
    y_true holds one class."""
    y_true, y_score = _binary_inputs(y_true, y_score)
    if len(np.unique(y_true)) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is "
                      "not defined in that case.", UndefinedMetricWarning)
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(_trapezoid(tpr, fpr))


def optimal_thresh(fpr, tpr, thresholds, p: float = 0.0):
    """Threshold minimizing (fpr − tpr) − p·tpr/(fpr+tpr+1)
    (reference utils.py:291-294)."""
    loss = (fpr - tpr) - p * tpr / (fpr + tpr + 1)
    idx = np.argmin(loss, axis=0)
    return fpr[idx], tpr[idx], thresholds[idx]


def multi_label_roc(
    labels: np.ndarray,
    predictions: np.ndarray,
    num_classes: int,
    for_feats: bool = False,
) -> Tuple[List[float], List[np.ndarray], List[float]]:
    """Per-class AUC + optimal thresholds (reference utils.py:253-276)."""
    thresholds, thresholds_optimal, aucs = [], [], []
    if predictions.ndim == 1 and not for_feats:
        predictions = predictions[:, None]
    for c in range(num_classes):
        if for_feats:
            label, prediction = labels, predictions
        else:
            label, prediction = labels[:, c], predictions[:, c]
        fpr, tpr, threshold = roc_curve(label, prediction)
        _, _, threshold_optimal = optimal_thresh(fpr, tpr, threshold)
        aucs.append(roc_auc_score(label, prediction))
        thresholds.append(threshold)
        thresholds_optimal.append(threshold_optimal)
    return aucs, thresholds, thresholds_optimal


def compute_accuracy(
    labels: np.ndarray,
    predictions: np.ndarray,
    thresholds_optimal: Sequence[float],
    num_classes: int,
) -> float:
    """Thresholded bag accuracy (reference train.py:487-505)."""
    labels = np.asarray(labels)
    predictions = np.array(predictions, copy=True)
    if num_classes == 1:
        predictions = predictions.reshape(len(predictions))
        binary = (predictions >= thresholds_optimal[0]).astype(float)
        labels = np.squeeze(labels)
        return float(np.mean(labels == binary))
    for i in range(num_classes):
        predictions[:, i] = (predictions[:, i] >= thresholds_optimal[i]).astype(
            float
        )
    score = sum(
        np.array_equal(labels[i], predictions[i]) for i in range(len(labels))
    )
    return float(score / len(labels))


def compute_pos_weight(labels):
    """BCE positive-class weight (reference utils.py:499-507): (n − pos) /
    pos, accumulated elementwise, so one-hot multiclass labels give a
    per-class float32 vector and a class with no positive bag gets 1.0.
    An empty list gives 1.0 (no bags, no weighting)."""
    pos_count = None
    for label in labels:
        arr = np.clip(np.asarray(label, np.float64), 0, 1)
        pos_count = arr if pos_count is None else pos_count + arr
    if pos_count is None:
        return 1.0
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(
            pos_count > 0, (len(labels) - pos_count) / pos_count, 1.0
        )
    return float(out) if np.ndim(out) == 0 else out.astype(np.float32)


def ece_loss(
    output: np.ndarray,
    labels: np.ndarray,
    threshold: float = 0.5,
    n_bins: int = 15,
    logits: bool = True,
) -> float:
    """Binned Expected Calibration Error (reference metrics.py:7-95).

    output: (n, C) probabilities (or logits when logits=True).
    Confidence = max class probability, flipped to ≥0.5 for the binary case;
    accuracy = per-element thresholded-prediction match; ECE = Σ_b prop_b·
    |conf_b − acc_b| over equal-width bins.
    """
    output = np.asarray(output, dtype=np.float64)
    if output.ndim == 1:
        output = output[:, None]
    labels = np.asarray(labels)
    if logits:
        e = np.exp(output - output.max(axis=1, keepdims=True))
        probabilities = e / e.sum(axis=1, keepdims=True)
    else:
        probabilities = output

    confidences = probabilities.max(axis=1)
    confidences = np.where(confidences < 0.5, 1.0 - confidences, confidences)
    predictions = (probabilities >= threshold).astype(float)
    accuracies = np.equal(predictions, labels.reshape(predictions.shape))

    bin_boundaries = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    for lo, hi in zip(bin_boundaries[:-1], bin_boundaries[1:]):
        in_bin = (confidences > lo) & (confidences <= hi)
        prop = float(np.mean(in_bin))
        if prop > 0:
            acc = float(np.mean(accuracies[in_bin]))  # over rows and classes
            conf = float(np.mean(confidences[in_bin]))
            ece += prop * abs(conf - acc)
    return float(ece)
