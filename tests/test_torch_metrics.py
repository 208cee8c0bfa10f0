"""The port's numpy metrics against scikit-learn and `snuffy_tpu.eval.metrics`.

The ROC curve, its thresholds and the AUC are held bit for bit: the
optimal threshold is the first argmin over the threshold list, so the
list itself must be scikit-learn's (ties collapsed, collinear points
dropped, +inf first, float64).
"""

import warnings

import numpy as np
import pytest
from sklearn import metrics as skm

from snuffy_tpu.eval import metrics as jax_metrics
from snuffy_tpu_torch.eval import metrics


def cases():
    rng = np.random.default_rng(0)
    out = []
    for i in range(40):
        n = int(rng.integers(2, 60))
        y = (np.arange(n) % 2).astype(np.float32)
        rng.shuffle(y)
        if i % 4 == 0:       # many ties: a few distinct scores
            s = rng.integers(0, 4, n).astype(np.float32) / 3
        elif i % 4 == 1:     # collinear stretches: sorted by label
            s = np.sort(rng.random(n)).astype(np.float32)
            y = np.sort(y)
        else:
            s = rng.random(n).astype(np.float32)
        out.append((y, s))
    out.append((np.array([0, 1, 0, 1], np.float32),
                np.full(4, 0.5, np.float32)))          # constant scores
    out.append((np.array([0, 1], np.float32), np.array([0.2, 0.9],
                                                       np.float32)))
    return out


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a, b, equal_nan=True))


@pytest.mark.parametrize("case", range(len(cases())))
def test_roc_curve_and_auc_are_sklearns_bitwise(case):
    y, s = cases()[case]
    want = skm.roc_curve(y, s, pos_label=1)
    got = metrics.roc_curve(y, s)
    assert all(same(a, b) for a, b in zip(got, want))
    auc = metrics.roc_auc_score(y, s)
    assert type(auc) is float and auc == skm.roc_auc_score(y, s)


@pytest.mark.parametrize("labels", [[1, 1, 1], [0, 0, 0, 0]])
def test_one_class_gives_nan_as_sklearn_does(labels):
    """scikit-learn 1.9 warns and returns NaN for a one-class split; the
    curve's rates are NaN and the first argmin takes the +inf threshold."""
    y = np.array(labels, np.float32)[:, None]
    s = np.linspace(0.1, 0.9, len(labels)).astype(np.float32)[:, None]
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = metrics.multi_label_roc(y, s, 1)
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jax_metrics.multi_label_roc(y, s, 1)
    assert np.isnan(got[0][0]) and np.isnan(want[0][0])
    assert got[2] == want[2] == [np.inf]
    assert same(got[1][0], want[1][0])
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]
    assert all(issubclass(w.category, UserWarning) for w in got_w)


def test_bad_inputs_raise_value_error_as_sklearn_does():
    for y, s in (([0, 1], [0.1, np.nan]), ([0, 0.5], [0.1, 0.2])):
        with pytest.raises(ValueError):
            skm.roc_curve(np.array(y), np.array(s), pos_label=1)
        with pytest.raises(ValueError):
            metrics.roc_curve(np.array(y), np.array(s))


@pytest.mark.parametrize("num_classes", [1, 3])
def test_multi_label_roc_matches_jax(num_classes):
    rng = np.random.default_rng(num_classes)
    n = 37
    if num_classes == 1:
        labels = (rng.random((n, 1)) < 0.4).astype(np.float32)
    else:
        labels = np.eye(num_classes, dtype=np.float32)[
            np.arange(n) % num_classes]
    preds = rng.random((n, num_classes)).astype(np.float32)
    preds[::5] = preds[1::5][: len(preds[::5])]  # tied rows
    got = metrics.multi_label_roc(labels, preds, num_classes)
    want = jax_metrics.multi_label_roc(labels, preds, num_classes)
    assert got[0] == want[0] and got[2] == want[2]
    assert all(same(a, b) for a, b in zip(got[1], want[1]))
    for th in (got[2], [0.5] * num_classes):
        assert metrics.compute_accuracy(labels, preds, th, num_classes) == \
            jax_metrics.compute_accuracy(labels, preds, th, num_classes)


def test_for_feats_matches_jax():
    rng = np.random.default_rng(5)
    labels = (rng.random(300) < 0.2).astype(float)
    scores = np.round(rng.random(300), 2).astype(np.float32)  # ties
    got = metrics.multi_label_roc(labels, scores, 1, for_feats=True)
    want = jax_metrics.multi_label_roc(labels, scores, 1, for_feats=True)
    assert got[0] == want[0] and got[2] == want[2]
    assert same(got[1][0], want[1][0])


@pytest.mark.parametrize("shape, logits", [((50,), False), ((50, 1), False),
                                           ((50, 3), False), ((50, 3), True)])
def test_ece_matches_jax(shape, logits):
    rng = np.random.default_rng(len(shape) + logits)
    out = (rng.standard_normal(shape) if logits
           else rng.random(shape)).astype(np.float32)
    labels = (rng.random(shape) < 0.5).astype(np.float32)
    for bins in (10, 15):
        assert metrics.ece_loss(out, labels, 0.5, bins, logits) == \
            jax_metrics.ece_loss(out, labels, 0.5, bins, logits)


def test_compute_pos_weight_matches_jax_and_takes_an_empty_list():
    binary = [np.array([1.0], np.float32), np.array([0.0], np.float32),
              np.array([0.0], np.float32)]
    onehot = [np.eye(3, dtype=np.float32)[i % 2] for i in range(5)]
    for labels in (binary, onehot, [np.float32(1.0), np.float32(0.0)]):
        got = metrics.compute_pos_weight(labels)
        want = jax_metrics.compute_pos_weight(labels)
        assert type(got) is type(want)
        assert same(got, want)
    assert metrics.compute_pos_weight(onehot)[2] == 1.0  # absent class
    with pytest.raises(TypeError):
        jax_metrics.compute_pos_weight([])
    assert metrics.compute_pos_weight([]) == 1.0
