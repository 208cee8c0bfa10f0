"""Bag-of-embeddings IO and per-bag preprocessing of the MIL trainer.

The port's copy of `snuffy_tpu/data/bags.py`. Artifact layout (reference
utils.py:138-211):
  - dataset CSV: rows = [path_to_bag_feats_csv, label] under a header row;
  - per-bag CSV: columns 0..D−1 [+ 'label' + 'position'].

Loading shuffles each bag's rows with its own seeded generator (reference
utils.py:158) and builds one-hot labels for multiclass. Feature-only CSVs
go through the native strtof parser, as in the JAX package; CSVs with
label/position columns through the csv module in place of pandas, which
parses each float to float64 and then casts it to float32, as pandas'
reader does. A process pool parses the bags (reference utils.py:221-234);
its workers are spawned, so a process that has started CUDA can load.
"""

from __future__ import annotations

import csv
import multiprocessing as mp
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from snuffy_tpu_torch import native


class BagData(NamedTuple):
    """One loaded split: the reference's positional tuple (labels, feats,
    feats_labels, positions, slide_names), which the Runner takes."""

    labels: List[np.ndarray]           # each (C,)
    feats: List[np.ndarray]            # each (N_i, D) float32
    feats_labels: Optional[List[np.ndarray]]  # each (N_i,) or None
    positions: Optional[List[List[str]]]
    slide_names: List[str]


def _one_hot_label(raw_label, num_classes: int) -> np.ndarray:
    label = np.zeros(num_classes, dtype=np.float32)
    if num_classes == 1:
        label[0] = float(raw_label)
    else:
        idx = int(raw_label)
        if idx <= num_classes - 1:
            label[idx] = 1.0
    return label


def parse_number(cell: str):
    """A CSV cell as pandas types its column: int when it reads as one,
    else float."""
    try:
        return int(cell)
    except ValueError:
        return float(cell)


def read_csv_rows(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header, rows) of a CSV, blank lines skipped as pandas skips them."""
    with open(path, newline="") as f:
        header, *rows = [r for r in csv.reader(f) if r]
    return header, rows


def load_bag_csv(
    feats_csv_path: str,
    raw_label,
    num_classes: int,
    shuffle_rows: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[List[str]]]:
    """Read one bag CSV → (label (C,), feats (N, D), feats_labels,
    positions)."""
    rng = rng or np.random.default_rng()
    label = _one_hot_label(raw_label, num_classes)
    with open(feats_csv_path) as f:
        header = f.readline().strip().split(",")
    if not ("position" in header and "label" in header):
        feats = native.parse_bag_csv_fast(feats_csv_path)
        if shuffle_rows:
            feats = feats[rng.permutation(len(feats))]
        return label, feats, None, None

    header, rows = read_csv_rows(feats_csv_path)
    if shuffle_rows:
        rows = [rows[i] for i in rng.permutation(len(rows))]
    i_label, i_pos = header.index("label"), header.index("position")
    feat_cols = [j for j in range(len(header)) if j not in (i_label, i_pos)]
    feats = np.array([[float(r[j]) for j in feat_cols] for r in rows],
                     np.float64).astype(np.float32)
    feats = feats.reshape(len(rows), len(feat_cols))
    feats_labels = np.array([parse_number(r[i_label]) for r in rows])
    positions = [r[i_pos] for r in rows]
    return label, feats, feats_labels, positions


def _load_one(args):
    path, raw_label, num_classes, seed = args
    rng = np.random.default_rng(seed)
    label, feats, feats_labels, positions = load_bag_csv(
        path, raw_label, num_classes, rng=rng
    )
    slide_name = os.path.basename(path).rsplit(".", 1)[0]
    return label, feats, feats_labels, positions, slide_name


def load_split(
    rows: Sequence[Tuple[str, object]],
    num_classes: int,
    num_processes: int = 8,
    use_mp: bool = True,
    seed: Optional[int] = None,
) -> BagData:
    """Load every bag of a split: `rows` are the dataset CSV's
    (path, label) rows. Bag i's rows are shuffled by a generator seeded
    with the i-th word of SeedSequence(seed), as the JAX loader does."""
    if not rows:
        raise ValueError("a split with no bags")
    seeds = np.random.SeedSequence(seed).generate_state(len(rows))
    jobs = [(path, label, num_classes, int(s))
            for (path, label), s in zip(rows, seeds)]
    if use_mp and len(jobs) > 1:
        native.get_lib()  # build once, before the workers load it
        with mp.get_context("spawn").Pool(processes=num_processes) as pool:
            results = pool.map(_load_one, jobs)
    else:
        results = [_load_one(j) for j in jobs]

    labels, feats, feats_labels, positions, names = map(list, zip(*results))
    if any(fl is None for fl in feats_labels):
        feats_labels, positions = None, None
    return BagData(labels, feats, feats_labels, positions, names)


def split_rows_by_folder(
    rows: Sequence[Sequence], path_prefix: str
) -> Tuple[List, List, List]:
    """Train/valid/test rows of a dataset CSV by path prefix: the rows whose
    path starts with `{path_prefix}/train`, `/valid` and `/test`
    (`snuffy_tpu/data/bags.py` `split_dataframe_by_folder` on the
    DataFrame of the same rows; reference train.py:586-593)."""
    return tuple(
        [r for r in rows if r[0].startswith(f"{path_prefix}/{name}")]
        for name in ("train", "valid", "test")
    )


def split_rows_by_ratio(
    rows: Sequence[Sequence], split: float
) -> Tuple[List, List, List]:
    """The first ⌊n·(1−split)⌋ rows train, the rest halved into valid and
    test (`snuffy_tpu/data/bags.py` `split_dataframe_by_ratio`; reference
    train.py:595-602)."""
    rows = list(rows)
    n_train = int(len(rows) * (1 - split))
    rest = rows[n_train:]
    half = len(rest) // 2
    return rows[:n_train], rest[:half], rest[half:]


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
