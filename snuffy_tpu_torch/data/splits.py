"""Dataset management: split/fold/n-shot reorganisation of tiled datasets.

The port's copy of `snuffy_tpu/data/splits.py` (the reference's datasets/
scripts), without pandas or scikit-learn:
  * Camelyon16's official split (test_* slides) and an 80/20 train/valid
    split of the rest (reference datasets/camelyon16/
    train_validation_test_splitter_camelyon.py), and its reverse;
  * TCGA's patient-aware 4-fold KFold → folds/fold_{i}.csv (reference
    datasets/tcga/fold_generator.py:11-22) and the fold-applying splitter;
  * n-shot patch subsets (≤ N patches a slide, reference
    datasets/camelyon16/n_shot_dataset_maker.py).

`train_test_split` and `kfold` are numpy twins of scikit-learn's
`train_test_split` and `KFold(shuffle=True)`: the same RandomState draws,
so the same index lists. The CSVs are read and written with the csv
module in pandas' bytes (`to_csv(index=False)`: minimal quoting, "\\n"
line ends, an empty cell where a column is shorter).
"""

from __future__ import annotations

import csv
import math
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np

SPLIT_NAMES = ("train", "validation", "test")


def _random_state(seed) -> np.random.RandomState:
    """scikit-learn's check_random_state for None or an int."""
    if seed is None:
        return np.random.mtrand._rand
    return np.random.RandomState(seed)


def train_test_split_indices(n: int, test_size: float, seed=None):
    """(train, test) index arrays of `sklearn.model_selection.
    train_test_split` over n items with a float test share: ceil(share·n)
    test items, the rest train, from one RandomState permutation."""
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be in (0, 1)")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"with n_samples={n} and test_size={test_size}, "
                         "the train set would be empty")
    perm = _random_state(seed).permutation(n)
    return perm[n_test:n_test + n_train], perm[:n_test]


def train_test_split(items, test_size: float = 0.25, random_state=None):
    """[train, test] of `items` as scikit-learn's train_test_split gives
    them: lists for a list, arrays for an array."""
    train, test = train_test_split_indices(len(items), test_size,
                                           random_state)
    if isinstance(items, np.ndarray):
        return [items[train], items[test]]
    return [[items[i] for i in train], [items[i] for i in test]]


def kfold(n: int, n_splits: int, seed=None):
    """[(train, test)] index arrays of `KFold(n_splits, shuffle=True,
    random_state=seed).split` over n items: one RandomState shuffle of
    arange(n), folds of n // k (the first n % k one larger), each index
    list in ascending order."""
    if n_splits > n:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} "
                         f"greater than the number of samples: n_samples={n}")
    indices = np.arange(n)
    _random_state(seed).shuffle(indices)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    out, start = [], 0
    for size in sizes:
        mask = np.zeros(n, bool)
        mask[indices[start:start + size]] = True
        out.append((np.arange(n)[~mask], np.arange(n)[mask]))
        start += size
    return out


def read_csv_columns(path: str) -> Dict[str, List[Optional[str]]]:
    """A CSV with a header row → column → cells (None for an empty cell),
    in file order."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return {}
    header, body = rows[0], rows[1:]
    return {name: [(row[i] if i < len(row) and row[i] != "" else None)
                   for row in body]
            for i, name in enumerate(header)}


def write_csv_columns(path: str, columns: Dict[str, Sequence]) -> None:
    """Columns (of any lengths) → a CSV with a header row, in pandas'
    `to_csv(index=False)` bytes: a shorter column leaves empty cells, and
    no column writes one empty line."""
    n = max((len(v) for v in columns.values()), default=0)
    with open(path, "w", newline="") as f:
        if not columns:
            f.write("\n")
            return
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(columns))
        for i in range(n):
            w.writerow([v[i] if i < len(v) else "" for v in columns.values()])


def camelyon16_split_slides(
    reference_csv: str, val_size: float = 0.2, seed: int = 42
) -> Dict[str, List[str]]:
    """Official CAMELYON16 split: test_* slides are the test set; the
    normal_*/tumor_* slides split 80/20 into train/validation."""
    names = [re.sub(r"\.tiff?$", "", s)
             for s in read_csv_columns(reference_csv)["image"]]
    train_val = [s for s in names if not s.startswith("test")]
    test = [s for s in names if s.startswith("test")]
    train, val = train_test_split(train_val, test_size=val_size,
                                  random_state=seed)
    return {"train": list(train), "validation": list(val), "test": test}


def apply_split(
    base_dir: str,
    split: Dict[str, List[str]],
    classes: Sequence[str] = ("0_normal", "1_tumor"),
    fold: int = 1,
) -> List[Dict[str, str]]:
    """Move single/<class>/<slide> → single/fold{n}/<split>/<class>/<slide>
    and write fold{n}/fold{n}.csv. Returns the manifest rows."""
    fold_dir = os.path.join(base_dir, f"fold{fold}")
    rows = []
    for split_name, slides in split.items():
        for cls in classes:
            for slide in slides:
                src = os.path.join(base_dir, cls, slide)
                if not os.path.exists(src):
                    continue
                dst = os.path.join(fold_dir, split_name, cls, slide)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.move(src, dst)
                rows.append(
                    {"name": slide, "split": split_name, "label": cls[0]}
                )
    os.makedirs(fold_dir, exist_ok=True)
    columns = ({k: [r[k] for r in rows] for k in ("name", "split", "label")}
               if rows else {})
    write_csv_columns(os.path.join(fold_dir, f"fold{fold}.csv"), columns)
    return rows


def reverse_split(
    base_dir: str,
    classes: Sequence[str] = ("0_normal", "1_tumor"),
    fold: int = 1,
) -> int:
    """Undo apply_split: move slides back to single/<class>/ (reference
    train_validation_test_reverse_camelyon.py). Returns slides moved."""
    fold_dir = os.path.join(base_dir, f"fold{fold}")
    moved = 0
    for split_name in SPLIT_NAMES:
        for cls in classes:
            cls_dir = os.path.join(fold_dir, split_name, cls)
            if not os.path.isdir(cls_dir):
                continue
            for slide in os.listdir(cls_dir):
                src = os.path.join(cls_dir, slide)
                dst = os.path.join(base_dir, cls, slide)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.move(src, dst)
                moved += 1
    return moved


def tcga_patient_folds(
    patient_csv: str,
    out_dir: str,
    n_splits: int = 4,
    val_size: float = 0.2,
    seed: int = 42,
) -> List[str]:
    """Patient-aware k-fold: KFold over unique patients, 80/20 train/val of
    each fold's train patients, slides resolved per patient (reference
    datasets/tcga/fold_generator.py:11-42). Writes fold_{i}.csv files with
    columns train/validation/test. Patient and slide ids are read as
    text."""
    table = read_csv_columns(patient_csv)
    patients, slides = table["patient"], table["slide"]
    unique_patients = np.unique(np.array(patients, dtype=object))

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (train_index, test_index) in enumerate(
            kfold(len(unique_patients), n_splits, seed)):
        train_index, val_index = train_test_split(
            train_index, test_size=val_size, random_state=seed
        )
        columns = {}
        for name, idx in (("train", train_index), ("validation", val_index),
                          ("test", test_index)):
            pats = set(unique_patients[idx])
            columns[name] = [s for p, s in zip(patients, slides)
                             if p in pats]
        path = os.path.join(out_dir, f"fold_{i}.csv")
        write_csv_columns(path, {n: columns[n] for n in SPLIT_NAMES})
        paths.append(path)
    return paths


def split_from_fold_csv(fold_csv: str) -> Dict[str, List[str]]:
    """fold_{i}.csv → split → its slides, empty cells dropped."""
    table = read_csv_columns(fold_csv)
    return {
        name: [s for s in table[name] if s is not None]
        for name in SPLIT_NAMES
        if name in table
    }


def n_shot_subset(
    src_dir: str,
    dst_dir: str,
    num_files: int = 5,
    seed: Optional[int] = None,
    copy: bool = True,
) -> int:
    """Sample ≤num_files patches per slide into a parallel tree (reference
    n_shot_dataset_maker.py). Returns total patches copied."""
    rng = np.random.default_rng(seed)
    total = 0
    for cls in sorted(os.listdir(src_dir)):
        cls_dir = os.path.join(src_dir, cls)
        if not os.path.isdir(cls_dir):
            continue
        for slide in sorted(os.listdir(cls_dir)):
            slide_dir = os.path.join(cls_dir, slide)
            if not os.path.isdir(slide_dir):
                continue
            out = os.path.join(dst_dir, cls, slide)
            os.makedirs(out, exist_ok=True)
            patches = sorted(
                f for f in os.listdir(slide_dir)
                if f.endswith((".jpeg", ".jpg"))
            )
            pick = rng.choice(
                len(patches), min(num_files, len(patches)), replace=False
            )
            for i in pick:
                op = shutil.copy if copy else shutil.move
                op(os.path.join(slide_dir, patches[i]),
                   os.path.join(out, patches[i]))
                total += 1
    return total
