"""Classic MIL benchmark datasets (MUSK1/2, Elephant/Fox/Tiger).

The port's copy of `snuffy_tpu/data/mil_pickle.py`: the SVM-format parser
and the k-fold pickle writer (reference datasets/mil_dataset/
mil_cross_validation.py:13-158), and the trainer-side loader (reference
utils.py:425-496). The pickle `{stem}_{k}folds_{r}split.pkl` under
`<base>/<Folder>/` is a list of [bag_label, array of instance vectors],
split into train, valid and test bags.
"""

from __future__ import annotations

import itertools
import os
import pickle
from copy import deepcopy
from pathlib import Path
from typing import List, Tuple

import numpy as np

MIL_DATASET_REGISTRY = {
    "musk1": ("Musk", "musk1norm.svm", 166),
    "musk2": ("Musk", "musk2norm.svm", 166),
    "elephant": ("Elephant", "data_100x100.svm", 230),
    "fox": ("Fox", "data_100x100.svm", 230),
    "tiger": ("Tiger", "data_100x100.svm", 230),
}

# Trainer-side file-name mapping (reference utils.py:470-483).
MIL_FILE_STEMS = {
    "musk1": "musk1norm",
    "musk2": "musk2norm",
    "elephant": "data_100x100",
    "fox": "data_100x100",
    "tiger": "data_100x100",
}
MIL_FOLDER_NAMES = {
    "musk1": "Musk",
    "musk2": "Musk",
    "elephant": "Elephant",
    "fox": "Fox",
    "tiger": "Tiger",
}


def parse_svm_file(file_path: str) -> List[list]:
    """Parse `ID:BagID:ClassID f:v f:v ...` rows (the header line is skipped,
    matching the reference's pd.read_csv treatment of the first row)."""
    entries = []
    with open(file_path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for ln in lines[1:]:  # first line consumed as header by the reference
        parts = ln.split(" ")
        ids = parts[0].split(":")
        instance_id, bag_id, class_id = int(ids[0]), int(ids[1]), int(ids[2])
        vec = np.zeros(len(parts) - 1)
        for i, feat in enumerate(parts[1:]):
            fv = feat.split(":")
            if len(fv) == 2:
                vec[i] = float(fv[1])
        entries.append([instance_id, bag_id, class_id, vec])
    return entries


def bags_from_entries(entries: List[list]) -> List[list]:
    """Group instance rows into [bag_label, stacked-instance-array] bags."""
    num_bags = entries[-1][1] + 1
    bags = []
    for b in range(num_bags):
        rows = [e for e in entries if e[1] == b]
        label = rows[0][2]
        vectors = np.array([r[3] for r in rows], dtype=object)
        bags.append([label, vectors])
    return bags


def cross_validation_set(
    bag_ins_list, num_folds: int, current_fold: int, valid_ratio: float
):
    """k-fold split with a held-out test chunk (reference utils.py:452-466)."""
    csv_list = deepcopy(bag_ins_list)
    n = int(len(csv_list) / num_folds)
    chunked = [csv_list[i : i + n] for i in range(0, len(csv_list), n)]
    test_list = chunked.pop(current_fold)
    train_valid = list(itertools.chain.from_iterable(chunked))
    cut = int(len(train_valid) * (1 - valid_ratio))
    return train_valid[:cut], train_valid[cut:], test_list


def find_admissible_shuffle(
    bag_ins_list, num_folds: int, valid_ratio: float, rng=None, max_tries=10000
):
    """Shuffle until every fold's train/valid/test all contain both classes
    (reference mil_cross_validation.py:54-92)."""
    rng = rng or np.random.default_rng()
    for _ in range(max_tries):
        perm = rng.permutation(len(bag_ins_list))
        candidate = [bag_ins_list[i] for i in perm]
        ok = True
        for k in range(num_folds):
            tr, va, te = cross_validation_set(candidate, num_folds, k, valid_ratio)
            for split in (tr, va, te):
                lab = [int(np.clip(b[0], 0, 1)) for b in split]
                if not (0 in lab and 1 in lab):
                    ok = False
                    break
            if not ok:
                break
        if ok:
            return candidate
    raise RuntimeError("no admissible shuffle found")


def build_mil_pickle(
    dataset: str,
    num_folds: int = 10,
    valid_ratio: float = 0.2,
    datasets_base_path: str = "./",
    rng=None,
) -> str:
    """SVM file → admissible shuffle → pickle, reference-compatible name."""
    folder, svm_file, _ = MIL_DATASET_REGISTRY[dataset]
    entries = parse_svm_file(os.path.join(datasets_base_path, folder, svm_file))
    bags = bags_from_entries(entries)
    bags = find_admissible_shuffle(bags, num_folds, valid_ratio, rng=rng)
    out = os.path.join(
        datasets_base_path,
        folder,
        f"{Path(svm_file).stem}_{num_folds}folds_{valid_ratio}split.pkl",
    )
    with open(out, "wb") as f:
        pickle.dump(bags, f)
    return out


def convert_to_bag_arrays(
    bag_ins_list, feats_size: int
) -> Tuple[List[np.ndarray], List[np.ndarray], None, None]:
    """[label, instance-vectors] → (labels (1,), feats (N, D)) lists
    (reference utils.py:425-449). Labels are clipped to {0,1}."""
    all_labels, all_feats = [], []
    for bag_label, bag_vector in bag_ins_list:
        label = np.expand_dims(
            np.array(int(np.clip(bag_label, 0, 1)), dtype=np.float32), axis=0
        )
        feats = np.stack(list(bag_vector))[:, :feats_size].astype(np.float32)
        all_labels.append(label)
        all_feats.append(feats)
    return all_labels, all_feats, None, None


def load_mil_data(
    dataset: str,
    feats_size: int,
    cv_num_folds: int = 10,
    cv_current_fold: int = 0,
    cv_valid_ratio: float = 0.2,
    mil_datasets_base_path: str = "./datasets/mil_dataset",
):
    """Load the pickle and return (train, valid, test) bag tuples
    (reference utils.py:469-496). The pickle is the dataset's own file:
    unpickling runs what it holds, so load only files made by the pickle
    writer."""
    stem = MIL_FILE_STEMS[dataset]
    folder = MIL_FOLDER_NAMES[dataset]
    fname = f"{stem}_{cv_num_folds}folds_{cv_valid_ratio}split.pkl"
    with open(os.path.join(mil_datasets_base_path, folder, fname), "rb") as f:
        bag_ins_list = pickle.load(f)
    tr, va, te = cross_validation_set(
        bag_ins_list, cv_num_folds, cv_current_fold, cv_valid_ratio
    )
    return (
        convert_to_bag_arrays(tr, feats_size),
        convert_to_bag_arrays(va, feats_size),
        convert_to_bag_arrays(te, feats_size),
    )
