"""Classic MIL benchmark datasets (MUSK1/2, Elephant/Fox/Tiger): the
trainer-side loader.

The port's copy of `snuffy_tpu/data/mil_pickle.py:21-44,136-174`
(reference utils.py:425-496): the k-fold pickle
`{stem}_{k}folds_{r}split.pkl` under `<base>/<Folder>/`, a list of
[bag_label, array of instance vectors], split into train, valid and test
bags. The SVM parser and the pickle writer are not copied.
"""

from __future__ import annotations

import itertools
import os
import pickle
from copy import deepcopy
from typing import List, Tuple

import numpy as np

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
