"""Build the k-fold MIL pickle from an SVM-format dataset file: the port of
the root datasets/mil_dataset/mil_cross_validation.py (parse → admissible
shuffle, both classes in every fold's every split → pickle).

  python -m snuffy_tpu_torch.datasets.mil_dataset.mil_cross_validation \
      --dataset musk1 --base_path datasets/mil_dataset
"""

import argparse

import numpy as np

from snuffy_tpu_torch.data.mil_pickle import build_mil_pickle


def get_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="musk1",
                   choices=["musk1", "musk2", "elephant", "fox", "tiger"])
    p.add_argument("--num_folds", default=10, type=int)
    p.add_argument("--valid_ratio", default=0.2, type=float)
    p.add_argument("--base_path", default="./")
    p.add_argument("--seed", default=None, type=int)
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    rng = np.random.default_rng(args.seed)
    out = build_mil_pickle(args.dataset, args.num_folds, args.valid_ratio,
                           args.base_path, rng=rng)
    print(f"Done. Wrote {out}")
    return out


if __name__ == "__main__":
    main()
