"""Apply a generated TCGA fold CSV to the tiled single/ tree: the port of
the root datasets/tcga/train_validation_test_splitter_tcga.py.

  python -m snuffy_tpu_torch.datasets.tcga.train_validation_test_splitter_tcga
"""

import argparse

from snuffy_tpu_torch.data.splits import apply_split, split_from_fold_csv


def get_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--fold_csv", default="folds/fold_0.csv")
    p.add_argument("--base_dir", default="single")
    p.add_argument("--fold", default=1, type=int)
    p.add_argument("--classes", nargs="+", default=["0_luad", "1_lusc"])
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    split = split_from_fold_csv(args.fold_csv)
    rows = apply_split(args.base_dir, split, classes=args.classes,
                       fold=args.fold)
    print(f"Done. {len(rows)} slides split.")
    return rows


if __name__ == "__main__":
    main()
