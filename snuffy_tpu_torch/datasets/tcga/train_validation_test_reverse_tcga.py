"""Undo the TCGA fold split, moving slides back to single/<class>/: the
port of the root datasets/tcga/train_validation_test_reverse_tcga.py (the
walk over fold<k>/{train,validation,test}/{0_luad,1_lusc}).

  python -m snuffy_tpu_torch.datasets.tcga.train_validation_test_reverse_tcga
"""

import argparse

from snuffy_tpu_torch.data.splits import reverse_split


def get_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", default="single")
    p.add_argument("--fold", default=1, type=int)
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    moved = reverse_split(
        args.base_dir, classes=("0_luad", "1_lusc"), fold=args.fold
    )
    print(f"Done. {moved} slides moved back.")
    return moved


if __name__ == "__main__":
    main()
