"""Undo the fold split, moving slides back to single/<class>/: the port of
the root datasets/camelyon16/train_validation_test_reverse_camelyon.py.

  python -m snuffy_tpu_torch.datasets.camelyon16.train_validation_test_reverse_camelyon
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
    moved = reverse_split(args.base_dir, fold=args.fold)
    print(f"Done. {moved} slides moved back.")
    return moved


if __name__ == "__main__":
    main()
