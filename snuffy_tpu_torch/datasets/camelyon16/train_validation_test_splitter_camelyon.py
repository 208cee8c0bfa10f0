"""Split tiled Camelyon16 slides into single/fold1/{train,validation,test}:
the port of the root datasets/camelyon16/
train_validation_test_splitter_camelyon.py. Run from datasets/camelyon16/
with reference.csv and single/ present:

  python -m snuffy_tpu_torch.datasets.camelyon16.train_validation_test_splitter_camelyon
"""

import argparse

from snuffy_tpu_torch.data.splits import apply_split, camelyon16_split_slides


def get_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--reference", default="reference.csv")
    p.add_argument("--base_dir", default="single")
    p.add_argument("--fold", default=1, type=int)
    p.add_argument("--val_size", default=0.2, type=float)
    p.add_argument("--seed", default=42, type=int)
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    split = camelyon16_split_slides(args.reference, args.val_size, args.seed)
    rows = apply_split(args.base_dir, split, fold=args.fold)
    print(f"Done. {len(rows)} slides split; see fold{args.fold}.csv")
    return rows


if __name__ == "__main__":
    main()
