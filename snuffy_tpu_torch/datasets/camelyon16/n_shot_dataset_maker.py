"""Sample ≤N patches per slide into single/fold1_{N}shot: the port of the
root datasets/camelyon16/n_shot_dataset_maker.py, with its flags.

  python -m snuffy_tpu_torch.datasets.camelyon16.n_shot_dataset_maker
"""

import argparse

from snuffy_tpu_torch.data.splits import n_shot_subset


def get_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--src", default="single/fold1/train")
    p.add_argument("--dst", default=None)
    p.add_argument("--num_files", default=5, type=int)
    p.add_argument("--seed", default=None, type=int)
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    dst = args.dst or f"{args.src}_{args.num_files}shot"
    total = n_shot_subset(args.src, dst, args.num_files, args.seed)
    print(f"Done. {total} patches copied to {dst}.")
    return total


if __name__ == "__main__":
    main()
