"""Patient-aware 4-fold TCGA split → folds/fold_{i}.csv: the port of the
root datasets/tcga/fold_generator.py.

  python -m snuffy_tpu_torch.datasets.tcga.fold_generator
"""

import argparse

from snuffy_tpu_torch.data.splits import tcga_patient_folds


def get_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--patient_csv", default="single/patients.csv")
    p.add_argument("--out_dir", default="./folds/")
    p.add_argument("--n_splits", default=4, type=int)
    p.add_argument("--val_size", default=0.2, type=float)
    p.add_argument("--seed", default=42, type=int)
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    paths = tcga_patient_folds(args.patient_csv, args.out_dir, args.n_splits,
                               args.val_size, args.seed)
    print(f"Done. Wrote {paths}")
    return paths


if __name__ == "__main__":
    main()
