"""Patch feature extraction CLI on the GPU: JPEG bags → embedder → CSVs.

The port of the root `compute_feats.py`, with its flags plus `--device`
(default cuda; there is no silent fall back to the CPU). The embedders
are the root's: SimCLR ResNet-18 (the default; `--norm_layer` instance or
batch), the DINO ViTs (± adapter) and the MAE ViT-B/L encoders. Run from
the repository root:

  python -m snuffy_tpu_torch.compute_feats --weights simclr.pth \
      --dataset camelyon16
  python -m snuffy_tpu_torch.compute_feats --embedder DINO \
      --backbone vit_small --patch_size 8 --use_adapter \
      --weights dino_adapter.pth --dataset camelyon16
  python -m snuffy_tpu_torch.compute_feats --embedder MAE \
      --backbone mae_vit_base_patch16 --weights mae.pth

Reads `<datasets_path>/<dataset>/single/<fold>/**/<bag>/*.jpeg` and writes
`<embeddings_path>/<dataset>/<embedder>[_<version>]/<split>/<class>/<bag>.csv`,
the per-class CSVs and the shuffled `<dataset>.csv` the MIL trainer reads,
and `embedder.pth`: the backbone's state dict under its family's names
(torchvision's, DINO's or MAE's), which `--weights` here and
`--embedder_weights` of `predict_slide` load. `--weights` is overlaid as
the root CLI does (`embed.torch_import.load_embedder_weights`): every
tensor whose name and shape match, with the layer audit printed.

Several GPUs: `torchrun --nproc_per_node N -m snuffy_tpu_torch.compute_feats
...` runs one process a GPU (`parallel/distributed.py`); each rank embeds
every N-th bag and writes its CSVs, then rank 0 alone writes
`embedder.pth`, the per-class CSVs and the dataset CSV, the same bytes as
one process writes. The output directory is shared by the ranks.
"""

from __future__ import annotations

import argparse
import os
import warnings

import torch

from snuffy_tpu_torch.embed.pipeline import (
    extract_dataset,
    save_class_features,
    write_dataset_csv,
)
from snuffy_tpu_torch.embed.registry import build_embedder
from snuffy_tpu_torch.embed.torch_import import load_embedder_weights
from snuffy_tpu_torch.predict_slide import resolve_device


def get_args_parser():
    """The root compute_feats.py's flags (help shortened), plus --device."""
    parser = argparse.ArgumentParser(description="WSI Patch Embedder")
    parser.add_argument("--embedder", default="SimCLR", type=str,
                        choices=["SimCLR", "DINO", "MAE"])
    parser.add_argument("--num_classes", default=2, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--num_workers", default=8, type=int)
    parser.add_argument("--gpu_index", type=int, nargs="+", default=(0,))
    parser.add_argument("--backbone", default="resnet18", type=str,
                        choices=["resnet18", "vit_small", "vit_base",
                                 "mae_vit_base_patch16",
                                 "mae_vit_large_patch16"])
    parser.add_argument("--norm_layer", default="instance", type=str,
                        choices=["instance", "batch"])
    parser.add_argument("--weights", default=None, type=str,
                        help="path to pretrained embedder weights (.pth)")
    parser.add_argument("--version_name", default="", type=str)
    parser.add_argument("--dataset", default="camelyon16", type=str)
    parser.add_argument("--fold", default="fold1", type=str)
    parser.add_argument("--num_processes", default=1, type=int)
    parser.add_argument("--adapter_ffn_scalar", default=4, type=float)
    parser.add_argument("--ffn_num", default=64, type=int)
    parser.add_argument("--drop_path_rate", default=0.0, type=float)
    parser.add_argument("--patch_size", default=16, type=int)
    parser.add_argument("--use_adapter", default=False, action="store_true")
    parser.add_argument("--compute_dtype", default="bfloat16", type=str,
                        choices=["float32", "bfloat16"],
                        help="the embedder's compute dtype on device "
                             "(embeddings are written in f32)")
    parser.add_argument("--transform", default=0, type=int,
                        help="1 → ImageNet normalization")
    parser.add_argument("--droped", default=0, type=int,
                        help="non-zero skips writing the [bag_path,label] "
                             "CSV tree (reference compute_feats.py:573)")
    parser.add_argument("--norm_pix_loss", default=0)
    parser.add_argument("--datasets_path", default="datasets", type=str)
    parser.add_argument("--embeddings_path", default="embeddings", type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; cuda raises when no GPU is "
                             "present")
    return parser


def validate_args(args):
    if args.norm_layer == "instance" and "simclr" not in args.embedder.lower():
        warnings.warn(
            "norm_layer=instance is the DSMIL-SimCLR convention; check that "
            "your pretrained model used InstanceNorm2d too"
        )


def class_labels_of(fold_root: str) -> dict:
    """Class subdirectories of single/<fold> (or of its train/valid/test
    splits) → integer labels in sorted order (reference
    compute_feats.py:596-616)."""
    if not os.path.isdir(fold_root):
        return {}
    names = sorted(d for d in os.listdir(fold_root)
                   if os.path.isdir(os.path.join(fold_root, d)))
    if names and set(names) & {"train", "valid", "test"}:
        nested = set()
        for split in names:
            split_dir = os.path.join(fold_root, split)
            nested.update(d for d in os.listdir(split_dir)
                          if os.path.isdir(os.path.join(split_dir, d)))
        names = sorted(nested)
    return {c: i for i, c in enumerate(names)}


def build_and_load_embedder(args, device: torch.device):
    """The embedder the flags name, on `device`, with `args.weights`
    overlaid (the root compute_feats.py's `build_and_load_embedder`; also
    the ROI CLI's). `compute_dtype` and `transform` default to f32 and
    none when `args` lacks them."""
    embedder = build_embedder(
        args.embedder, args.backbone, num_classes=args.num_classes,
        patch_size=args.patch_size, use_adapter=args.use_adapter,
        adapter_ffn_num=args.ffn_num,
        adapter_ffn_scalar=args.adapter_ffn_scalar,
        norm_layer=args.norm_layer,
        compute_dtype=getattr(args, "compute_dtype", "float32"),
        imagenet_norm=bool(getattr(args, "transform", 0)), device=device,
    )
    if args.weights:
        load_embedder_weights(embedder.backbone, args.weights, args.embedder,
                              args.backbone, args.norm_layer)
    return embedder


def main(argv=None):
    """The CLI: the bootstrap (nothing without torchrun's environment),
    then `extract`."""
    from snuffy_tpu_torch.parallel import distributed

    args = get_args_parser().parse_args(argv)
    with distributed.session(device=args.device):
        return extract(args)


def extract(args):
    """Every bag's CSV, then (rank 0) the per-class CSVs and the dataset
    CSV. Over several ranks each embeds every W-th bag; the gather of the
    rows in `extract_dataset` waits for all of them before rank 0 lists
    the tree."""
    from snuffy_tpu_torch.parallel import distributed

    validate_args(args)
    device = resolve_device(str(distributed.rank_device(args.device)))
    embedder = build_and_load_embedder(args, device)

    dataset_path = os.path.join(args.datasets_path, args.dataset)
    version = (f"{args.embedder}"
               f"{('_' + args.version_name) if args.version_name else ''}")
    out_dir = os.path.join(args.embeddings_path, args.dataset, version)
    tile_label_csv = os.path.join(dataset_path, "tile_label.csv")
    if not os.path.exists(tile_label_csv):
        tile_label_csv = None
    class_labels = class_labels_of(
        os.path.join(dataset_path, "single", args.fold))
    print(f"class labels: {class_labels}")

    os.makedirs(out_dir, exist_ok=True)
    if distributed.is_primary():
        torch.save(embedder.backbone.state_dict(),
                   os.path.join(out_dir, "embedder.pth"))
    rows = extract_dataset(
        embedder, dataset_path, args.fold, out_dir,
        class_labels=class_labels, tile_label_csv=tile_label_csv,
        batch_size=args.batch_size, num_workers=max(args.num_workers, 0),
    )
    if not distributed.is_primary():
        print(f"extracted {len(rows)} bags (rank {distributed.rank()}'s "
              f"share written) → {out_dir}")
        return rows
    # The per-class CSVs and the shuffled dataset CSV, gated on --droped;
    # a fold without a split/class layout gets the flat dataset CSV.
    shuffled = save_class_features(out_dir, f"{args.dataset}.csv",
                                   droped=args.droped, seed=0)
    if shuffled is None and args.droped == 0:
        write_dataset_csv(os.path.join(out_dir, f"{args.dataset}.csv"), rows)
    print(f"extracted {len(rows)} bags → {out_dir}")
    return rows


if __name__ == "__main__":
    main()
