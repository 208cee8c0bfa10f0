"""MIL training CLI of the port: `python -m snuffy_tpu_torch.train ...`.

The root train.py's flags, same names and defaults (reference
train.py:54-135), plus `--device` (default `cuda`; `--device cpu` runs the
kernels' plain versions on the CPU). Examples (the README's recipes):

  python -m snuffy_tpu_torch.train --dataset=musk1 --arch=snuffy \\
      --num_heads=2 --soft_average=1
  python -m snuffy_tpu_torch.train --dataset=camelyon16 \\
      --embedding=dino_vits --arch=snuffy --feats_size=384 --num_heads=4 \\
      --big_lambda=500 --random_patch_share=0.5 --lr=0.02 \\
      --optimizer=adamw --weight_decay=0.05 --soft_average=1
  python -m snuffy_tpu_torch.train --dataset=tcga \\
      --arch=snuffy_multiclass --num_classes=2 ...

Data: classic MIL pickles under `datasets/mil_dataset/`, or bag CSVs
under `embeddings/<dataset>/<embedding>/` with `<dataset>.csv` listing
them (split by path into train/valid/test), or with `--embedding
official`, `embeddings/<dataset>/official/<Dataset>.csv` split by
`--split`. Runs, checkpoints and metrics go to `runs/<dataset>/<run>/`.

Flags that select machinery only the JAX package has are accepted at
their defaults and refused at any other value: `--bag_batch_impl vmap`
and `--use_pallas 0` on the card (the card runs the attention kernels; the
CPU runs their plain versions whatever the flag). `--gpu_index` picks the
card when `--device` is `cuda`; `--num_processes` is the loader's pool
size; `--wandb_run` names the run.

Several GPUs: `torchrun --nproc_per_node N -m snuffy_tpu_torch.train ...
--bag_batch_size B` runs one process a GPU (`parallel/distributed.py`,
each rank on `cuda:LOCAL_RANK`); with B a multiple of N each packed step
of B bags splits into B/N bags a rank and one optimizer step, and rank 0
alone writes the run's files. Otherwise every rank runs the whole run.
`--use_mesh 1` factors the N ranks into dp × sp × tp
(`parallel/mesh.factor_devices`, the hosts from torchrun's
LOCAL_WORLD_SIZE): sp takes 2 where a host's ranks are even (each bag's
rows split over 2 ranks), tp 2 where 8 or more remain (the encoder's
heads and FFN columns split), dp the rest, and B must divide over dp.
`--remat 1` recomputes each encoder layer's activations in the backward.
rank 0 writes one whole-model `.pth`, which the one-card CLIs load.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Sequence, Tuple

import torch

from snuffy_tpu_torch.configs import (
    HISTOPATHOLOGY_DATASETS,
    MIL_DATASETS,
    MILTrainConfig,
    OptimizerConfig,
    SnuffyModelConfig,
    parse_literal_flag,
    replace,
    resolve_feats_size,
)
from snuffy_tpu_torch.data.bags import load_split, parse_number, read_csv_rows
from snuffy_tpu_torch.data.mil_pickle import load_mil_data
from snuffy_tpu_torch.parallel import distributed
from snuffy_tpu_torch.train.runner import Runner
from snuffy_tpu_torch.train.schedules import make_epoch_schedule
from snuffy_tpu_torch.train.trainer import SnuffyTrainer
from snuffy_tpu_torch.utils.logging import MetricsLogger


def get_args_parser():
    parser = argparse.ArgumentParser(
        description="Train MIL models on patch features (PyTorch/CUDA Snuffy)"
    )
    parser.add_argument("--num_classes", default=1, type=int)
    parser.add_argument("--feats_size", default=512, type=int)
    parser.add_argument("--lr", default=2e-4, type=float)
    parser.add_argument("--num_epochs", default=200, type=int)
    parser.add_argument("--gpu_index", type=int, nargs="+", default=(0,),
                        help="the card to train on, with --device cuda")
    parser.add_argument("--weight_decay", default=5e-3, type=float)
    parser.add_argument("--eta_min", default=5e-6, type=float)
    parser.add_argument("--dataset", default="camelyon16", type=str)
    parser.add_argument("--embedding", default="SimCLR", type=str)
    parser.add_argument("--split", default=0.2, type=float)
    parser.add_argument("--dropout_patch", default=0, type=float)
    parser.add_argument(
        "--weight_init__weight_init_i__weight_init_b",
        default="['xavier_normal', 'xavier_normal', 'xavier_normal']",
    )
    parser.add_argument("--optimizer", default="adam", type=str,
                        choices=["adam", "adamw"])
    parser.add_argument("--scheduler", default="cosine", type=str,
                        choices=["cosinewarmup", "cosine"])
    parser.add_argument("--num_processes", default=8, type=int)
    parser.add_argument("--wandb_run", default=None)
    parser.add_argument("--use_mp", default=1, choices=[0, 1], type=int)
    parser.add_argument("--arch", default="snuffy", type=str)
    parser.add_argument("--bins", default=10, type=int)
    # MIL datasets (Musk1, Musk2, Elephant)
    parser.add_argument("--cv_num_folds", default=10, type=int)
    parser.add_argument("--cv_current_fold", default=0, type=int)
    parser.add_argument("--cv_valid_ratio", default=0.2, type=float)
    # SmallWeight
    parser.add_argument("--soft_average", default=0, choices=[0, 1], type=int)
    parser.add_argument("--single_weight__lr_multiplier", default=0.1,
                        type=float)
    # Snuffy
    parser.add_argument("--num_heads", default=6, type=int)
    parser.add_argument("--big_lambda", default=200, type=int, help="top k")
    parser.add_argument("--random_patch_share", default=0.0, type=float)
    parser.add_argument("--mlp_multiplier", default=4, type=int)
    parser.add_argument("--encoder_dropout", default=0.0, type=float)
    parser.add_argument("--activation", default="relu", type=str)
    parser.add_argument("--clip_grad", default=None, type=float)
    parser.add_argument("--depth", default=1, type=int)
    parser.add_argument("--betas", default="[0.5, 0.9]")
    # ROC dumps
    parser.add_argument("--roc_run_name", type=str, default=None)
    parser.add_argument("--roc_run_epoch", type=int, default=None)
    parser.add_argument("--roc_data_split", default="test", type=str,
                        choices=["train", "valid", "test"])
    parser.add_argument("--l2normed_embeddings", default=0, type=int)
    parser.add_argument("--seed", default=1, type=int)
    # the JAX package's machinery: accepted at its defaults only
    parser.add_argument("--use_pallas", default=1, choices=[0, 1], type=int,
                        help="1: the attention kernels on the card (0 is "
                             "refused there; the CPU runs the plain "
                             "versions)")
    parser.add_argument("--bag_batch_size", default=1, type=int,
                        help="bags per optimizer step (1 = reference serial"
                             " semantics; >1 = bags packed on the row axis,"
                             " one step a chunk)")
    parser.add_argument("--bag_batch_impl", default="packed",
                        choices=["packed", "vmap"],
                        help="packed only ('vmap' is the JAX package's)")
    parser.add_argument("--use_mesh", default=None, type=int,
                        choices=[0, 1],
                        help="unset: a dp mesh over the ranks when "
                             "bag_batch_size divides over them; 0: none; "
                             "1: the dp*sp*tp factoring of the ranks")
    parser.add_argument("--remat", default=0, choices=[0, 1], type=int,
                        help="rematerialise each encoder layer in the "
                             "backward (torch.utils.checkpoint)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (the card, --gpu_index) or cpu")
    return parser


def build_config(args) -> MILTrainConfig:
    inits = parse_literal_flag(args.weight_init__weight_init_i__weight_init_b)
    betas = parse_literal_flag(args.betas)
    feats_size = resolve_feats_size(args.dataset, args.feats_size)

    model = SnuffyModelConfig(
        feats_size=feats_size,
        num_classes=args.num_classes,
        num_heads=args.num_heads,
        big_lambda=args.big_lambda,
        random_patch_share=args.random_patch_share,
        mlp_multiplier=args.mlp_multiplier,
        encoder_dropout=args.encoder_dropout,
        activation=args.activation,
        depth=args.depth,
        multiclass=(args.arch == "snuffy_multiclass"),
        weight_init_i=inits[1],
        weight_init_b=inits[2],
        use_pallas=bool(args.use_pallas),
        remat=bool(args.remat),
    )
    optim = OptimizerConfig(
        optimizer=args.optimizer,
        lr=args.lr,
        betas=tuple(betas),
        weight_decay=args.weight_decay,
        eta_min=args.eta_min,
        scheduler=args.scheduler,
        clip_grad=args.clip_grad,
        single_weight_lr_multiplier=args.single_weight__lr_multiplier,
    )
    return MILTrainConfig(
        model=model,
        optim=optim,
        num_epochs=args.num_epochs,
        dataset=args.dataset,
        embedding=args.embedding,
        split=args.split,
        dropout_patch=args.dropout_patch,
        l2normed_embeddings=bool(args.l2normed_embeddings),
        soft_average=bool(args.soft_average),
        num_processes=args.num_processes,
        use_mp=bool(args.use_mp),
        bins=args.bins,
        seed=args.seed,
        arch=args.arch,
        cv_num_folds=args.cv_num_folds,
        cv_current_fold=args.cv_current_fold,
        cv_valid_ratio=args.cv_valid_ratio,
        run_name=args.wandb_run,
        roc_run_name=args.roc_run_name,
        roc_run_epoch=args.roc_run_epoch,
        roc_data_split=args.roc_data_split,
        bag_batch_size=args.bag_batch_size,
        bag_batch_impl=args.bag_batch_impl,
        use_mesh=args.use_mesh,
    )


def resolve_device(args) -> torch.device:
    """The training device; refuses what the port cannot run."""
    refused = [
        (args.bag_batch_impl != "packed",
         "--bag_batch_impl vmap maps a per-bag graph with jax.vmap; the "
         "port packs bags on the row axis (packed)"),
    ]
    device = distributed.rank_device(args.device)
    if device.type == "cuda":
        if len(args.gpu_index) != 1:
            raise ValueError(f"--gpu_index {args.gpu_index}: the port trains "
                             "on one card a process")
        if device.index is None:
            device = torch.device("cuda", args.gpu_index[0])
        refused.append((
            args.use_pallas == 0,
            "--use_pallas 0 would run the attention without its kernels; on "
            "the card the port runs the CUDA kernels only"))
    for bad, why in refused:
        if bad:
            raise ValueError(why)
    return device


def _split_by_ratio(rows: List, split: float) -> Tuple[List, List, List]:
    """The 'official' split (reference train.py:595-602): the first
    ⌊n·(1−split)⌋ rows train, the rest halved into valid and test."""
    n_train = int(len(rows) * (1 - split))
    rest = rows[n_train:]
    return rows[:n_train], rest[: len(rest) // 2], rest[len(rest) // 2:]


def _split_by_folder(rows: List, prefix: str) -> Tuple[List, ...]:
    """Train/valid/test by normalised path prefix (reference
    train.py:586-593: 'valid' is a prefix of a 'validation' folder too)."""
    prefix_abs = os.path.abspath(prefix)
    return tuple(
        [r for r in rows
         if os.path.abspath(r[0]).startswith(os.path.join(prefix_abs, name))]
        for name in ("train", "valid", "test")
    )


def load_datasets(cfg: MILTrainConfig):
    """(train, valid, test) bag tuples per the reference's source layout
    (reference train.py:529-602)."""
    if cfg.dataset in MIL_DATASETS:
        return load_mil_data(
            cfg.dataset,
            cfg.model.feats_size,
            cfg.cv_num_folds,
            cfg.cv_current_fold,
            cfg.cv_valid_ratio,
        )
    if cfg.dataset not in HISTOPATHOLOGY_DATASETS:
        raise SystemExit(f"Unknown dataset {cfg.dataset}")

    if cfg.embedding == "official":
        _, rows = read_csv_rows(os.path.join(
            cfg.embeddings_path, cfg.dataset, "official",
            f"{cfg.dataset.capitalize()}.csv",
        ))
        splits = _split_by_ratio(rows, cfg.split)
    else:
        prefix = os.path.join(".", cfg.embeddings_path, cfg.dataset,
                              cfg.embedding)
        _, rows = read_csv_rows(os.path.join(prefix, f"{cfg.dataset}.csv"))
        splits = _split_by_folder(rows, prefix)

    return tuple(
        load_split(
            [(r[0], parse_number(r[1])) for r in rows],
            cfg.model.num_classes,
            num_processes=cfg.num_processes,
            use_mp=cfg.use_mp,
            seed=cfg.seed,
        )
        for rows in splits
    )


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = get_args_parser().parse_args(argv)
    with distributed.session(device=args.device):
        return train(args)


def train(args) -> dict:
    cfg = build_config(args)
    device = resolve_device(args)
    if cfg.arch not in ("snuffy", "snuffy_multiclass"):
        raise SystemExit(
            f"Architecture not found. Given: {cfg.arch}, "
            f"Have: ['snuffy', 'snuffy_multiclass']"
        )

    t0 = time.perf_counter()
    train_data, valid_data, test_data = load_datasets(cfg)
    load_s = time.perf_counter() - t0
    print(
        f"Num Bags (Train: {len(train_data[0])}) "
        f"(Valid: {len(valid_data[0])}) (Test: {len(test_data[0])})"
    )

    if cfg.run_name is None:
        cfg = replace(cfg, run_name=f"{cfg.arch}_seed{cfg.seed}")
    trainer = SnuffyTrainer(cfg, device)
    logger = MetricsLogger(
        path=os.path.join(cfg.save_path, cfg.dataset, cfg.run_name,
                          "metrics.jsonl")
    )
    runner = Runner(cfg, trainer, train_data, valid_data, test_data, logger)
    runner.timings["load_s"] = load_s
    schedule = make_epoch_schedule(
        cfg.optim.scheduler, cfg.optim.lr, cfg.num_epochs, cfg.optim.eta_min
    )
    summary = runner.run(schedule)
    print(
        f"best epoch {summary['best_epoch']} "
        f"valid AUC {summary['best_valid_auc']:.4f}"
    )
    return summary
