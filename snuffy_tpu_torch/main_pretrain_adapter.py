"""MAE-with-adapter pretraining CLI on the GPU.

The port of the root `main_pretrain_adapter.py` (the reference's
`python mae_adapter/main_pretrain_adapter.py`), with its flags plus
`--device` (default cuda; there is no silent fall back to the CPU):

  python -m snuffy_tpu_torch.main_pretrain_adapter \\
      --data_path <ImageFolder> --output_dir runs/mae_adapter

A step: the host decodes a uint8 batch at `--raw_input_size`
(`ssl.data.ImageBatcher`), the device crops, flips and normalises it
(`--device_augment`), and `ssl.mae_trainer.MAETrainer` masks, encodes,
decodes, takes the reconstruction loss and the masked AdamW step over the
adapters (± the decoder linears). The learning rate is `--lr`, else
blr · batch / 256 over the global batch, on the half-cycle cosine with
warmup, per step by the epoch fraction. Each epoch appends a JSON row to
`log.txt` (`val_loss` over at most 10 batches of `--valid_data_path`,
through the same random transform, as the reference) and writes, in the
reference's torch layout (loadable with `torch.load(...,
weights_only=True)`):

  checkpoint.pth              every epoch, for resuming
  checkpoint-best-{epoch}.pth  when the val loss (else the train loss)
                              improves; the previous best is deleted

each {model: the state dict under the MAE checkpoint's names, the decoder
included; optimizer: Adam's moments of the trainable parameters and its
shared count; step; epoch: the epoch just finished; args: the flags, as a
dict}. A run whose `--output_dir` holds `checkpoint.pth` resumes after
its epoch, the optimizer's state included, keeps `log.txt` to one row an
epoch, and reseeds its generator at seed + start_epoch. The encoder loads
into the extraction CLI: `python -m snuffy_tpu_torch.compute_feats
--embedder MAE --backbone mae_vit_base_patch16 --weights
<output_dir>/checkpoint-best-<epoch>.pth`.

`--finetune` starts from a published MAE `.pth` (encoder, mask token and
decoder; the adapters it lacks keep their init); with linears from
scratch, its `decoder_embed` and `decoder_pred` are not taken.
`--num_workers` is the decode's thread count.

Several GPUs, data-parallel: `torchrun --nproc_per_node N -m
snuffy_tpu_torch.main_pretrain_adapter ...` runs one process a GPU
(`parallel/distributed.py`); without torchrun's environment it is one
process. Each rank takes every N-th image, `--batch_size` images a step,
and averages the gradients with the others; the ranks agree on the steps
an epoch and the validation batches (the fewest any rank has), blr scales
by the global batch (blr · batch · N / 256), and rank 0 alone writes
`log.txt` and the checkpoints (the epoch row count-weighted over the
ranks). The output directory is shared by the ranks.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from snuffy_tpu_torch.configs import bool_flag


def get_args_parser():
    """The root main_pretrain_adapter.py's flags (help shortened), plus
    --device."""
    p = argparse.ArgumentParser("MAE-adapter pretraining (H100)")
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--epochs", default=400, type=int)
    p.add_argument("--model", default="mae_vit_base_patch16", type=str,
                   choices=["mae_vit_base_patch16", "mae_vit_large_patch16"])
    p.add_argument("--input_size", default=224, type=int)
    p.add_argument("--mask_ratio", default=0.75, type=float)
    p.add_argument("--norm_pix_loss", action="store_true")
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--blr", default=1e-3, type=float)
    p.add_argument("--min_lr", default=0.0, type=float)
    p.add_argument("--warmup_epochs", default=40, type=int)
    p.add_argument("--data_path", default="datasets/camelyon16/single",
                   type=str)
    p.add_argument("--valid_data_path", default=None, type=str)
    p.add_argument("--output_dir", default="runs/mae_adapter", type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--finetune", default=None, type=str,
                   help="published MAE .pth to start from")
    p.add_argument("--adapter_ffn_scalar", default=4.0, type=float)
    p.add_argument("--ffn_num", default=64, type=int)
    p.add_argument("--use_adapter", default=True, type=bool_flag)
    p.add_argument("--train_linears__linears_from_scratch",
                   default="[True, False]", type=str,
                   help="composite flag: train decoder linears / re-init them")
    p.add_argument("--device_augment", default=True, type=bool_flag,
                   help="RandomResizedCrop(input_size, scale=(0.2, 1.0), "
                        "bicubic) + hflip + ImageNet normalize on the "
                        "device, on the validation split too")
    p.add_argument("--raw_input_size", default=None, type=int,
                   help="decode size fed to the device-side crop (defaults "
                        "to input_size)")
    p.add_argument("--img_pack", default=1, type=int,
                   help="fold this many masked images into one encoder "
                        "sequence; must divide the batch")
    p.add_argument("--pack_mode", default="masked",
                   choices=["masked", "blocked"],
                   help="the JAX package's packed-attention modes; both "
                        "fold the images into the attention kernel's batch "
                        "here (exact-math equal)")
    p.add_argument("--max_steps_per_epoch", default=None, type=int)
    p.add_argument("--compute_dtype", default="bfloat16", type=str,
                   choices=["float32", "bfloat16"],
                   help="encoder/decoder block matmul dtype (params and "
                        "loss stay f32)")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; cuda raises when no GPU is present")
    return p


def build_trainer(args, device: torch.device, mesh=None):
    """The model the flags name, with its decoder (seeded by --seed), and
    its MAETrainer, data-parallel over `mesh` when one is given."""
    from snuffy_tpu_torch.models import mae as mae_mod
    from snuffy_tpu_torch.ssl.mae_trainer import MAETrainer

    train_linears, _ = ast.literal_eval(
        args.train_linears__linears_from_scratch)
    model = getattr(mae_mod, args.model)(
        img_size=args.input_size, norm_pix_loss=args.norm_pix_loss,
        use_adapter=args.use_adapter, adapter_bottleneck=args.ffn_num,
        adapter_scale=args.adapter_ffn_scalar,
        compute_dtype=args.compute_dtype, with_decoder=True,
        seed=args.seed,
    ).to(device)
    return MAETrainer(
        model,
        mask_ratio=args.mask_ratio,
        weight_decay=args.weight_decay,
        freeze_non_adapter=args.use_adapter,
        train_decoder_linears=bool(train_linears),
        augment=args.device_augment,
        img_pack=args.img_pack,
        mesh=mesh,
    )


def load_finetune(args, model) -> None:
    """--finetune onto the model, in place (reference
    main_pretrain_adapter.py:209-221): what the file holds under the
    model's names and shapes; without the decoder linears when they start
    from scratch."""
    from snuffy_tpu_torch.embed import torch_import as ti

    _, linears_from_scratch = ast.literal_eval(
        args.train_linears__linears_from_scratch)
    imported = ti.import_mae_pretrain(ti.load_torch_state_dict(args.finetune))
    if linears_from_scratch:
        imported = {k: v for k, v in imported.items()
                    if k.split(".")[0] not in ("decoder_embed",
                                               "decoder_pred")}
    ti.merge_into(model, imported)
    print(f"loaded checkpoint from {args.finetune} ({len(imported)} "
          "tensors)")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(args, state, epoch: int, path: str) -> None:
    """`path` in the reference's layout (module docstring), written whole
    then renamed."""
    payload = {
        "model": _to(state.model.state_dict(), "cpu"),
        "optimizer": _to(state.opt_state, "cpu"),
        "step": state.step,
        "epoch": epoch,
        "args": vars(args),
    }
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def resume(path: str, state, device) -> int:
    """Restore the model, the optimizer and the step from `path`; returns
    the epoch to start at. A checkpoint without the optimizer's state
    resumes with Adam's moments at zero, and says so."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.step = int(ckpt["step"])
    if "optimizer" in ckpt:
        state.opt_state = _to(ckpt["optimizer"], device)
    else:
        print("WARNING: checkpoint without optimizer state; Adam's moments "
              "restart from zero on this resume")
    return int(ckpt["epoch"]) + 1


def train_mae(args, timings: Optional[Dict[str, float]] = None):
    """The pretraining loop; returns the final `MAEState`. With a
    `timings` dict, adds the seconds of the host decode and the step's
    augment, forward, backward and update (device synchronised between
    them) and the count of steps to it."""
    from snuffy_tpu_torch.parallel import distributed
    from snuffy_tpu_torch.parallel.mesh import make_mesh
    from snuffy_tpu_torch.parallel.ssl_sharding import replicate_state
    from snuffy_tpu_torch.predict_slide import resolve_device
    from snuffy_tpu_torch.ssl.data import ImageBatcher, list_image_folder
    from snuffy_tpu_torch.ssl.dino import StageClock
    from snuffy_tpu_torch.ssl.mae_trainer import (
        effective_lr,
        host_check_finite,
    )
    from snuffy_tpu_torch.ssl.schedules import mae_lr_schedule
    from snuffy_tpu_torch.utils.logging import truncate_log_past_epoch
    from snuffy_tpu_torch.utils.metrics_sync import (
        global_min_int,
        sync_epoch_row,
    )

    device = resolve_device(str(distributed.rank_device(args.device)))
    world, rank = distributed.world_size(), distributed.rank()
    mesh = make_mesh(distributed.global_mesh_spec()) if world > 1 else None
    trainer = build_trainer(args, device, mesh)
    if args.finetune:
        load_finetune(args, trainer.model)
    state = trainer.init_state()

    # the linear scaling rule by the global batch (reference
    # main_pretrain_adapter.py:296-302: eff_batch = batch * world_size)
    base_lr = args.lr if args.lr is not None else effective_lr(
        args.blr, args.batch_size * world)
    lr_s = mae_lr_schedule(base_lr, args.min_lr, args.epochs,
                           args.warmup_epochs)
    # with the device-side augment the host streams the raw decode size
    # and the step crops to input_size
    feed_size = ((args.raw_input_size or args.input_size)
                 if args.device_augment else args.input_size)
    # each rank feeds every world-th image (the DistributedSampler's role)
    paths, _ = list_image_folder(args.data_path)
    paths = paths[rank::world]
    batcher = ImageBatcher(paths, args.batch_size, feed_size,
                           args.num_workers, args.seed)
    valid_batcher = None
    if args.valid_data_path:
        vp, _ = list_image_folder(args.valid_data_path)
        valid_batcher = ImageBatcher(vp[rank::world], args.batch_size,
                                     feed_size,
                                     args.num_workers, args.seed + 1)
    iters = len(batcher)
    if args.max_steps_per_epoch:
        iters = min(iters, args.max_steps_per_epoch)
    iters = global_min_int(iters)
    n_val_batches = global_min_int(
        min(len(valid_batcher), 10) if valid_batcher is not None else 0)
    print(f"{len(paths)} images, {iters} iters/epoch, base_lr "
          f"{base_lr:.2e}, {world} device(s) x batch {args.batch_size}")

    os.makedirs(args.output_dir, exist_ok=True)
    start_epoch = 0
    rolling = os.path.join(args.output_dir, "checkpoint.pth")
    if os.path.exists(rolling):
        start_epoch = resume(rolling, state, device)
        print(f"resumed from {rolling} at epoch {start_epoch}")
        if distributed.is_primary():
            truncate_log_past_epoch(
                os.path.join(args.output_dir, "log.txt"), start_epoch)
    # every rank starts from rank 0's weights and optimizer
    replicate_state((state.model, state.opt_state), mesh)

    clock = StageClock(timings, device)
    gen = torch.Generator(device).manual_seed(
        distributed.rank_seed(args.seed + start_epoch))
    best_val, best_path = float("inf"), None
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        losses = []
        batches = batcher.epoch()
        for bi in range(iters):
            clock.start()
            imgs = torch.from_numpy(next(batches)).to(device)
            clock.mark("decode_s")
            state, loss = trainer.step(state, imgs, lr_s(epoch + bi / iters),
                                       gen, timings=timings)
            loss = float(loss)
            host_check_finite(loss)
            losses.append(loss)
            clock.count("steps")
        batches.close()
        val_loss = None
        if valid_batcher is not None:
            vl = []
            for bi, batch in enumerate(valid_batcher.epoch()):
                if bi >= n_val_batches:
                    break
                vl.append(trainer.eval_loss(
                    state, torch.from_numpy(batch).to(device), gen))
            val_loss = float(np.mean(vl)) if vl else None
        row = {
            "epoch": epoch,
            "train_loss": float(np.mean(losses)) if losses else None,
            "val_loss": val_loss,
            "lr": lr_s(epoch),
            "epoch_time_s": time.time() - t0,
        }
        row, is_writer = sync_epoch_row(row, len(losses))
        val_loss = row["val_loss"]
        if not is_writer:
            continue
        print(json.dumps(row))
        with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(row) + "\n")
        save_checkpoint(args, state, epoch, rolling)
        # the best checkpoint, the previous best deleted (reference
        # main_pretrain_adapter.py:336-356)
        metric = val_loss if val_loss is not None else row["train_loss"]
        if metric is not None and metric < best_val:
            path = os.path.join(args.output_dir,
                                f"checkpoint-best-{epoch}.pth")
            save_checkpoint(args, state, epoch, path)
            if best_path and os.path.exists(best_path):
                os.remove(best_path)
            best_val, best_path = metric, path
    batcher.close()
    if valid_batcher is not None:
        valid_batcher.close()
    return state


def main(argv=None, timings: Optional[Dict[str, float]] = None):
    """The CLI: the bootstrap (nothing without torchrun's environment),
    then `train_mae`."""
    from snuffy_tpu_torch.parallel import distributed

    args = get_args_parser().parse_args(argv)
    with distributed.session(device=args.device):
        return train_mae(args, timings)


if __name__ == "__main__":
    main()
