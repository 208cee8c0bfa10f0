"""DINO-with-adapter pretraining CLI on the GPU.

The port of the root `main_dino_adapter.py` (the reference's
`python dino_adapter/main_dino_adapter.py`), with its flags plus
`--device` (default cuda; there is no silent fall back to the CPU):

  python -m snuffy_tpu_torch.main_dino_adapter --data_path <ImageFolder> \\
      --output_dir runs/dino_adapter

A step: the host decodes a uint8 batch (`ssl.data.ImageBatcher`), the
device cuts the multi-crop views (`ssl.augment.dino_multicrop_batch`),
the student sees every view and the teacher the 2 global ones
(`ssl.dino.DINOTrainer`), and the adapters and the head take the masked
optimizer step; the teacher follows by EMA. The learning rate scales by
the global batch (lr · batch / 256), with the weight-decay and teacher-
momentum cosine schedules. Each epoch appends a JSON row to `log.txt`
(`val_loss` over at most 5 batches of `--valid_data_path`) and writes
`checkpoint.pth` in the reference's torch layout, loadable with
`torch.load(..., weights_only=True)`:

  student, teacher   state dicts, `backbone.*` and `head.*`
  optimizer          the trainer's state: adamw's moments and its one
                     shared count, or sgd/LARS momentum buffers
  dino_loss          {'center': (1, out_dim)}
  step, epoch        steps taken; the next epoch to run (the reference's)
  args               the flags, as a dict

and `checkpoint{epoch:04}.pth` every `--saveckp_freq` epochs. A run whose
`--output_dir` holds `checkpoint.pth` resumes from it, the optimizer's
state included, and keeps `log.txt` to one row an epoch. The teacher's
backbone loads into the extraction CLI: `python -m
snuffy_tpu_torch.compute_feats --embedder DINO --backbone vit_small
--use_adapter --weights <output_dir>/checkpoint.pth`.

`--full_checkpoint` starts from a full DINO training checkpoint (student
and teacher, the head filtered as the reference filters it; `--random_head
1` keeps the head's init) or from a plain backbone `.pth`.
`--num_workers` is the decode's thread count.

Several GPUs, data-parallel: `torchrun --nproc_per_node N -m
snuffy_tpu_torch.main_dino_adapter ...` runs one process a GPU
(`parallel/distributed.py`); without torchrun's environment it is one
process. Each rank takes every N-th image, `--batch_size_per_gpu` images a
step, and averages the gradients with the others; the ranks agree on the
steps an epoch and the validation batches (the fewest any rank has), the
learning rate scales by the global batch (lr · batch · N / 256), and rank
0 alone writes `log.txt` and the checkpoints (the epoch row count-weighted
over the ranks). The output directory is shared by the ranks.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from snuffy_tpu_torch.configs import bool_flag


def get_args_parser():
    """The root main_dino_adapter.py's flags (help shortened), plus
    --device."""
    p = argparse.ArgumentParser("DINO-adapter pretraining (H100)")
    p.add_argument("--arch", default="vit_small",
                   choices=["vit_tiny", "vit_small", "vit_base"])
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--out_dim", default=65536, type=int)
    p.add_argument("--norm_last_layer", default=True, type=bool_flag)
    p.add_argument("--use_bn_in_head", default=False, type=bool_flag)
    p.add_argument("--momentum_teacher", default=0.996, type=float)
    p.add_argument("--warmup_teacher_temp", default=0.04, type=float)
    p.add_argument("--teacher_temp", default=0.04, type=float)
    p.add_argument("--warmup_teacher_temp_epochs", default=0, type=int)
    p.add_argument("--weight_decay", default=0.04, type=float)
    p.add_argument("--weight_decay_end", default=0.4, type=float)
    p.add_argument("--clip_grad", default=3.0, type=float)
    p.add_argument("--batch_size_per_gpu", default=64, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--freeze_last_layer", default=1, type=int)
    p.add_argument("--lr", default=0.0005, type=float)
    p.add_argument("--warmup_epochs", default=10, type=int)
    p.add_argument("--min_lr", default=1e-6, type=float)
    p.add_argument("--optimizer", default="adamw", type=str,
                   choices=["adamw", "sgd", "lars"])
    p.add_argument("--drop_path_rate", default=0.1, type=float,
                   help="stochastic depth rate")
    p.add_argument("--compute_dtype", default="bfloat16", type=str,
                   choices=["float32", "bfloat16"],
                   help="the ViTs' matmul dtype (params and loss stay f32)")
    p.add_argument("--global_crops_scale", type=float, nargs="+",
                   default=(0.4, 1.0))
    p.add_argument("--local_crops_number", default=8, type=int)
    p.add_argument("--local_crops_scale", type=float, nargs="+",
                   default=(0.05, 0.4))
    p.add_argument("--data_path", default="datasets/camelyon16/single",
                   type=str)
    p.add_argument("--valid_data_path", default=None, type=str)
    p.add_argument("--output_dir", default="runs/dino_adapter", type=str)
    p.add_argument("--saveckp_freq", default=20, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--full_checkpoint", default=None, type=str,
                   help="DINO .pth to start from (frozen backbone)")
    p.add_argument("--random_head", default=0, type=int,
                   help="1 = train the head from scratch even when the "
                        "checkpoint has one")
    p.add_argument("--adapter_ffn_scalar", default=4.0, type=float)
    p.add_argument("--ffn_num", default=64, type=int)
    p.add_argument("--use_adapter", default=True, type=bool_flag)
    p.add_argument("--img_size", default=224, type=int)
    p.add_argument("--global_size", default=224, type=int)
    p.add_argument("--local_size", default=96, type=int)
    p.add_argument("--max_steps_per_epoch", default=None, type=int)
    p.add_argument("--crop_pack", default=1, type=int,
                   help="fold this many local crops into one student "
                        "sequence; must divide local_crops_number x batch")
    p.add_argument("--pack_mode", default="masked",
                   choices=["masked", "blocked"],
                   help="the JAX package's packed-attention modes; both "
                        "fold the crops into the attention kernel's batch "
                        "here (exact-math equal)")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; cuda raises when no GPU is present")
    return p


def build_trainer(args, device: torch.device, mesh=None):
    """The backbone the flags name (seeded by --seed) and its
    DINOTrainer, data-parallel over `mesh` when one is given."""
    from snuffy_tpu_torch.models import vit as vit_mod
    from snuffy_tpu_torch.ssl.dino import DINOTrainer

    factory = getattr(vit_mod, args.arch)
    backbone = factory(
        patch_size=args.patch_size, use_adapter=args.use_adapter,
        adapter_bottleneck=args.ffn_num,
        adapter_scale=args.adapter_ffn_scalar,
        drop_path_rate=args.drop_path_rate,
        compute_dtype=args.compute_dtype, pack_mode=args.pack_mode,
        seed=args.seed,
    ).to(device)
    return DINOTrainer(
        backbone,
        out_dim=args.out_dim,
        warmup_teacher_temp=args.warmup_teacher_temp,
        teacher_temp=args.teacher_temp,
        warmup_teacher_temp_epochs=args.warmup_teacher_temp_epochs,
        n_local_crops=args.local_crops_number,
        local_size=args.local_size,
        global_size=args.global_size,
        freeze_backbone=args.use_adapter,
        freeze_last_layer=args.freeze_last_layer,
        clip_grad=args.clip_grad,
        norm_last_layer=args.norm_last_layer,
        optimizer=args.optimizer,
        use_bn_in_head=args.use_bn_in_head,
        crop_pack=args.crop_pack,
        mesh=mesh,
    )


def load_full_checkpoint(args, trainer, state) -> None:
    """--full_checkpoint onto the student and teacher, in place
    (reference main_dino_adapter.py:239-311): a full training checkpoint
    gives both, backbone and filtered head; a plain backbone `.pth` the
    student's backbone, which the teacher then copies."""
    from snuffy_tpu_torch.embed import torch_import as ti

    parts = ti.load_torch_full_checkpoint(args.full_checkpoint)
    if parts:
        loaded = ti.import_dino_student_teacher(
            parts, state.student.state_dict(), state.teacher.state_dict(),
            random_head=bool(args.random_head),
            norm_last_layer=args.norm_last_layer)
        if "student" in loaded:
            ti.merge_into(state.student, loaded["student"])
        if "teacher" in loaded:
            ti.merge_into(state.teacher, loaded["teacher"])
        else:
            state.teacher.load_state_dict(state.student.state_dict())
        taken = {k: len(v) for k, v in loaded.items()}
    else:
        sd = ti.load_torch_state_dict(args.full_checkpoint)
        imported = ti.import_vit(sd)
        ti.merge_into(state.student.backbone, imported)
        state.teacher.load_state_dict(state.student.state_dict())
        taken = {"backbone": len(imported)}
    print(f"loaded full checkpoint from {args.full_checkpoint} (tensors "
          f"taken: {taken})")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(args, state, epoch: int) -> str:
    """checkpoint.pth in the reference's layout (module docstring),
    written whole then renamed; a copy every --saveckp_freq epochs."""
    payload = {
        "student": _to(state.student.state_dict(), "cpu"),
        "teacher": _to(state.teacher.state_dict(), "cpu"),
        "optimizer": _to(state.opt_state, "cpu"),
        "dino_loss": {"center": state.center.cpu()},
        "step": state.step,
        "epoch": epoch + 1,
        "args": vars(args),
    }
    path = os.path.join(args.output_dir, "checkpoint.pth")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    if args.saveckp_freq and epoch % args.saveckp_freq == 0:
        shutil.copy(path, os.path.join(args.output_dir,
                                       f"checkpoint{epoch:04}.pth"))
    return path


def resume(path: str, trainer, state, device) -> int:
    """Restore model, optimizer, centre and step from `path`; returns the
    epoch to start at. A checkpoint without the optimizer's state resumes
    with its buffers at zero, and says so."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.student.load_state_dict(ckpt["student"])
    state.teacher.load_state_dict(ckpt["teacher"])
    state.center = ckpt["dino_loss"]["center"].to(device)
    state.step = int(ckpt["step"])
    if "optimizer" in ckpt:
        state.opt_state = _to(ckpt["optimizer"], device)
    else:
        print("WARNING: checkpoint without optimizer state; the "
              "optimizer's buffers restart from zero on this resume")
    return int(ckpt["epoch"])


def train_dino(args, timings: Optional[Dict[str, float]] = None):
    """The pretraining loop; returns the final `DINOState`. With a
    `timings` dict, adds the seconds of the host decode, the augment and
    the step's forward, backward and update (device synchronised between
    them) and the count of steps to it."""
    from snuffy_tpu_torch.parallel import distributed
    from snuffy_tpu_torch.parallel.mesh import make_mesh
    from snuffy_tpu_torch.parallel.ssl_sharding import replicate_state
    from snuffy_tpu_torch.predict_slide import resolve_device
    from snuffy_tpu_torch.ssl.augment import dino_multicrop_batch
    from snuffy_tpu_torch.ssl.data import ImageBatcher, list_image_folder
    from snuffy_tpu_torch.ssl.dino import StageClock
    from snuffy_tpu_torch.ssl.schedules import cosine_iter_schedule
    from snuffy_tpu_torch.utils.logging import truncate_log_past_epoch
    from snuffy_tpu_torch.utils.metrics_sync import (
        global_min_int,
        sync_epoch_row,
    )

    device = resolve_device(str(distributed.rank_device(args.device)))
    world, rank = distributed.world_size(), distributed.rank()
    mesh = make_mesh(distributed.global_mesh_spec()) if world > 1 else None
    trainer = build_trainer(args, device, mesh)
    state = trainer.init_state(args.seed)
    if args.full_checkpoint:
        load_full_checkpoint(args, trainer, state)

    # each rank feeds every world-th image (the DistributedSampler's role)
    paths, _ = list_image_folder(args.data_path)
    paths = paths[rank::world]
    batcher = ImageBatcher(paths, args.batch_size_per_gpu, args.img_size,
                           args.num_workers, args.seed)
    valid_batcher = None
    if args.valid_data_path:
        vp, _ = list_image_folder(args.valid_data_path)
        valid_batcher = ImageBatcher(vp[rank::world],
                                     args.batch_size_per_gpu,
                                     args.img_size, args.num_workers,
                                     args.seed + 1)
    iters = len(batcher)
    if args.max_steps_per_epoch:
        iters = min(iters, args.max_steps_per_epoch)
    iters = global_min_int(iters)
    n_val_batches = global_min_int(
        min(len(valid_batcher), 5) if valid_batcher is not None else 0)
    print(f"{len(paths)} images, {iters} iters/epoch, {world} device(s) x "
          f"batch {args.batch_size_per_gpu}")

    # the linear scaling rule by the global batch (reference
    # main_dino_adapter.py: lr * batch_size_per_gpu * world_size / 256)
    lr_s = cosine_iter_schedule(
        args.lr * args.batch_size_per_gpu * world / 256.0, args.min_lr,
        args.epochs, iters, warmup_epochs=args.warmup_epochs)
    wd_s = cosine_iter_schedule(args.weight_decay, args.weight_decay_end,
                                args.epochs, iters)
    mom_s = cosine_iter_schedule(args.momentum_teacher, 1.0, args.epochs,
                                 iters)

    def augment(batch, gen):
        imgs = torch.from_numpy(batch).to(device, non_blocking=True)
        return dino_multicrop_batch(
            imgs, gen, n_local=args.local_crops_number,
            global_size=args.global_size, local_size=args.local_size,
            global_scale=tuple(args.global_crops_scale),
            local_scale=tuple(args.local_crops_scale))

    os.makedirs(args.output_dir, exist_ok=True)
    start_epoch = 0
    ckpt = os.path.join(args.output_dir, "checkpoint.pth")
    if os.path.exists(ckpt):
        start_epoch = resume(ckpt, trainer, state, device)
        print(f"resumed from {ckpt} at epoch {start_epoch}")
        if distributed.is_primary():
            truncate_log_past_epoch(
                os.path.join(args.output_dir, "log.txt"), start_epoch)
    # every rank starts from rank 0's weights, centre and optimizer
    replicate_state((state.student, state.teacher, state.center,
                     state.opt_state), mesh)

    clock = StageClock(timings, device)
    it = start_epoch * iters
    gen = torch.Generator(device).manual_seed(
        distributed.rank_seed(args.seed + start_epoch))
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        losses = []
        batches = batcher.epoch()
        for _ in range(iters):
            clock.start()
            batch = next(batches)
            clock.mark("decode_s")
            g, loc = augment(batch, gen)
            clock.mark("augment_s")
            state, loss = trainer.step(
                state, g, loc, lr_s(it), wd_s(it), mom_s(it),
                trainer.teacher_temp_at(epoch),
                epoch < args.freeze_last_layer, gen, timings)
            loss = float(loss)
            if not math.isfinite(loss):
                raise FloatingPointError(f"Loss is {loss}, stopping training")
            losses.append(loss)
            clock.count("steps")
            it += 1
        batches.close()
        val_loss = None
        if valid_batcher is not None:
            vl = []
            for bi, batch in enumerate(valid_batcher.epoch()):
                if bi >= n_val_batches:
                    break
                g, loc = augment(batch, gen)
                vl.append(trainer.eval_loss(state, g, loc,
                                            trainer.teacher_temp_at(epoch)))
            val_loss = float(np.mean(vl)) if vl else None
        row = {
            "epoch": epoch,
            "train_loss": float(np.mean(losses)) if losses else None,
            "val_loss": val_loss,
            "lr": lr_s(it - 1),
            "wd": wd_s(it - 1),
            "epoch_time_s": time.time() - t0,
        }
        row, is_writer = sync_epoch_row(row, len(losses))
        if not is_writer:
            continue
        print(json.dumps(row))
        with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(row) + "\n")
        save_checkpoint(args, state, epoch)
    batcher.close()
    if valid_batcher is not None:
        valid_batcher.close()
    return state


def main(argv=None, timings: Optional[Dict[str, float]] = None):
    """The CLI: the bootstrap (nothing without torchrun's environment),
    then `train_dino`."""
    from snuffy_tpu_torch.parallel import distributed

    args = get_args_parser().parse_args(argv)
    with distributed.session(device=args.device):
        return train_dino(args, timings)


if __name__ == "__main__":
    main()
