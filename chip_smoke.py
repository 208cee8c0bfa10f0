#!/usr/bin/env python3
"""Smoke run of the PyTorch port (snuffy_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit. It builds the port's three kernels from csrc/ with nvcc (one nvcc
per kernel, all at once), then:

  1. environment: torch/CUDA versions, the nvcc builds (registers, stack
     and spills of each kernel), the card's name and power limit
     (nvidia-smi);
  2. forward kernel vs plain: at h=4, N=10240 (10000 rows valid), S=512
     (some slots dead), dk=96, for f32/bf16, segments 1/8 and dropout
     0/0.1, with a dummy bag and an all-dead segment; the body the
     dispatch takes (f32 or bf16 tensor cores), checked against the
     kernel names torch.profiler records; errors against the stated
     tolerance, two launches bitwise equal, median times of one call by
     CUDA events, 20 calls back to back, and the device time of a call
     and of each pass (row stats, slot accumulate, reduce of the N
     splits) by torch.profiler, which must find every pass the call
     launches;
  3. backward kernel vs plain: the same inputs and cases with a seeded
     output gradient; the body, checked as in 2; dq, dk and dv errors, no
     gradient into the dummy bag or dead slots, two launches bitwise
     equal, median times of one call of the kernel and of the plain
     version, 20 calls back to back, and the device time of a call and of
     each pass (row grad, slot grad, reduce of the N splits) by
     torch.profiler;
  4. dense-attention kernel vs plain: f32 and bf16 at the shapes of the
     TPU probes P1-P3 (z=1536, n=197, dk=64: a ViT-S/16 batch of 256) and
     P4 (z=384, n=785, dk=64), at the DINO crops (ViT-S/16 at batch 64:
     z=768, n=197 and z=3072, n=37), at the extraction batch (z=768,
     n=785), and ragged (n_valid < n, dk=32); the body the dispatch takes (f32: the
     one-pass 3xTF32 body; bf16: wgmma), checked against the kernel names
     torch.profiler records; errors against the stated tolerance, median
     times of one call by CUDA events, the device time of a call by
     torch.profiler and of 20 calls back to back, the bound of the body
     (f32 over 3xTF32's 165 TFLOP/s, 67 beside it), and
     scaled_dot_product_attention as the library yardstick, timed the
     same ways;
  5. serve: ViT-S/16 + MILNet (d=384, 4 heads, Λ=512, ρ=0.5, depth 2,
     bf16) from seeded weights answer requests of 10000, 2500 and 300
     uint8 224² tiles, 12 dense-attention launches a 256-tile batch; a
     small request is checked against the same models in f32 on the CPU
     (plain attention path);
  5b. whole slide: the port's streaming `predict_slide` on a q75 JPEG-
     tiled pyramid written with the port's writer (SLIDE_GRID² tiles of
     256², a 2× level, a quarter of the tiles flat background) at the
     serve operating point: one warm-up, then (a) the scaled decode
     (256→224 by the 7/8 IDCT), (b) `scaled_decode=False` (decode at 256,
     resize on the card), (c) (b) without the prefetch thread; kept
     positions equal across them and to the fixture's tissue, (b) and (c)
     bitwise equal, (a) within the JAX test's 0.05/0.02 of (b), every
     timing key, tiles/s through the reader, the dense and sparse kernels'
     launches; a small slide in f32 on the card against the CPU;
  6. packed eval: 30 bags of seeded (10240, 384) embeddings through
     run_eval_epoch (chunks of 8, the tail padded with dummy bags), and
     each bag's score against a one-bag (segments=1) run;
  7. extraction: DINO ViT-S/8 + adapter (384-d, depth 12, 6 heads,
     bottleneck 64, scale 4.0, up-projections drawn non-zero), bf16, batch
     128, embeds two bags of 700 and 300 seeded uint8 224² tiles (tails
     padded), writes the per-bag and dataset CSVs to a temporary directory
     and reads them back; tiles/s, 12 dense-attention launches a batch; a
     GPU (kernel) vs CPU (plain) f32 check on two tiles; then one bag
     written as a tree of JPEG tiles and run through `extract_dataset`,
     which decodes them with the port's libjpeg decoder (held to PIL
     where PIL is installed) and gives the features of its decoded tiles;
  8. train: the same MILNet with attention dropout 0.1, AdamW (lr 2e-2,
     weight decay 5e-2, soft_average), 8 bags of 10240 rows (10000 valid)
     in serial steps, then 16 bags in packed steps of 8;
  9. GPU vs CPU training: from the same weights, f32, ρ=0, no dropout,
     3 serial steps through the kernels on the card and through the plain
     versions on the CPU;
  10. the training CLI (`python -m snuffy_tpu_torch.train`'s `main`) in a
     temporary directory on trees written with the port's CSV writer: (a)
     the README's Camelyon16 recipe (d=384, 4 heads, Λ=500, ρ=0.5, AdamW
     lr 0.02, soft_average) in f32, 8/4/4 bags of 2000-8600 rows (two in
     the 10240 bucket, the test bags with label/position columns), serial
     and in packed steps of 4; (b) TCGA multiclass (C=2) at the same
     widths, packed steps of 4; (c) musk1's quick start on a synthetic
     pickle; 2 epochs each: the time split of each epoch (load, train,
     valid, metrics, checkpoints, tests), bags/s, CSV MiB/s, launches, and
     the load taken apart (the tree's bags read in one process by each
     parser, a spawned pool's start); checks: best epoch, AUCs in [0, 1]
     for each class, finite losses, K1/K2 launches ≥ depth × steps ×
     epochs, only the best and last epochs' files left, the best `.pth`
     loads strictly; the Camelyon16 tree has reference.csv and label masks
     for its tumour test slides, so (a)'s tests score the challenge FROC,
     each score equal to `froc_for_slides` recomputed from the detections
     the run built;
  10a. K1 and K2 (f32, the CLI's dtype) on the inputs the four runs gave
     them, kept from the first call at each shape (rows, slots, heads,
     dk, segments, dropout rate): serial and packed Camelyon16 buckets at
     S=500, packed multiclass at S=1000 a bag, musk1's dk=83 with N = S;
     the body each shape ran (the f32 tensor-core one, musk1's the
     CUDA-core one); K1's output and, where training reached K2 there,
     dq, dk, dv against the plain versions, two launches bitwise equal;
     the training shapes timed (one call, 20 calls back to back, CUDA
     events) beside the plain versions and the bound (over 3xTF32's 165
     TFLOP/s, f32's 67 beside it); then a dummy-bag chunk (one 2600-row
     bag padded to 4 segments) checked and timed beside the bag alone;
  10b. one epoch of a small (a) with ρ=0 and no dropout through the
     runner on the card and on the CPU, from the same weights;
  11. the root CLIs' default embedders: (a) K1 at the slide CLI's MILNet
     shape (bf16, h=4, dk=128: the tensor-core body's launch_tc<128>, with
     ptxas's registers and spills for it; N=10240 with 10000 valid, S=200,
     ρ=0, segments 1 and 8) against the plain version, two launches
     bitwise equal, one-call and device times, the bound; (b) the port's
     `predict_slide.main` with only --slide and --device cuda (SimCLR
     ResNet-18 bf16 → MILNet d=512, 4 heads, Λ=200, ρ=0, depth 1) on a
     CLI_SLIDE_GRID² JPEG-tiled slide, its timing keys and K1 launches,
     then `predict_tiles` on 10000, 2500 and 300 uint8 224² tiles at the
     same defaults (embed_s, classify_s), and a small request in f32 on
     the card against the CPU; (c) the port's `compute_feats.main` at its
     defaults (SimCLR) and with MAE ViT-B/16 on phase 7's 300-tile bag
     written as JPEGs: CSVs read back and equal the decoded tiles'
     embeddings, tiles/s; one batch of 128 tiles through MAE ViT-L/16
     bf16, each of its 24 K5 launches held to the plain version; K5 timed
     at the ViT-B and ViT-L shapes on those runs' own inputs, beside SDPA;
     (d) DINO ViT-S/16 at 256² input (the position grid resized to 16²),
     f32, GPU vs CPU; (e) `hubconf.load_dino_resnet50` from a written
     `.pth`, f32, GPU vs CPU;
  12. evaluation and visualization: (a) phase 5b's SLIDE_GRID² slide
     carried down to an 8x level, with an ASAP polygon, through the
     Camelyon16 tiler CLI at its defaults (8 workers, 256², q75, -t 20):
     the kept tiles equal the fixture's tissue, tile_label.csv the polygon,
     tiles/s; the nested layout (-m 0 1) on a small slide, and the tiler's
     cost a grid tile in one process and in 8; (b) the splitter, n-shot and
     reverser CLIs on that tree; (c) the ROI CLI's `main` over the bag,
     SimCLR ResNet-18 at its defaults (f32, d=512, 4 heads, Λ=200, depth
     5: K1 f32 at dk=128) and DINO ViT-S/16 on the bag's first
     ROI_DINO_TILES tiles (d=384, 6 heads: K5 f32, K1 f32 at dk=64):
     embed and classify seconds, K1 (depth) and K5 (12 a batch)
     launches, the PNG read back (the thumbnail's size, its green pixels
     the mask's boundary band), a 300-tile subset GPU vs CPU in f32; (d)
     K1 f32 at dk=128 and 64 and K5 f32 on the inputs those runs gave
     them (error, two launches bitwise equal, one-call and back-to-back
     times, the bound; ptxas for K1's f32 tensor-core body at dk=128; K5's
     body checked against the kernel names torch.profiler records);
     (e) the ROI's scores as detections against the fixture's mask, and
     compute_evaluation_mask and EvalMaskCache (cold, warm in memory,
     warm from the npz) on a Camelyon16 level-5-sized label mask, its ITCs
     and score equal to an ArrayMaskReader's; (g) DSMIL (512-d, C=2,
     10000 rows padded to 10240) GPU vs CPU in f32; whether matplotlib
     imports.
  13. DINO-adapter pretraining, run right after phase 4 (its step
     profile needs torch.profiler's device times): (a) decode of 64
     JPEGs in one thread, the batcher's 8 threads and a spawned pool;
     `main_dino_adapter.main` at its defaults (ViT-S/16 + adapter, bf16,
     out_dim 65536, 2×224 + 8×96 crops, batch 64, AdamW) on 128
     generated 224² q75 JPEGs, 2 epochs of 2 steps with validation:
     finite losses and two log rows, the frozen backbone bit for bit,
     adapters and head moved, the last layer frozen through epoch 0 and
     moved in epoch 1, the teacher neither the student nor its start, K5
     launches ≥ 12 blocks × 3 calls × steps; seconds a step by stage,
     peak memory; (b) `compute_feats.main` (DINO ViT-S/16 + adapter, f32)
     on 32 of the JPEGs with `--weights <out>/checkpoint.pth`: every
     layer matched, the CSVs equal to the trained teacher's features;
     (c) 2 steps at `--patch_size 8 --batch_size_per_gpu 16` (K5 at
     n=785, 145), peak memory; a warm step's split, a torch.profiler
     breakdown (device busy by kind, idle share, top kernels) and the
     plain attention backward timed apart at the step's two shapes, its
     share of the step; (d) one f32 step (4 images, 2 locals, dropouts
     off) on the card and on the CPU from the same weights; (e) K5 on the
     inputs (a)-(d) gave it, the first call at each shape: f32
     within DENSE_TOL, bf16 (real activations) within one ulp of max
     |plain| (2^-7) as in phase 11, two launches bitwise equal, the body
     against the profiler's names, one-call and b2b times beside plain,
     SDPA and the bound;
  14. MAE-adapter pretraining, run right after phase 13 (for the same
     reason): (a) `main_pretrain_adapter.main` at its defaults
     (mae_vit_base_patch16 + adapters 64/4.0, 224², mask ratio 0.75,
     batch 64, bf16, device augment, decoder linears trained) on phase
     13's 128 JPEGs, 2 epochs of 2 steps with validation (warmup 0):
     finite losses and two log rows, every frozen tensor bit for bit,
     the encoder's and decoder's adapters and the decoder linears moved,
     the val loss down in epoch 1, the rolling and the one best
     checkpoint (epoch 0's deleted), K5 launches ≥ (12 + 8) blocks ×
     steps; seconds a
     step by stage, peak memory; (c) `compute_feats.main --embedder MAE`
     (f32) on 32 of the JPEGs with the best checkpoint: every encoder
     layer matched, the decoder counted unused, the CSVs equal to the
     encoder's features; (b) resume for one epoch (Adam's moments and
     count restored); (d) one step at `--img_pack 2` and one with
     mae_vit_large_patch16; (g) a warm step's split and profile, the
     plain attention backward timed apart at the encoder's and decoder's
     shapes and its share of the step; (e) one f32 step on the card and
     on the CPU from the same weights, crops and noise; (f) K5 on the
     inputs (a)-(e) gave it, as phase 13's (e).
  15. data parallelism, run last (python -m snuffy_tpu_torch.tools.
     multiproc_worker, two ranks sharing the card: gloo over CUDA tensors,
     both on cuda:0, since NCCL refuses two ranks on one device), each
     rank's process killed past MULTI_RANK_TIMEOUT: (a) one packed MIL
     step at bench.py's training point (d=384, 4 heads, Λ=512, depth 2,
     bf16, 8 bags padded to 10240) as 4 bags a rank, against one rank
     stepping all 8 from the same weights at ρ=0 and no dropout (losses,
     bag and instance scores, the gradients before the clip, parameters),
     then a tail batch of 3 real
     bags (rank 1 holds only dummies), then an epoch at ρ=0.5 and rate
     0.1: finite, replicas bitwise equal; (b) two DINO steps at the CLI's
     defaults (ViT-S/16 + adapter, bf16, out_dim 65536, 2×224 + 8×96
     crops drawn once and split), 32 a rank against 64 on one rank: loss,
     centre, the gradients the update receives, student and teacher; (c) two MAE steps likewise (ViT-B/16 +
     adapters, mask 0.75, the noise passed in); each with the step walls
     (2 ranks sharing the card, and 1), each gradient bucket's all-reduce
     time and bytes, and each rank's peak memory; (d) the extraction CLI
     (ViT-S/8 + adapter, bf16) on 2 ranks over phase 11c's 300 tiles as 4
     bags: every CSV byte for byte one process's on the card, the dataset
     CSV written by rank 0 alone; (e) NCCL in a group of one rank: an
     all-reduce, and a DINO step under the mesh bit for bit the step
     without a group. Each rank holds its K1, K2 and K5 first launches at
     each shape against the plain versions.
  16. sequence and tensor parallelism, remat and sharded checkpoints,
     run after 15 (two ranks of multiproc_worker sharing the card over
     gloo, as 15) at bench.py's training point: (a) one MIL step of 8
     bags with use_mesh=1 factored as sp=2 (K1/K2 at h=4 on 5120 rows a
     rank, S=512) against one rank stepping them packed at ρ=0 and no
     dropout (losses, scores, the gradients before the clip, parameters),
     a warm step with each all-reduce timed (calls, MiB, ms by what they
     carry), a step at ρ=0.5 and rate 0.1 (finite, every rank's whole
     model bitwise equal); (b) the same at tp=2 (K1/K2 at h=2 on 10240
     rows); (c) in this process, one packed step with remat against one
     without at ρ=0.5 and rate 0.1: bitwise, peak memory, the
     recompute's K1 launches; (d) one bag of 40960 rows forward and
     backward over sp=2 against one rank: scores, gradients, peak memory
     a rank; (e) a tp=2 checkpoint saved, the processes gone, read back
     by two fresh ranks (started with the first launch, waiting until
     its ranks have exited): each rank's shards' checksums, each rank
     its own blocks; (f) DINO with use_bn_in_head, 32 a rank against 64
     on one rank, in bf16 and in f32 (BN_TOL). The limits are set from
     the readings (MESH_LOSS_TOL, MESH_GRAD_TOL, LONG_TOL, BN_TOL). Each
     rank holds its K1/K2 first launches at each new shape against the
     plain versions (2^-7).

Each path of the main path (serve, whole slide, eval, extraction, train,
each training-CLI run, the SimCLR slide CLI and requests, the SimCLR and
MAE extraction CLI runs and the ViT-L batch, each ROI run, the DINO
CLI's two runs and its checkpoint's extraction, the MAE CLI's four runs
and its checkpoint's extraction, and in each rank of phase 15 its MIL,
DINO, MAE and extraction runs) runs with the launch counts set to 0 just
before it and read just after.
Every phase asserts; any failure exits non-zero. torch.profiler may record
no device time on a machine, from a run's first trace on: each trace gets
a second try, then its readings and the checks that read them (the passes
split, the body against the kernel names, the idle share) are reported as
not traced, and the CUDA-event times stand alone. The line before the last
is the kernels' JSON record, the last line the device record. It exits
non-zero at once without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import math
import statistics
import sys
import time

# Tolerances (max |kernel − plain| over an output, relative to max |plain|).
# f32: both sum in f32, in different orders, over 10000 rows (forward,
# dq, dv) or 512 slots (dk), so a few f32 roundings of the largest value.
# bf16: both compute in f32 from the same bf16 inputs and round the result
# to bf16 once; a one-ulp flip is at most 2^-7 of max|out|, and a two-ulp
# one needs the f32 results to differ by 2^-8 of it. The forward kernel's
# tensor-core product σᵀv takes p as two bf16 parts, hi + lo, because p
# rounded once to bf16 (as the TPU's MXU takes it at JAX's default
# precision) moves the f32 result by 1.6e-3-2.0e-3 of max|out| at these
# widths, which gave two-ulp flips up to 7.2e-3 (emulated on the CPU,
# tests/test_torch_sparse_attention.py); hi + lo keeps p within 2^-16.
# The backward kernel's tensor-core body feeds p~ and ds to its products
# as hi + lo for the same reason: one rounding of either moves dv, dq and
# dk by 1.5e-3-2.8e-3 of their max and flips small elements by tens of
# ulps (emulated there too).
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# Dense attention (max |kernel − plain| relative to max |plain|): f32, both
# sum in f32 in other orders over ≤ 785 keys; bf16, both round p and the
# output to bf16 from f32 values that differ in their last bits, so an
# output may flip by one bf16 ulp, 2^-8.
DENSE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
# (label, z, n, n_valid, dk); the JSON record is the extraction batch, bf16
DENSE_CASES = (("P1-P3", 1536, 197, 197, 64), ("P4", 384, 785, 785, 64),
               ("DINO global", 768, 197, 197, 64),
               ("DINO local", 3072, 37, 37, 64),
               ("S/8 extract", 768, 785, 785, 64),
               ("ragged", 96, 300, 280, 32))
# ViT embeddings, f32: GPU (kernel) vs CPU (plain), absolute.
EMBED_TOL = 1e-3
EXTRACT_BAGS, EXTRACT_BATCH = (700, 300), 128
# The whole-slide fixture: SLIDE_GRID² JPEG tiles of 256² at level 0.
SLIDE_GRID, SLIDE_QUALITY, SLIDE_BACKGROUND = 100, 75, 0.25
# Scaled (7/8 IDCT) against decode at 256 + resize, as
# tests/test_slide_inference.py holds the JAX pipeline: the two decodes
# differ in the top frequency band.
SCALED_TOL = {"instances": 0.05, "bag": 0.02}
# Bag/instance scores, f32 model: GPU (kernel) vs CPU (plain), and packed
# (segments=8) vs one bag (segments=1), both f32 GEMMs in other orders.
SCORE_TOL = 1e-4

H, N, N_VALID, S, DK = 4, 10240, 10000, 512, 96
# Phase 11b: the slide CLI's fixture, CLI_SLIDE_GRID² tiles of 256² at
# level 0, read at the 2x level at the CLI's default objective.
CLI_SLIDE_GRID = 40
# Conv nets, f32 (TF32 off): GPU vs CPU, max |diff| relative to max |CPU|.
# cuDNN picks its own algorithms (implicit GEMM, Winograd), whose f32
# sums run in other orders than the CPU's, and the norms rescale them.
CONV_TOL = 1e-3
REQUESTS = (10000, 2500, 300)
EVAL_BAGS = 30
TRAIN_BAGS, TRAIN_BATCH, PACKED_BAGS = 8, 8, 16
# The H100 SXM's datasheet peaks (NVIDIA), at a 700 W power limit: HBM3
# bytes/s, dense bf16 tensor-core FLOP/s and f32 FLOP/s outside the tensor
# cores (the f32 bodies of the sparse kernels). The bound of a kernel is
# the larger of its bytes and its operations over these.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989.4e12
F32_FLOPS = 67e12
# The f32 tensor-core bodies form each f32 product from three TF32 ones
# (3xTF32), so their f32 work runs at most at a third of the 495 TFLOP/s
# TF32 peak; F32_FLOPS stays beside it, the bound of the CUDA-core body.
TF32X3_FLOPS = 495e12 / 3
# Phase 10, the training CLI: the README's Camelyon16 recipe, in f32 (the
# CLI has no dtype flag), 2 epochs; bags of these many 384-d rows (two in
# the 10240 bucket), the test bags with label/position columns.
CLI_RECIPE = ("--feats_size=384", "--num_heads=4", "--big_lambda=500",
              "--random_patch_share=0.5", "--lr=0.02", "--optimizer=adamw",
              "--weight_decay=0.05", "--soft_average=1", "--num_epochs=2",
              "--embedding=dino")
CLI_SPLITS = (("train", (8600, 8300, 2000, 2300, 2600, 2000, 2100, 2400)),
              ("valid", (2000, 2300, 2100, 2400)),
              ("test", (2000, 2300, 2100, 2400)))
MUSK1_BAGS = 92


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of `reps` CUDA-event timings of fn()."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def attention_inputs(dtype, segments, gen, dev, s=S, dk=DK):
    import torch

    q = torch.randn((H, segments * N, dk), generator=gen, device=dev)
    k = torch.randn((H, segments * s, dk), generator=gen, device=dev)
    v = torch.randn((H, segments * N, dk), generator=gen, device=dev)
    q_valid = (torch.arange(N, device=dev) < N_VALID).repeat(segments)
    slot_valid = torch.rand(segments * s, generator=gen, device=dev) > 0.1
    if segments > 1:
        # segment 6: a dummy bag (no live rows or slots); segment 7: live
        # rows but every slot dead. Both must stay finite.
        q_valid[6 * N:7 * N] = False
        slot_valid[6 * s:8 * s] = False
    return [t.to(dtype).contiguous() for t in (q, k, v)] + [slot_valid,
                                                           q_valid]


def live_pairs(slot_valid, q_valid, segments) -> int:
    """(row, slot) pairs the attention needs: live rows × live slots of
    each segment."""
    rows = q_valid.reshape(segments, -1).sum(dim=1)
    slots = slot_valid.reshape(segments, -1).sum(dim=1)
    return int((rows * slots).sum())


def bound_ms(nbytes: int, flops: int, flops_s: float = BF16_FLOPS):
    """(least time on the card in ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flops_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def check_kernel(label, got, ref, tol) -> float:
    import torch

    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{label}: kernel output not finite")
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    rel = err / max(scale, 1e-30)
    log(f"    {label}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
        f"rel={rel:.3e} (tol {tol:.3e})")
    if not rel <= tol:
        raise AssertionError(f"{label}: kernel disagrees with plain: rel "
                             f"{rel} > {tol}")
    return err


def traced_body(fa, kernel, kernel_times) -> str:
    """The body (fa.BODIES) whose passes torch.profiler recorded for
    `kernel`: the f32 tensor-core body's are named *_tf32_kernel, the bf16
    one's *_tc_kernel (the dense kernel's *_wgmma_kernel), the CUDA-core
    body's plain *_kernel."""
    names = [key for key, _ in kernel_times
             if any(p in key for p in kernel.passes[:2])]
    if any("_tf32_kernel" in key for key in names):
        return fa.BODIES[0]
    if any("_tc_kernel" in key or "_wgmma_kernel" in key for key in names):
        return fa.BODIES[1]
    return fa.BODIES[2]


def check_body(fa, kernel, kernel_times, want) -> None:
    """Raises unless the passes the profiler recorded are those of the
    body the dispatch rule names."""
    got = traced_body(fa, kernel, kernel_times)
    if got != want:
        raise AssertionError(f"{kernel.name}: the dispatch rule names the "
                             f"{want} body, the trace shows {got}")


def traced(fn):
    """`device_profile(fn)`, or None where torch.profiler records no device
    time even at a second try. On an H100 machine it has recorded none from
    a run's first trace on, and late in a run; the checks that read the
    trace (`pass_split`, `check_body`) then report the passes as not traced
    and the CUDA-event times stand alone."""
    from snuffy_tpu_torch.tools.profile_serve import device_profile

    for _ in range(2):
        try:
            return device_profile(fn)
        except RuntimeError as e:
            if "no device time" not in str(e):
                raise
    log("    torch.profiler recorded no device time: the passes are not "
        "traced here")
    return None


def traced_split(fa, kernel, fn, segments, body) -> str:
    """The device ms of `fn` (one call of `kernel`) and of each pass, its
    passes checked against `body`; "not traced" where the profiler records
    no device time."""
    trace = traced(fn)
    if trace is None:
        return "device not traced"
    device, _, passes = trace
    split = pass_split(fa, kernel, passes, segments)
    check_body(fa, kernel, passes, body)
    return f"device {device:.4f}: {split}"


def pass_split(fa, kernel, kernel_times, segments) -> str:
    """The device ms per call of each of `kernel`'s passes, from
    torch.profiler's kernel times; raises if a pass the call launches
    recorded none, so that a renamed kernel cannot report 0 ms."""
    times = {p: sum(t for key, t in kernel_times if p in key)
             for p in kernel.passes}
    for p in fa.launched_passes(kernel, N, S, H * segments):
        if times[p] <= 0:
            raise AssertionError(f"the profiler found no device time for "
                                 f"{kernel.name}'s {p} pass")
    return "  ".join(f"{p} {t:.4f}" for p, t in times.items())


def phase_kernel(fa, plain, dev):
    import torch

    log("== phase 2: forward kernel vs plain PyTorch "
        f"(h={H}, N={N} with {N_VALID} valid, S={S}, dk={DK})")
    gen = torch.Generator(dev).manual_seed(1)
    worst, record = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for segments in (1, 8):
            args = attention_inputs(dtype, segments, gen, dev)
            for rate in (0.0, 0.1):
                kw = dict(dropout_rate=rate, dropout_seed=12345)
                with torch.inference_mode():
                    got = fa.fused_packed_inverted_sparse_attention(
                        *args, segments, **kw)
                    ref = plain(*args, segments, **kw)
                torch.cuda.synchronize()
                body = fa.kernel_body(*args[:3])
                log(f"  {name:8s} segments={segments} rate={rate}: {body}")
                err = check_kernel("out", got, ref, KERNEL_TOL[name])

                def kernel():
                    return fa.fused_packed_inverted_sparse_attention(
                        *args, segments, **kw)

                with torch.inference_mode():
                    if not torch.equal(kernel(), got):
                        raise AssertionError("two launches on the same inputs "
                                             "differ")
                    ms = time_ms(kernel)
                    plain_ms = time_ms(lambda: plain(*args, segments, **kw))
                    # device ms per call, and of each pass (torch.profiler)
                    split = traced_split(fa, fa.FWD, kernel, segments, body)
                    b2b = back_to_back_ms(kernel)
                log(f"    kernel {ms:.4f} ms ({split}; "
                    f"b2b {b2b:.4f})  plain {plain_ms:.4f} ms  (bitwise "
                    "equal over two launches)")
                worst = max(worst, err)
                if (name, segments, rate) == ("bfloat16", 1, 0.0):
                    q, k, v, sv, qv = args
                    nbytes = (sum(t.numel() * t.element_size()
                                  for t in (q, k, v, sv, qv))
                              + k.numel() * k.element_size())  # out
                    flops = 4 * H * DK * live_pairs(sv, qv, segments)
                    record = (ms, plain_ms, *bound_ms(nbytes, flops))
    return worst, record


def phase_backward(fa, plain_bwd, dev):
    import torch

    log("== phase 3: backward kernel vs plain PyTorch "
        f"(h={H}, N={N} with {N_VALID} valid, S={S}, dk={DK})")
    gen = torch.Generator(dev).manual_seed(4)
    worst, record = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for segments in (1, 8):
            q, k, v, sv, qv = attention_inputs(dtype, segments, gen, dev)
            g = torch.randn(k.shape, generator=gen, device=dev).to(dtype)
            for rate in (0.0, 0.1):
                kw = dict(dropout_rate=rate, dropout_seed=-271)
                seed = kw["dropout_seed"]
                with torch.inference_mode():
                    _, row_max, row_scale = fa._fwd_cuda(
                        q, k, v, sv, qv, segments, rate, seed)

                    def kernel():
                        return fa._bwd_cuda(q, k, v, sv, row_max, row_scale,
                                            g, segments, rate, seed)

                    def plain():
                        return plain_bwd(q, k, v, sv, qv, g, segments, **kw)

                    got, ref = kernel(), plain()
                    torch.cuda.synchronize()
                    body = fa.kernel_body(q, k, v, g, *got)
                    log(f"  {name:8s} segments={segments} rate={rate}: "
                        f"{body}")
                    for label, a, b in zip(("dq", "dk", "dv"), got, ref):
                        worst = max(worst, check_kernel(label, a, b,
                                                        KERNEL_TOL[name]))
                    if segments > 1:  # the dummy bag and the dead slots
                        if (got[0][:, 6 * N:].abs().sum() != 0
                                or got[1][:, 6 * S:].abs().sum() != 0):
                            raise AssertionError(
                                "gradient reached a dummy bag or dead slots")
                    if not all(torch.equal(a, b)
                               for a, b in zip(kernel(), got)):
                        raise AssertionError("two launches on the same inputs "
                                             "differ")
                    ms, plain_ms = time_ms(kernel), time_ms(plain)
                    # device ms per call, and of each pass (torch.profiler)
                    split = traced_split(fa, fa.BWD, kernel, segments, body)
                    b2b = back_to_back_ms(kernel)
                log(f"    kernel {ms:.4f} ms ({split}; "
                    f"b2b {b2b:.4f})  plain {plain_ms:.4f} ms  (bitwise "
                    "equal over two launches)")
                if (name, segments, rate) == ("bfloat16", 1, 0.0):
                    nbytes = (sum(t.numel() * t.element_size()
                                  for t in (q, k, v, g, sv, row_max,
                                            row_scale))
                              + sum(t.numel() * t.element_size()
                                    for t in got))
                    flops = 10 * H * DK * live_pairs(sv, qv, segments)
                    record = (ms, plain_ms, *bound_ms(nbytes, flops))
    return worst, record


def phase_dense(fa, dev):
    import torch

    from snuffy_tpu_torch.ops import kernels
    from snuffy_tpu_torch.ops.dense_attention import (
        dense_attention_reference,
        fused_self_attention,
    )
    from snuffy_tpu_torch.tools.profile_vit_attention import dense_work, sdpa

    log("== phase 4: dense-attention kernel vs plain PyTorch")
    gen = torch.Generator(dev).manual_seed(7)
    worst, record = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for label, z, n, n_valid, dk in DENSE_CASES:
            q, k, v = (torch.randn((z, n, dk), generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            with torch.inference_mode():
                got = fused_self_attention(q, k, v, n_valid)
                ref = dense_attention_reference(q, k, v, n_valid)
                torch.cuda.synchronize()
                body = fa.kernel_body(q, k, v, got)
                log(f"  {name:8s} {label} z={z} n={n} n_valid={n_valid} "
                    f"dk={dk}: {body}")
                worst = max(worst, check_kernel("out", got, ref,
                                                DENSE_TOL[name]))

                def kernel():
                    return fused_self_attention(q, k, v, n_valid)

                def library():
                    return sdpa(q, k, v, n_valid)

                ms, lib_ms = time_ms(kernel), time_ms(library)
                plain_ms = time_ms(
                    lambda: dense_attention_reference(q, k, v, n_valid))
                # device ms per call (torch.profiler), and 20 calls b2b
                trace, lib_trace = traced(kernel), traced(library)
                b2b, lib_b2b = (back_to_back_ms(f) for f in (kernel, library))
            if trace is not None:
                check_body(fa, kernels.DENSE, trace[2], body)
            device, lib_device = (
                "not traced" if t is None else f"{t[0]:.4f}"
                for t in (trace, lib_trace))
            bound, by, note = kernel_bound(
                fa, body, *dense_work(z, n, n_valid, dk, dtype))
            log(f"    kernel {ms:.4f} ms (device {device}, b2b "
                f"{b2b:.4f})  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms "
                f"(device {lib_device}, b2b {lib_b2b:.4f})  bound "
                f"{bound:.4f} ms ({by}; {note}; {100 * bound / b2b:.1f} % "
                "of b2b)")
            if (name, label) == ("bfloat16", "S/8 extract"):
                record = (ms, plain_ms, bound, by, lib_ms)
            del q, k, v, got, ref
    return worst, record


def check_scores(label, got, ref, tol):
    import numpy as np

    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    log(f"  {label}: max |diff| = {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{label}: {err} > {tol}")


def phase_serve(cfg, dev, kernels):
    import numpy as np
    import torch

    from snuffy_tpu_torch.embed.registry import build_embedder
    from snuffy_tpu_torch.models.snuffy import build_milnet
    from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles

    log("== phase 5: serve (ViT-S/16 + MILNet, bf16, seeded weights)")
    embedder = build_embedder("DINO", "vit_small", patch_size=16,
                              compute_dtype="bfloat16", device=dev)
    milnet = build_milnet(cfg, seed=0, device=dev)
    gen = torch.Generator(dev).manual_seed(2)

    def tiles(n):
        return torch.randint(0, 256, (n, 224, 224, 3), dtype=torch.uint8,
                             device=dev, generator=gen)

    for n in REQUESTS:  # warm-up: allocator and GEMM plans of each size
        predict_tiles(tiles(n), embedder, milnet)
    torch.cuda.synchronize()

    kernels.reset_launches()
    for n in REQUESTS:
        batch = tiles(n)
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        pred = predict_tiles(batch, embedder, milnet)
        t = pred.timings
        grew, dense = (kernels.launch_counts()[k.name] - before[k.name]
                       for k in (kernels.FWD, kernels.DENSE))
        log(f"  request n_patches={t['n_patches']} embed_s={t['embed_s']:.4f} "
            f"classify_s={t['classify_s']:.4f} total_s={t['total_s']:.4f} "
            f"bag_score={pred.bag_score:.6f} kernel_launches={grew} "
            f"dense_attention_launches={dense}")
        if t["n_patches"] != n or pred.instance_scores.shape != (n,):
            raise AssertionError("wrong output shape")
        if not (math.isfinite(pred.bag_score) and 0.0 <= pred.bag_score <= 1.0):
            raise AssertionError(f"bag score {pred.bag_score}")
        if not np.isfinite(pred.instance_scores).all():
            raise AssertionError("instance scores not finite")
        if grew < cfg.depth:
            raise AssertionError(f"kernel launched {grew} < depth times")
        if dense != 12 * math.ceil(n / 256):
            raise AssertionError(f"dense attention launched {dense} times, "
                                 "not 12 a 256-tile batch")
    serve_launches = kernels.launch_counts()

    # Reference on a small input: the same weights in f32, kernel on the
    # GPU against the plain attention on the CPU (ρ=0: no random draw).
    ref_cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  random_patch_share=0.0)
    emb32 = copy.deepcopy(embedder)
    emb32.backbone.compute_dtype = "float32"
    small = tiles(8)
    with torch.inference_mode():
        f_gpu, _ = emb32(small)
        f_cpu, _ = emb32.cpu()(small.cpu())
    check_scores("ViT-S/16 f32 embeddings, GPU vs CPU", f_gpu.cpu().numpy(),
                 f_cpu.numpy(), EMBED_TOL)
    m_gpu = build_milnet(ref_cfg, device=dev)
    m_gpu.load_state_dict(milnet.state_dict())
    m_cpu = copy.deepcopy(m_gpu).cpu()
    bag = torch.randn((320, cfg.feats_size), generator=gen, device=dev)
    mask = torch.arange(320, device=dev) < 300
    with torch.inference_mode():
        ig, bg = m_gpu(bag, mask)
        ic, bc = m_cpu(bag.cpu(), mask.cpu())
    check_scores("MILNet f32 bag logit, kernel (GPU) vs plain (CPU)",
                 bg.cpu().numpy(), bc.numpy(), SCORE_TOL)
    check_scores("MILNet f32 instance logits, GPU vs CPU",
                 ig.cpu().numpy(), ic.numpy(), SCORE_TOL)
    return milnet, serve_launches


def write_slide(path, grid, seed, background=SLIDE_BACKGROUND, levels=1):
    """A JPEG-tiled pyramid from the port's writer: textured tissue tiles
    (smooth stain-like waves plus noise, 16 patterns, each tile one of
    them) and flat background tiles, `background` of them, at random;
    level i (1 ≤ i ≤ `levels`) is level 0 taken every 2^i-th pixel.
    Returns the tissue (col, row) positions in row-scan order."""
    import numpy as np

    from snuffy_tpu_torch import native

    rng = np.random.default_rng(seed)
    tile = 256
    yy, xx = np.mgrid[0:tile, 0:tile] / tile
    patterns = []
    for p in range(16):
        wave = (120 + 60 * np.sin(4 * np.pi * (xx + 0.3 * p))
                + 40 * np.cos(3 * np.pi * (yy + 0.2 * p)))[..., None]
        rgb = wave * np.array([1.0, 0.75, 1.1]) + rng.normal(
            0, 12, (tile, tile, 3))
        patterns.append(np.clip(rgb, 0, 255).astype(np.uint8))
    level0 = np.full((grid * tile, grid * tile, 3), 245, np.uint8)
    is_tissue = rng.random((grid, grid)) >= background
    pick = rng.integers(0, len(patterns), (grid, grid))
    for r in range(grid):
        for c in range(grid):
            if is_tissue[r, c]:
                level0[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = (
                    patterns[pick[r, c]])
    native.write_tiled_tiff(path, [level0] + [
        level0[::2 ** i, ::2 ** i] for i in range(1, levels + 1)], tile=tile,
        jpeg_quality=SLIDE_QUALITY)
    return [(c, r) for r in range(grid) for c in range(grid)
            if is_tissue[r, c]]


def phase_slide(cfg, milnet, dev, kernels):
    import os
    import tempfile

    import numpy as np
    import torch

    from snuffy_tpu_torch import native
    from snuffy_tpu_torch.embed.registry import build_embedder
    from snuffy_tpu_torch.models.snuffy import build_milnet
    from snuffy_tpu_torch.pipeline.slide_inference import predict_slide
    from snuffy_tpu_torch.tiling.deepzoom import TilerConfig

    log(f"== phase 5b: whole slide (streaming predict_slide, ViT-S/16 + "
        f"MILNet bf16, a {SLIDE_GRID}x{SLIDE_GRID} grid of q{SLIDE_QUALITY} "
        "JPEG tiles of 256², 2x level, embed batch 256 at 224²)")
    t0 = time.perf_counter()
    native.get_lib()
    log(f"  slide reader built in {time.perf_counter() - t0:.2f} s, linked "
        f"with {' '.join(native.find_codec_libraries())}")
    embedder = build_embedder("DINO", "vit_small", patch_size=16,
                              compute_dtype="bfloat16", device=dev)
    tiler = TilerConfig(tile_size=256, objective_power=20.0, base_mag=20.0)
    keys = ("read_filter_s", "read_decode_s", "embed_s", "classify_s",
            "total_s")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slide.tif")
        t0 = time.perf_counter()
        tissue = write_slide(path, SLIDE_GRID, seed=11)
        log(f"  fixture: {len(tissue)} tissue tiles of {SLIDE_GRID ** 2}, "
            f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, written in "
            f"{time.perf_counter() - t0:.2f} s")
        predict_slide(path, embedder, milnet, tiler)          # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        runs = {}
        for label, kw, decode_path in (
                ("a scaled", {}, "grid_jpeg_scaled"),
                ("b unscaled", dict(scaled_decode=False), "grid"),
                ("c unscaled, no prefetch",
                 dict(scaled_decode=False, prefetch=False), "grid")):
            before = kernels.launch_counts()
            pred = predict_slide(path, embedder, milnet, tiler, **kw)
            t = pred.timings
            dense, sparse = (kernels.launch_counts()[k.name] - before[k.name]
                             for k in (kernels.DENSE, kernels.FWD))
            log(f"  ({label}) decode_path={t['decode_path']} "
                f"n_patches={t['n_patches']} "
                + " ".join(f"{k}={t[k]:.4f}" for k in keys)
                + f" reader {SLIDE_GRID ** 2 / t['read_decode_s']:.1f} "
                f"tiles/s, end to end {SLIDE_GRID ** 2 / t['total_s']:.1f} "
                f"grid tiles/s; bag_score={pred.bag_score:.6f} "
                f"dense_attention_launches={dense} "
                f"sparse_attention_launches={sparse}")
            if t["decode_path"] != decode_path:
                raise AssertionError(f"{label}: decode path "
                                     f"{t['decode_path']}")
            if pred.positions != tissue or t["n_patches"] != len(tissue):
                raise AssertionError(f"{label}: kept tiles are not the "
                                     "fixture's tissue")
            scores = np.append(pred.instance_scores, pred.bag_score)
            if not (np.isfinite(scores).all() and (scores >= 0).all()
                    and (scores <= 1).all()):
                raise AssertionError(f"{label}: scores not finite in [0, 1]")
            if dense != 12 * math.ceil(len(tissue) / 256):
                raise AssertionError(f"dense attention launched {dense} "
                                     "times, not 12 a 256-tile batch")
            if sparse < cfg.depth:
                raise AssertionError(f"sparse attention launched {sparse} < "
                                     "depth times")
            runs[label[0]] = pred
        slide_launches = kernels.launch_counts()
    a, b, c = runs["a"], runs["b"], runs["c"]
    if not (np.array_equal(b.instance_scores, c.instance_scores)
            and b.bag_score == c.bag_score):
        raise AssertionError("prefetch on and off give different scores")
    log("  (b) and (c), prefetch on and off: bitwise equal")
    check_scores("scaled (a) vs unscaled (b) instance scores",
                 a.instance_scores, b.instance_scores,
                 SCALED_TOL["instances"])
    check_scores("scaled (a) vs unscaled (b) bag score", [a.bag_score],
                 [b.bag_score], SCALED_TOL["bag"])

    # The path on the card (kernels) against the CPU (plain), f32, ρ=0,
    # on a small slide.
    ref_cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  random_patch_share=0.0)
    emb32 = copy.deepcopy(embedder)
    emb32.backbone.compute_dtype = "float32"
    m_gpu = build_milnet(ref_cfg, device=dev)
    m_gpu.load_state_dict(milnet.state_dict())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "small.tif")
        write_slide(path, 4, seed=12)
        gpu = predict_slide(path, emb32, m_gpu, tiler, embed_batch=8)
        cpu = predict_slide(path, copy.deepcopy(emb32).cpu(),
                            copy.deepcopy(m_gpu).cpu(), tiler, embed_batch=8)
    if gpu.positions != cpu.positions or not gpu.positions:
        raise AssertionError("GPU and CPU keep different tiles")
    check_scores("small slide f32 instance scores, GPU vs CPU",
                 gpu.instance_scores, cpu.instance_scores, SCORE_TOL)
    check_scores("small slide f32 bag score, GPU vs CPU", [gpu.bag_score],
                 [cpu.bag_score], SCORE_TOL)
    return slide_launches


def phase_eval(cfg, milnet, dev, kernels):
    import torch

    from snuffy_tpu_torch.models.snuffy import build_milnet
    from snuffy_tpu_torch.train.losses import mixed_mil_loss
    from snuffy_tpu_torch.train.trainer import MILTrainConfig, SnuffyTrainer

    log(f"== phase 6: packed eval ({EVAL_BAGS} bags of ({N}, "
        f"{cfg.feats_size}), {N_VALID} rows valid, chunks of "
        f"{SnuffyTrainer.EVAL_CHUNK})")
    gen = torch.Generator(dev).manual_seed(3)
    feats = torch.randn((EVAL_BAGS, N, cfg.feats_size), generator=gen,
                        device=dev)
    masks = (torch.arange(N, device=dev) < N_VALID).repeat(EVAL_BAGS, 1)
    labels = (torch.rand((EVAL_BAGS, 1), generator=gen, device=dev) > 0.5)
    bucketed = {N: (feats, masks, labels.float(), list(range(EVAL_BAGS)))}

    trainer = SnuffyTrainer(MILTrainConfig(model=cfg), dev, model=milnet)
    trainer.run_eval_epoch(
        {N: (feats[:8], masks[:8], labels[:8].float(), list(range(8)))}, 0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses, scores, ins, order = trainer.run_eval_epoch(bucketed, seed=0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    eval_launches = kernels.launch_counts()
    import numpy as np

    if scores.shape != (EVAL_BAGS, 1) or not np.isfinite(scores).all():
        raise AssertionError(f"eval scores {scores.shape} not finite")
    if not np.isfinite(losses).all() or len(ins) != EVAL_BAGS:
        raise AssertionError("eval losses/instances malformed")
    log(f"  eval: {EVAL_BAGS} bags in {elapsed:.4f} s = "
        f"{EVAL_BAGS / elapsed:.3f} bags/s (bf16, rho={cfg.random_patch_share}"
        f") kernel_launches={eval_launches}")
    if eval_launches[kernels.FWD.name] < cfg.depth * math.ceil(EVAL_BAGS / 8):
        raise AssertionError("packed eval did not run through the kernel")

    # K4 (segments=8) against K1 (segments=1), f32 and ρ=0 so both runs
    # select the same slots.
    ref_cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  random_patch_share=0.0)
    m32 = build_milnet(ref_cfg, device=dev)
    m32.load_state_dict(milnet.state_dict())
    t32 = SnuffyTrainer(MILTrainConfig(model=ref_cfg), dev, model=m32)
    _, packed, _, _ = t32.run_eval_epoch(bucketed, seed=0)
    single = []
    with torch.inference_mode():
        for b in range(EVAL_BAGS):
            il, bl = m32(feats[b], masks[b])
            _, s = mixed_mil_loss(il, bl, labels[b].float(), masks[b],
                                  t32.w)
            single.append(s.cpu().numpy())
    check_scores("packed (segments=8) vs one-bag (segments=1) bag scores",
                 packed, np.stack(single), SCORE_TOL)
    return eval_launches, EVAL_BAGS / elapsed


def phase_extract(dev, kernels):
    import csv
    import tempfile

    import numpy as np
    import torch

    from snuffy_tpu_torch.embed.pipeline import (
        embed_tiles,
        write_bag_csv,
        write_dataset_csv,
    )
    from snuffy_tpu_torch.tools.profile_vit_attention import (
        extraction_embedder,
    )

    log("== phase 7: extraction (DINO ViT-S/8 + adapter, bottleneck 64, "
        f"scale 4.0, bf16, batch {EXTRACT_BATCH}, seeded weights; bags of "
        f"{EXTRACT_BAGS} uint8 224² tiles)")
    embedder = extraction_embedder(dev)
    rng = np.random.default_rng(8)
    bags = [rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
            for n in EXTRACT_BAGS]
    embed_tiles(embedder, bags[1][:EXTRACT_BATCH], EXTRACT_BATCH)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_launches()
    rows, feats = [], []
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        embed_s = 0.0
        for i, tiles in enumerate(bags):
            t1 = time.perf_counter()
            f = embed_tiles(embedder, tiles, EXTRACT_BATCH)
            embed_s += time.perf_counter() - t1
            path = f"{out}/train/1_tumor/slide_{i}.csv"
            write_bag_csv(path, f, [f"{j}_{i}" for j in range(len(f))],
                          [j % 2 for j in range(len(f))])
            rows.append((path, 1))
            feats.append(f)
        write_dataset_csv(f"{out}/dataset.csv", rows)
        elapsed = time.perf_counter() - t0
        extract_launches = kernels.launch_counts()
        total = sum(EXTRACT_BAGS)
        dense = extract_launches[kernels.DENSE.name]
        log(f"  {total} tiles in {elapsed:.4f} s = {total / elapsed:.3f} "
            f"tiles/s with the CSVs; embed {embed_s:.4f} s = "
            f"{total / embed_s:.3f} tiles/s; dense_attention_launches={dense}")
        batches = sum(math.ceil(n / EXTRACT_BATCH) for n in EXTRACT_BAGS)
        if dense != 12 * batches:
            raise AssertionError(f"dense attention launched {dense} times, "
                                 f"not 12 x {batches} batches")
        for i, ((path, _), f, n) in enumerate(zip(rows, feats, EXTRACT_BAGS)):
            if f.shape != (n, 384) or not np.isfinite(f).all():
                raise AssertionError(f"{path}: feats {f.shape} not finite")
            with open(path, newline="") as fh:
                header, *body = list(csv.reader(fh))
            back = np.array([r[:384] for r in body], np.float32)
            positions = [f"{j}_{i}" for j in range(n)]
            if (header[-2:] != ["label", "position"] or len(body) != n
                    or not np.array_equal(back, f)
                    or [r[-1] for r in body] != positions):
                raise AssertionError(f"{path} does not read back")
        with open(f"{out}/dataset.csv", newline="") as fh:
            if list(csv.reader(fh)) != [["0", "1"]] + [[p, str(c)]
                                                       for p, c in rows]:
                raise AssertionError("dataset CSV does not read back")
    log(f"  wrote and read back {len(rows)} bag CSVs and the dataset CSV")

    # GPU (kernel) vs CPU (plain), f32, on two tiles
    emb32 = copy.deepcopy(embedder)
    emb32.backbone.compute_dtype = "float32"
    small = torch.from_numpy(bags[0][:2])
    with torch.inference_mode():
        f_gpu, _ = emb32(small.to(dev))
        f_cpu, _ = emb32.cpu()(small)
    check_scores("ViT-S/8 + adapter f32 embeddings, GPU vs CPU",
                 f_gpu.cpu().numpy(), f_cpu.numpy(), EMBED_TOL)

    # One bag as a tree of JPEG tiles (q90) through extract_dataset, which
    # decodes them with the port's libjpeg decoder: the CSV holds the
    # features of the decoded tiles.
    import glob
    import os

    from snuffy_tpu_torch import native
    from snuffy_tpu_torch.embed.pipeline import extract_dataset

    bag = bags[1]
    with tempfile.TemporaryDirectory() as root:
        bag_dir = os.path.join(root, "single", "fold1", "train", "1_tumor",
                               "slide_jpeg")
        os.makedirs(bag_dir)
        for j, tile in enumerate(bag):
            name = f"{j % 20}_{j // 20}.jpeg"
            native.write_jpeg(os.path.join(bag_dir, name), tile, quality=90)
        paths = sorted(glob.glob(os.path.join(bag_dir, "*.jpeg")))
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rows = extract_dataset(embedder, root, "fold1",
                               os.path.join(root, "out"),
                               class_labels={"1_tumor": 1},
                               batch_size=EXTRACT_BATCH)
        elapsed = time.perf_counter() - t0
        jpeg_launches = kernels.launch_counts()
        t0 = time.perf_counter()
        decoded = np.stack([native.decode_jpeg(p, 224) for p in paths])
        decode_s = time.perf_counter() - t0
        with open(rows[0][0], newline="") as fh:
            _, *body = list(csv.reader(fh))
        got = np.array([r[:384] for r in body], np.float32)
        want = embed_tiles(embedder, decoded, EXTRACT_BATCH)
        try:
            from PIL import Image
        except ImportError:
            pil = "PIL absent: not compared"
        else:
            same = all(np.array_equal(
                np.asarray(Image.open(p).convert("RGB")), d)
                for p, d in zip(paths, decoded))
            if not same:
                raise AssertionError("decode_jpeg differs from PIL's")
            pil = "every tile bitwise equal to PIL's decode"
    dense = jpeg_launches[kernels.DENSE.name]
    log(f"  JPEG bag: {len(bag)} tiles through extract_dataset in "
        f"{elapsed:.4f} s = {len(bag) / elapsed:.3f} tiles/s with decode and "
        f"CSV; decode alone {decode_s:.4f} s = {len(bag) / decode_s:.1f} "
        f"tiles/s ({pil}); dense_attention_launches={dense}")
    if rows[0][1] != 1 or got.shape != (len(bag), 384):
        raise AssertionError(f"JPEG bag CSV malformed: {got.shape}")
    if not np.array_equal(got, want):
        raise AssertionError("extract_dataset's features are not those of "
                             "its decoded tiles")
    if dense != 12 * math.ceil(len(bag) / EXTRACT_BATCH):
        raise AssertionError(f"dense attention launched {dense} times on the "
                             "JPEG bag")
    log("  JPEG bag CSV equals the embeddings of the decoded tiles")
    return {k: extract_launches[k] + jpeg_launches[k]
            for k in extract_launches}


def train_bags(count, d, gen, dev):
    import torch

    feats = torch.randn((count, N, d), generator=gen, device=dev)
    masks = (torch.arange(N, device=dev) < N_VALID).repeat(count, 1)
    labels = (torch.arange(count, device=dev) % 2).float()[:, None]
    return {N: (feats, masks, labels, list(range(count)))}


def phase_train(cfg, dev, kernels):
    import numpy as np
    import torch

    from snuffy_tpu_torch.models.snuffy import build_milnet
    from snuffy_tpu_torch.train.trainer import (
        MILTrainConfig,
        OptimizerConfig,
        SnuffyTrainer,
    )

    log(f"== phase 8: train (MILNet d={cfg.feats_size}, bf16, attention "
        f"dropout {cfg.attention_dropout}; AdamW lr 2e-2; bags of ({N}, "
        f"{cfg.feats_size}), {N_VALID} rows valid)")
    optim = OptimizerConfig(optimizer="adamw", lr=2e-2, weight_decay=5e-2)
    gen = torch.Generator(dev).manual_seed(5)
    counts = {}
    for batch, count in ((1, TRAIN_BAGS), (TRAIN_BATCH, PACKED_BAGS)):
        tcfg = MILTrainConfig(model=cfg, optim=optim, soft_average=True,
                              bag_batch_size=batch, seed=1)
        trainer = SnuffyTrainer(tcfg, dev,
                                model=build_milnet(cfg, seed=1, device=dev))
        bucketed = train_bags(count, cfg.feats_size, gen, dev)
        warm = {N: tuple(x[:batch] for x in bucketed[N])}
        trainer.run_train_epoch(warm, optim.lr, np.random.default_rng(0), 0)
        before = {k: v.detach().clone()
                  for k, v in trainer.model.state_dict().items()}
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        losses, scores, ins, order = trainer.run_train_epoch(
            bucketed, optim.lr, np.random.default_rng(1), 7)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = kernels.launch_counts()
        steps = count if batch == 1 else math.ceil(count / batch)
        w = trainer.w.item()
        if batch == 1:
            log(f"  serial: {count} steps in {elapsed:.4f} s = "
                f"{1e3 * elapsed / count:.4f} ms per step")
        else:
            log(f"  packed: {count} bags in {steps} steps of {batch} in "
                f"{elapsed:.4f} s = {count / elapsed:.3f} bags/s")
        log(f"    losses {np.round(losses, 4).tolist()}  w={w:.6f}  "
            f"kernel_launches={got}")
        if not (np.isfinite(losses).all() and np.isfinite(scores).all()
                and len(ins) == count and sorted(order) == list(range(count))):
            raise AssertionError("training outputs malformed or not finite")
        if not 0.0 <= w <= 1.0:
            raise AssertionError(f"w = {w} left [0, 1]")
        after = trainer.model.state_dict()
        still = [k for k in before if torch.equal(before[k], after[k])]
        if still:
            raise AssertionError(f"parameters did not move: {still}")
        for kernel in (kernels.FWD, kernels.BWD):
            if got[kernel.name] < cfg.depth * steps:
                raise AssertionError(
                    f"{kernel.name} launched {got[kernel.name]} < "
                    f"depth x steps = {cfg.depth * steps} times")
        for name, n in got.items():
            counts[name] = counts.get(name, 0) + n
    return counts


def phase_train_gpu_vs_cpu(cfg, dev):
    import numpy as np
    import torch

    from snuffy_tpu_torch.models.snuffy import build_milnet
    from snuffy_tpu_torch.train.losses import mixed_mil_loss
    from snuffy_tpu_torch.train.trainer import (
        MILTrainConfig,
        OptimizerConfig,
        SnuffyTrainer,
    )

    ref_cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  random_patch_share=0.0,
                                  attention_dropout=0.0, encoder_dropout=0.0)
    log("== phase 9: GPU (kernels) vs CPU (plain) training, f32, rho=0, no "
        "dropout: one gradient, then 3 serial steps")
    tcfg = MILTrainConfig(
        model=ref_cfg, soft_average=True,
        optim=OptimizerConfig(optimizer="adamw", lr=2e-2, weight_decay=5e-2))
    gen = torch.Generator(dev).manual_seed(6)
    bucketed = train_bags(3, cfg.feats_size, gen, dev)
    cpu = torch.device("cpu")

    # One gradient from the same weights: f32 sums in other orders, so
    # each tensor's gradient within 1e-4 of its largest element. The key
    # projection's bias has a true gradient of 0 (the softmax cancels it);
    # both sides give rounding noise there, so it is left out.
    grads = []
    for device in (dev, cpu):
        model = build_milnet(ref_cfg, seed=2, device=device).train()
        feats, mask, labels, _ = (x.to(device) if torch.is_tensor(x) else x
                                  for x in bucketed[N])
        ins, bag = model(feats[0], mask[0])
        loss, _ = mixed_mil_loss(ins, bag, labels[0], mask[0], 0.5)
        loss.backward()
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    worst = 0.0
    for name, g_cpu in grads[1].items():
        if name.endswith("self_attn.linears.1.bias"):
            continue
        rel = float((grads[0][name] - g_cpu).abs().max()) / max(
            float(g_cpu.abs().max()), 1e-30)
        worst = max(worst, rel)
        if not rel <= SCORE_TOL:
            raise AssertionError(f"gradient of {name}: rel {rel}")
    log(f"  gradients, GPU vs CPU: max rel diff {worst:.3e} (tol "
        f"{SCORE_TOL:.0e} of each tensor's largest element)")

    runs = []
    for device in (dev, cpu):
        model = build_milnet(ref_cfg, seed=2, device=device)
        trainer = SnuffyTrainer(tcfg, device, model=model)
        data = {N: tuple(x.to(device) if torch.is_tensor(x) else x
                         for x in bucketed[N])}
        out = trainer.run_train_epoch(data, tcfg.optim.lr,
                                      np.random.default_rng(2), 3)
        runs.append((out, {k: v.cpu() for k, v in model.state_dict().items()},
                     trainer.w.item()))
    (gl, *_), gsd, gw = runs[0]
    (cl, *_), csd, cw = runs[1]
    check_scores("losses of the 3 steps, GPU vs CPU", gl, cl,
                 SCORE_TOL * max(1.0, float(np.abs(cl).max())))
    check_scores("w after 3 steps, GPU vs CPU", [gw], [cw], SCORE_TOL)
    # Adam's step is about lr·g/(|g| + 1e-8) whatever the size of g: where
    # a gradient element is near zero, the rounding of either side moves
    # the parameter by up to lr a step. So 99 % of each tensor within
    # 1e-4 (absolute and relative), and every element within Adam's bound
    # of 2 · lr · steps; the key biases, whose gradient is all rounding
    # noise (see above), are held to that bound alone.
    lr, steps, failed = tcfg.optim.lr, 3, []
    for name in csd:
        diff = (gsd[name] - csd[name]).abs()
        off = int((diff > SCORE_TOL + SCORE_TOL * csd[name].abs()).sum())
        if off:
            log(f"    {name}: {off} of {diff.numel()} beyond {SCORE_TOL:.0e}"
                f", max |diff| {float(diff.max()):.3e}")
        key_bias = name.endswith("self_attn.linears.1.bias")
        if (float(diff.max()) > 2 * lr * steps
                or (off > diff.numel() / 100 and not key_bias)):
            failed.append(name)
    log(f"  parameters after 3 steps, GPU vs CPU: {len(csd) - len(failed)} "
        f"of {len(csd)} tensors within the bounds")
    if failed:
        raise AssertionError(f"parameters disagree: {failed}")


@contextlib.contextmanager
def capture_calls(fa, calls):
    """Inside it, K1's and K2's wrappers keep a copy of the inputs of their
    first call at each (h, k·N, k·S, dk, segments, rate) in `calls`: the
    shapes, masks and values a run gives the kernels. The wrappers' launch
    counts are untouched."""
    fwd, bwd = fa._fwd_cuda, fa._bwd_cuda

    def entry(q, k, segments, rate):
        return calls.setdefault((q.shape[0], q.shape[1], k.shape[1],
                                 q.shape[2], segments, rate), {})

    def fwd_kept(q, k, v, slot_valid, q_valid, segments, rate, seed):
        call = entry(q, k, segments, rate)
        if "fwd" not in call:
            call["fwd"] = ([t.clone() for t in (q, k, v, slot_valid,
                                                q_valid)], seed)
        return fwd(q, k, v, slot_valid, q_valid, segments, rate, seed)

    def bwd_kept(q, k, v, slot_valid, row_max, row_scale, g, segments, rate,
                 seed):
        call = entry(q, k, segments, rate)
        if "g" not in call:
            call["g"] = g.clone()
        return bwd(q, k, v, slot_valid, row_max, row_scale, g, segments,
                   rate, seed)

    fa._fwd_cuda, fa._bwd_cuda = fwd_kept, bwd_kept
    try:
        yield calls
    finally:
        fa._fwd_cuda, fa._bwd_cuda = fwd, bwd


def back_to_back_ms(fn, launches: int = 20) -> float:
    """Device ms a call: `launches` calls queued back to back between two
    CUDA events (ms-long kernels keep the queue ahead of the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


def kernel_bound(fa, body, nbytes, flops):
    """(bound ms, "bytes" or "operations", the note printed beside it): the
    larger of the bytes over HBM and the FLOPs over the peak of the
    products the body runs; the f32 tensor-core body's also over f32's 67
    TFLOP/s, the figure of the rows before it."""
    if body == fa.BODIES[0]:
        bound, by = bound_ms(nbytes, flops, TF32X3_FLOPS)
        old, old_by = bound_ms(nbytes, flops, F32_FLOPS)
        return bound, by, (f"over 3xTF32's 165 TFLOP/s; over 67 TFLOP/s "
                           f"f32 {1e3 * old:.2f} us, {old_by}")
    if body == fa.BODIES[1]:
        return (*bound_ms(nbytes, flops, BF16_FLOPS), "over bf16's 989 TFLOP/s")
    return (*bound_ms(nbytes, flops, F32_FLOPS), "over f32's 67 TFLOP/s")


def check_cli_call(fa, plain, plain_bwd, call, seg, rate, timed_too):
    """K1's output and, where the call has an output gradient, K2's dq, dk,
    dv against the plain versions; two launches of each bitwise equal; the
    body each one ran. With `timed_too`, one call and device time (20 calls
    back to back), both by CUDA events, beside the plain versions and the
    bound. → (K1's error, K2's error or 0)."""
    import torch

    (q, k, v, sv, qv), seed = call["fwd"]
    h, kn, dk = q.shape
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    dtype = str(q.dtype).removeprefix("torch.")
    tol = KERNEL_TOL[dtype]
    pairs = live_pairs(sv, qv, seg)
    body = fa.kernel_body(q, k, v)
    log(f"   {dtype} h={h} N={kn // seg} S={k.shape[1] // seg} dk={dk} "
        f"segments={seg} rate={rate}: {int(qv.sum())} live rows, {pairs} "
        f"live (row, slot) pairs; K1 body: {body}")
    errs = [0.0, 0.0]
    with torch.inference_mode():
        def fwd():
            return fa.fused_packed_inverted_sparse_attention(
                q, k, v, sv, qv, seg, **kw)

        def fwd_ref():
            return plain(q, k, v, sv, qv, seg, **kw)

        got = fwd()
        errs[0] = check_kernel("K1 out", got, fwd_ref(), tol)
        if not torch.equal(fwd(), got):
            raise AssertionError("K1: two launches on the same inputs differ")
        timed = [("K1", fwd, fwd_ref, body, 2 * q.numel() * q.element_size()
                  + 2 * k.numel() * k.element_size() + sv.numel()
                  + qv.numel(), 4 * h * dk * pairs)]
        if "g" in call:
            g = call["g"]
            _, row_max, row_scale = fa._fwd_cuda(q, k, v, sv, qv, seg, rate,
                                                 seed)

            def bwd():
                return fa._bwd_cuda(q, k, v, sv, row_max, row_scale, g, seg,
                                    rate, seed)

            def bwd_ref():
                return plain_bwd(q, k, v, sv, qv, g, seg, **kw)

            grads = bwd()
            bwd_body = fa.kernel_body(q, k, v, g, *grads)
            log(f"    K2 body: {bwd_body}")
            for name, a, b in zip(("dq", "dk", "dv"), grads, bwd_ref()):
                errs[1] = max(errs[1], check_kernel(f"K2 {name}", a, b, tol))
            if not all(torch.equal(a, b) for a, b in zip(bwd(), grads)):
                raise AssertionError("K2: two launches on the same inputs "
                                     "differ")
            # q, k, v, g, the masks and row stats in; dq, dk, dv out
            timed.append(("K2", bwd, bwd_ref, bwd_body, (
                2 * q.numel() + 3 * k.numel() + 2 * v.numel())
                * q.element_size() + sv.numel() + qv.numel() + 8 * h * kn,
                10 * h * dk * pairs))
        if timed_too:
            for name, fn, ref, fn_body, nbytes, flops in timed:
                ms, plain_ms = time_ms(fn), time_ms(ref)
                device = back_to_back_ms(fn)
                bound, by, note = kernel_bound(fa, fn_body, nbytes, flops)
                log(f"    {name} {dtype}: kernel {ms:.4f} ms (device, "
                    f"back to back, {device:.4f})  plain {plain_ms:.4f} ms  "
                    f"bound {1e3 * bound:.2f} us ({by}, {note}; "
                    f"{100 * bound / device:.1f} % of device)")
    return errs[0], errs[1]


def dummy_bag_chunk(dev, segments, n_bag=2600, n=3072, s=500, seed=17):
    """A packed chunk of the training CLI's f32 Camelyon16 recipe (h=4,
    dk=96, S=500 a bag, rate 0.1) holding one bag of `n_bag` rows in its
    3072-row bucket and, with segments > 1, dummy bags (no valid row or
    slot) in the other segments: the call `capture_calls` keeps, with an
    output gradient."""
    import torch

    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn((4, segments * m, 96), generator=gen, device=dev)
               for m in (n, s, n))
    sv = torch.rand(segments * s, generator=gen, device=dev) > 0.1
    qv = torch.arange(segments * n, device=dev) < n_bag
    sv[s:] = False
    g = torch.randn(k.shape, generator=gen, device=dev)
    return {"fwd": ([q, k, v, sv, qv], 12345), "g": g}


def phase_cli_kernels(fa, plain, plain_bwd, runs, dev):
    """K1 and K2 on the inputs phase 10's runs gave them (`runs`: label →
    the calls `capture_calls` kept), the first call at each shape: K1's
    output and, where a training step reached K2 at that shape, K2's dq,
    dk, dv against the plain versions, two launches bitwise equal, and the
    body each ran (musk1's dk=83 the CUDA-core one). Training shapes (rate
    > 0) are also timed: one call and device time (20 calls back to back),
    both by CUDA events, beside the plain versions and the bound (the f32
    tensor-core body's over 3xTF32's 165 TFLOP/s, with f32's 67 beside
    it). Then a dummy-bag chunk, one 2600-row bag padded to 4 segments,
    checked and timed beside the bag alone. Returns K1's and K2's worst
    errors."""
    log("== phase 10a: K1 and K2 against their plain versions on the inputs "
        "phase 10's runs gave them, the first call at each shape")
    worst = [0.0, 0.0]
    for label, calls in runs.items():
        log(f"  {label}: {len(calls)} shapes")
        for (h, kn, ks, dk, seg, rate), call in sorted(calls.items()):
            errs = check_cli_call(fa, plain, plain_bwd, call, seg, rate,
                                  rate > 0)
            worst = [max(a, b) for a, b in zip(worst, errs)]
    log("  a dummy-bag chunk: one 2600-row bag (3072-row bucket) padded to "
        "4 segments, f32 Camelyon16 recipe, and the bag alone")
    for seg in (4, 1):
        errs = check_cli_call(fa, plain, plain_bwd, dummy_bag_chunk(dev, seg),
                              seg, 0.1, True)
        worst = [max(a, b) for a, b in zip(worst, errs)]
    return tuple(worst)


def write_cli_tree(root, dataset, splits, seed, labelled_test=True):
    """embeddings/<dataset>/dino/<split>/<class>/<bag>.csv through the
    port's writer, and <dataset>.csv (save_class_features); classes
    alternate, a positive bag's first quarter shifted along one direction.
    Returns the bytes written."""
    import os

    import numpy as np

    from snuffy_tpu_torch.embed.pipeline import (
        save_class_features,
        write_bag_csv,
    )

    rng = np.random.default_rng(seed)
    direction = rng.standard_normal(384).astype(np.float32) / 8
    out = os.path.join(root, "embeddings", dataset, "dino")
    nbytes = 0
    for split, sizes in splits:
        for i, n in enumerate(sizes):
            y = i % 2
            x = rng.standard_normal((n, 384), dtype=np.float32)
            x[: n // 4] += y * direction
            path = os.path.join(out, split, ("0_normal", "1_tumor")[y],
                                f"{split}_{i}.csv")
            if split == "test" and labelled_test:
                write_bag_csv(path, x, [f"{j % 100}_{j // 100}"
                                        for j in range(n)],
                              [int(y and j < n // 4) for j in range(n)])
            else:
                write_bag_csv(path, x)
            nbytes += os.path.getsize(path)
    save_class_features(out, f"{dataset}.csv", seed=seed)
    return nbytes


def write_musk1(root, seed):
    """A musk1 k-fold pickle in the JAX package's format (10 folds, 0.2
    valid): MUSK1_BAGS bags of 2-40 166-d instances, classes alternating."""
    import os
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    bags = [[b % 2, np.array(list(rng.standard_normal((int(n), 166))
                                  + 0.5 * (b % 2)), dtype=object)]
            for b, n in enumerate(rng.integers(2, 41, MUSK1_BAGS))]
    folder = os.path.join(root, "datasets", "mil_dataset", "Musk")
    os.makedirs(folder)
    with open(os.path.join(folder, "musk1norm_10folds_0.2split.pkl"),
              "wb") as f:
        pickle.dump(bags, f)


def train_steps(cfg, train_sizes) -> int:
    """Optimizer steps of one epoch over bags of these many rows: a step a
    bag, or a step a chunk of bag_batch_size bags of one bucket."""
    from snuffy_tpu_torch.data.bucketing import bucket_length

    per_bucket = {}
    for n in train_sizes:
        b = bucket_length(n)
        per_bucket[b] = per_bucket.get(b, 0) + 1
    batch = max(1, cfg.bag_batch_size)
    return sum(math.ceil(c / batch) for c in per_bucket.values())


def check_cli_run(label, argv, summary, c, csv_bytes, train_sizes, got,
                  kernels):
    """Phase 10's checks of one CLI run; prints its time split."""
    import os

    import torch

    from snuffy_tpu_torch.bridge import load_reference_pth
    from snuffy_tpu_torch.models.snuffy import build_milnet
    from snuffy_tpu_torch.train import cli

    cfg = cli.build_config(cli.get_args_parser().parse_args(argv))
    t, epochs = summary["timings"], cfg.num_epochs
    steps = train_steps(cfg, train_sizes)
    train_s = sum(e["train_s"] for e in t["epochs"])
    bags = len(train_sizes) * epochs
    load = (f"load {t['load_s']:.4f} s ({csv_bytes / 2 ** 20:.1f} MiB of "
            f"CSV: {csv_bytes / 2 ** 20 / t['load_s']:.1f} MiB/s)"
            if csv_bytes else f"load {t['load_s']:.4f} s (pickle)")
    log(f"  {label}: {load}; {bags} bags in {train_s:.4f} s of training = "
        f"{bags / train_s:.3f} bags/s")
    for i, (e, h) in enumerate(zip(t["epochs"], summary["history"]), 1):
        log(f"    epoch {i}: " + "  ".join(
            f"{k[:-2]} {e.get(k, 0.0):.4f}" for k in (
                "train_s", "valid_s", "metrics_s", "checkpoint_s"))
            + f" s; train loss {h['epoch_train_loss']:.6f}, valid loss "
            f"{h['epoch_valid_loss']:.6f}, valid aucs "
            f"{h['epoch_valid_aucs']}")
    log("    tests at the best and last epochs: " + "  ".join(
        f"{k[:-2]} {v:.4f}" for k, v in t["tests"].items()) + " s; best "
        f"epoch {summary['best_epoch']}, test aucs "
        f"{summary['test_best'][f'epoch_test_best_aucs']}")
    log(f"    kernel_launches={got} (depth {cfg.model.depth} x {steps} "
        f"steps x {epochs} epochs of training)")

    if summary["best_epoch"] < 1:
        raise AssertionError(f"{label}: best epoch {summary['best_epoch']}")
    for res in summary["history"] + [summary["test_best"],
                                     summary["test_last"]]:
        for key, value in res.items():
            if key.endswith("_aucs") and "feat" not in key and (
                    len(value) != c
                    or not all(0.0 <= a <= 1.0 for a in value)):
                raise AssertionError(f"{label}: {key} = {value}")
            if key.endswith("_loss") and not math.isfinite(value):
                raise AssertionError(f"{label}: {key} = {value}")
    for kernel in (kernels.FWD, kernels.BWD):
        if got[kernel.name] < cfg.model.depth * steps * epochs:
            raise AssertionError(
                f"{label}: {kernel.name} launched {got[kernel.name]} < "
                f"depth x steps x epochs = "
                f"{cfg.model.depth * steps * epochs} times")
    run_dir = os.path.join(cfg.save_path, cfg.dataset, cfg.run_name)
    keep = {summary["best_epoch"], epochs}
    want = sorted([f"{e}.pth" for e in keep]
                  + [f"{e}_single_weight_parameter.pth" for e in keep]
                  + [f"thresholds_{e}.txt" for e in keep]
                  + ["metrics.jsonl", "summary.json"])
    if sorted(os.listdir(run_dir)) != want:
        raise AssertionError(f"{label}: {sorted(os.listdir(run_dir))} "
                             f"left, not {want}")
    best = os.path.join(run_dir, f"{summary['best_epoch']}.pth")
    model = build_milnet(cfg.model, device="cpu")
    model.load_state_dict(torch.load(best, weights_only=True), strict=True)
    model.load_state_dict(load_reference_pth(best), strict=True)
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError(f"{label}: the best checkpoint is not finite")


def measure_load(root, dataset, labelled_test):
    """What the CLI's load_s holds, taken apart: every bag of the tree read
    in this one process by the loader a pool worker runs (native strtof for
    feature-only CSVs, the csv module for label/position CSVs), and a
    spawned pool of 4 (the CLI's --num_processes) started, given one task
    each that imports the loader's module and does nothing more, and
    closed; load_datasets starts one such pool a split."""
    import multiprocessing as mp
    import os

    import numpy as np

    from snuffy_tpu_torch.data.bags import load_bag_csv, parse_number

    tree = os.path.join(root, "embeddings", dataset, "dino")
    took = {"strtof": [0, 0.0], "csv module": [0, 0.0]}
    rng = np.random.default_rng(0)
    for split in ("train", "valid", "test"):
        for folder, _, files in os.walk(os.path.join(tree, split)):
            for f in sorted(files):
                path = os.path.join(folder, f)
                route = ("csv module" if split == "test" and labelled_test
                         else "strtof")
                t0 = time.perf_counter()
                load_bag_csv(path, 1, 1, rng=rng)
                took[route][1] += time.perf_counter() - t0
                took[route][0] += os.path.getsize(path)
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(processes=4) as pool:
        pool.map(parse_number, ["1"] * 4)
    pool_s = time.perf_counter() - t0
    log(f"  {dataset} loading taken apart, one process: " + "; ".join(
        f"{route} {n / 2 ** 20:.1f} MiB in {t:.4f} s = "
        f"{n / 2 ** 20 / t:.1f} MiB/s" for route, (n, t) in took.items()
        if n) + f"; a spawned pool of 4 started and closed in {pool_s:.4f} "
        "s (three a run)")


def write_cli_froc_fixture(root, sizes):
    """Phase 10's Camelyon16 test slides get reference.csv and, for the
    tumour ones, label masks (six pages, 0.243 µm at level 0, level 0 as
    wide as the bags' positions reach at 512 px a patch; one file linked
    under each tumour slide's name): a tumour over the first rows' first
    patches, a second one and an ITC. Returns (reference path, masks dir,
    slide → type)."""
    import os

    import numpy as np

    base = os.path.join(root, "datasets", "camelyon16")
    masks = os.path.join(base, "masks")
    os.makedirs(masks)
    types = {f"test_{i}": ("tumor" if i % 2 else "normal")
             for i in range(len(sizes))}
    reference = os.path.join(base, "reference.csv")
    with open(reference, "w") as f:
        f.write("image,type\n" + "".join(f"{s}.tif,{t.title()}\n"
                                         for s, t in types.items()))
    rows = -(-max(sizes) // 100)
    lab5 = np.zeros((rows * 16, 100 * 16), np.uint8)     # 512 px / 32
    lab5[:40, :500] = 2
    lab5[150:230, 900:1300] = 2
    lab5[300:302, 1500:1502] = 2
    first = None
    for slide, t in types.items():
        path = os.path.join(masks, f"{slide}_mask.tif")
        if t != "tumor":
            continue
        if first is None:
            write_label_pyramid(path, lab5, 32, 6)
            first = path
        else:
            os.link(first, path)
    return reference, masks, types


@contextlib.contextmanager
def froc_calls(calls):
    """Inside it, eval.froc.froc_for_slides keeps each call's detections,
    types and score in `calls`."""
    from snuffy_tpu_torch.eval import froc

    real = froc.froc_for_slides

    def kept(dets, mask_for, types, *a, **k):
        out = real(dets, mask_for, types, *a, **k)
        calls.append((dets, types, out[0]))
        return out

    froc.froc_for_slides = kept
    try:
        yield calls
    finally:
        froc.froc_for_slides = real


def check_cli_froc(label, summary, calls, masks, types):
    """The FROC the run's test evaluations scored, each equal to
    froc_for_slides recomputed from the detections the run built."""
    import os

    from snuffy_tpu_torch.eval import froc

    if len(calls) != 2:
        raise AssertionError(f"{label}: {len(calls)} FROC calls, not 2")
    for tag, (dets, got_types, score) in zip(("best", "last"), calls):
        got = summary[f"test_{tag}"][f"epoch_test_{tag}_challenge_froc_score"]
        again, _, _ = froc.froc_for_slides(
            dets, lambda s: os.path.join(masks, f"{s}_mask.tif"), types, 5)
        if got_types != types or not got == score == again or not (
                0.0 <= got <= 1.0):
            raise AssertionError(f"{label}: test_{tag} FROC {got}, "
                                 f"recomputed {again}")
        n = sum(len(d) for d in dets.values())
        log(f"    test_{tag}_challenge_froc_score {got:.6f} from {n} "
            "detections: equal to froc_for_slides recomputed from them")


def phase_cli(dev, fa, kernels):
    """The port's training CLI on the card, in a temporary working
    directory: (a) the Camelyon16 recipe in f32, serial and packed steps of
    4; (b) multiclass TCGA (C=2), packed steps of 4; (c) musk1's quick
    start. Returns the launches of the four runs and, for each run, the
    inputs of K1's and K2's first call at each shape (`capture_calls`)."""
    import os
    import tempfile

    import torch

    from snuffy_tpu_torch.data.mil_pickle import load_mil_data
    from snuffy_tpu_torch.train.cli import main as train_cli

    log("== phase 10: the training CLI (python -m snuffy_tpu_torch.train) "
        "on the card, f32, 2 epochs a run")
    counts, captured = {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        try:
            t0 = time.perf_counter()
            csv_bytes = write_cli_tree(root, "camelyon16", CLI_SPLITS, 21)
            # TCGA: the same train and valid bags, feature-only test bags
            tcga = os.path.join(root, "embeddings", "tcga", "dino")
            os.makedirs(tcga)
            for split in ("train", "valid"):
                os.symlink(os.path.join(root, "embeddings", "camelyon16",
                                        "dino", split),
                           os.path.join(tcga, split))
            tcga_bytes = csv_bytes - sum(
                os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(os.path.join(
                    root, "embeddings", "camelyon16", "dino", "test"))
                for f in files)
            tcga_bytes += write_cli_tree(root, "tcga", CLI_SPLITS[2:], 22,
                                         labelled_test=False)
            write_musk1(root, 23)
            reference, masks, froc_types = write_cli_froc_fixture(
                root, CLI_SPLITS[2][1])
            log(f"  trees written in {time.perf_counter() - t0:.2f} s: "
                f"camelyon16 {csv_bytes / 2 ** 20:.1f} MiB of CSV, tcga "
                "(its train and valid bags linked) and a musk1 pickle of "
                f"{MUSK1_BAGS} bags; reference.csv and the test slides' "
                "masks")
            measure_load(root, "camelyon16", labelled_test=True)
            musk_train = [len(f) for f in load_mil_data(
                "musk1", 166, 10, 0, 0.2)[0][1]]
            loader = ["--use_mp=1", "--num_processes=4"]
            cam = ["--dataset=camelyon16", "--arch=snuffy"]
            train_sizes = CLI_SPLITS[0][1]
            runs = (
                ("(a) camelyon16, serial steps", "a1", list(CLI_RECIPE)
                 + cam + ["--bag_batch_size=1"] + loader, 1, csv_bytes,
                 train_sizes),
                ("(a) camelyon16, packed steps of 4", "a4",
                 list(CLI_RECIPE) + cam + ["--bag_batch_size=4"] + loader,
                 1, csv_bytes, train_sizes),
                ("(b) tcga multiclass C=2, packed steps of 4", "b",
                 list(CLI_RECIPE) + ["--dataset=tcga",
                                     "--arch=snuffy_multiclass",
                                     "--num_classes=2",
                                     "--bag_batch_size=4"] + loader,
                 2, tcga_bytes, train_sizes),
                ("(c) musk1 (166-d, 2 heads: dk=83)", "c",
                 ["--dataset=musk1", "--arch=snuffy", "--num_heads=2",
                  "--soft_average=1", "--num_epochs=2"], 1, 0, musk_train),
            )
            for label, tag, argv, c, nbytes, sizes in runs:
                argv = argv + [f"--wandb_run={tag}"]
                torch.cuda.synchronize()
                scored = []
                with capture_calls(fa, captured.setdefault(label, {})), \
                        froc_calls(scored):
                    kernels.reset_launches()
                    summary = train_cli(argv)
                    torch.cuda.synchronize()
                    got = kernels.launch_counts()
                check_cli_run(label, argv, summary, c, nbytes, sizes, got,
                              kernels)
                if "--dataset=camelyon16" in argv:
                    check_cli_froc(label, summary, scored, masks, froc_types)
                elif scored:
                    raise AssertionError(f"{label}: scored a FROC")
                for name, n in got.items():
                    counts[name] = counts.get(name, 0) + n
        finally:
            os.chdir(cwd)
    return counts, captured


def phase_cli_gpu_vs_cpu(dev):
    """One epoch of a small (a), ρ=0 and every dropout 0, from the same
    initial weights, through the runner on the card (kernels) and on the
    CPU (plain): losses, AUCs, thresholds and the valid bags' scores."""
    import os
    import tempfile

    import numpy as np
    import torch

    from snuffy_tpu_torch.configs import replace
    from snuffy_tpu_torch.train import cli
    from snuffy_tpu_torch.train.runner import Runner, bucket_bags
    from snuffy_tpu_torch.train.schedules import make_epoch_schedule
    from snuffy_tpu_torch.train.trainer import SnuffyTrainer

    log("== phase 10b: GPU (kernels) vs CPU (plain), one epoch of a small "
        "(a): f32, rho=0, no dropout")
    splits = (("train", (600, 700, 500, 800)), ("valid", (500, 600, 700, 400)),
              ("test", (600, 500, 700, 400)))
    with tempfile.TemporaryDirectory() as root:
        write_cli_tree(root, "camelyon16", splits, 24)
        args = cli.get_args_parser().parse_args(list(CLI_RECIPE) + [
            "--dataset=camelyon16", "--num_epochs=1",
            "--random_patch_share=0", "--use_mp=0"])
        cfg = cli.build_config(args)
        cfg = replace(cfg, embeddings_path=os.path.join(root, "embeddings"),
                      model=replace(cfg.model, attention_dropout=0.0))
        data = cli.load_datasets(cfg)
        runs = []
        for device in (dev, torch.device("cpu")):
            dcfg = replace(cfg, save_path=os.path.join(root, str(device)),
                           run_name="run")
            trainer = SnuffyTrainer(dcfg, device)
            summary = Runner(dcfg, trainer, *data).run(make_epoch_schedule(
                dcfg.optim.scheduler, dcfg.optim.lr, 1, dcfg.optim.eta_min))
            _, scores, _, _ = trainer.run_eval_epoch(
                bucket_bags(data[1][0], data[1][1]), 5)
            runs.append((summary, scores))
    (gs, g_scores), (cs, c_scores) = runs
    check_scores("valid scores after one epoch, GPU vs CPU", g_scores,
                 c_scores, SCORE_TOL)
    for tag, g, c in (("epoch 1", gs["history"][0], cs["history"][0]),
                      ("test (best)", gs["test_best"], cs["test_best"])):
        for key, want in c.items():
            if key in ("time_s", "epoch", "lr"):
                continue
            got = np.asarray(g[key], np.float64)
            want = np.asarray(want, np.float64)
            if key.endswith("accuracy") or key.endswith("aucs"):
                same = np.array_equal(got, want)
            else:  # a threshold may be +inf on both sides
                same = np.allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)
            if not same:
                raise AssertionError(f"{tag} {key}: GPU {g[key]} vs CPU "
                                     f"{c[key]}")
    log(f"  losses, thresholds within {SCORE_TOL:.0e} relative; AUCs and "
        "accuracies equal: train loss "
        f"{gs['history'][0]['epoch_train_loss']:.6f} / "
        f"{cs['history'][0]['epoch_train_loss']:.6f}, valid thresholds "
        f"{gs['history'][0]['epoch_valid_thresholds_optimal']} / "
        f"{cs['history'][0]['epoch_valid_thresholds_optimal']}")


def slide_cli_defaults():
    """The slide CLI's arguments at its defaults (the root predict_slide's:
    SimCLR ResNet-18, bf16, d=512, 4 heads, Λ=200, ρ=0, depth 1) and the
    MILNet config its `main` builds from them."""
    from snuffy_tpu_torch import predict_slide as cli
    from snuffy_tpu_torch.configs import SnuffyModelConfig

    args = cli.get_args_parser().parse_args(["--slide", "-"])
    cfg = SnuffyModelConfig(
        feats_size=args.feats_size, num_classes=args.num_classes,
        num_heads=args.num_heads, big_lambda=args.big_lambda,
        random_patch_share=args.random_patch_share, depth=args.depth,
        compute_dtype="bfloat16" if args.bf16 else "float32")
    return args, cfg


def phase_k1_dk128(fa, plain, kernels, dev):
    """K1 at the slide CLI's MILNet shape: bf16, h=4, dk=128 (the
    tensor-core body's launch_tc<128>), S = Λ = 200 slots, ρ=0, segments
    1 and 8. Device time by 20 calls back to back between CUDA events
    (late in a run torch.profiler has recorded no, or part of the, device
    time). Returns its worst error and (ms, plain ms, bound ms, bound by,
    device ms) at one bag."""
    import torch

    _, cfg = slide_cli_defaults()
    dk, s = cfg.feats_size // cfg.num_heads, cfg.k_top + cfg.k_rand
    if cfg.num_heads != H:
        raise AssertionError(f"{cfg.num_heads} heads, not {H}")
    log(f"== phase 11a: K1 at the slide CLI's shape (bf16, h={H}, N={N} "
        f"with {N_VALID} valid, S={s}, dk={dk}, rho=0)")
    built = kernels.load_kernel(kernels.FWD.name)
    lines = [line for line in ptxas_summary(built.log) if "Li128]" in line]
    if built.log and not lines:
        raise AssertionError("no ptxas line for K1's launch_tc<128> bodies")
    for line in lines or ["(built before this run: no ptxas output)"]:
        log(f"    ptxas {line}")
    gen = torch.Generator(dev).manual_seed(21)
    worst, record = 0.0, None
    kw = dict(dropout_rate=0.0, dropout_seed=0)
    for segments in (1, 8):
        args = attention_inputs(torch.bfloat16, segments, gen, dev, s=s,
                                dk=dk)

        def kernel():
            return fa.fused_packed_inverted_sparse_attention(
                *args, segments, **kw)

        with torch.inference_mode():
            got = kernel()
            ref = plain(*args, segments, **kw)
            torch.cuda.synchronize()
            log(f"  bfloat16 segments={segments}:")
            worst = max(worst, check_kernel("out", got, ref,
                                            KERNEL_TOL["bfloat16"]))
            if not torch.equal(kernel(), got):
                raise AssertionError("two launches on the same inputs differ")
            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: plain(*args, segments, **kw))
            device = back_to_back_ms(kernel)
        q, k, v, sv, qv = args
        nbytes = (sum(t.numel() * t.element_size() for t in (q, k, v, sv, qv))
                  + k.numel() * k.element_size())   # out
        bound, by = bound_ms(nbytes, 4 * H * dk * live_pairs(sv, qv,
                                                             segments))
        log(f"    kernel {ms:.4f} ms (device, back to back, {device:.4f})  "
            f"plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({by})  (bitwise "
            "equal over two launches)")
        if segments == 1:
            record = (ms, plain_ms, bound, by, device)
    return worst, record


def phase_simclr_serve(dev, kernels):
    """The slide CLI's `main` with only --slide and --device cuda, then
    predict_tiles at the same defaults on in-memory requests; a small
    request in f32 on the card against the CPU. Returns the launches."""
    import os
    import tempfile

    import numpy as np
    import torch

    from snuffy_tpu_torch import predict_slide as cli
    from snuffy_tpu_torch.embed.registry import build_embedder
    from snuffy_tpu_torch.models.snuffy import build_milnet
    from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles

    args, cfg = slide_cli_defaults()
    log(f"== phase 11b: the slide CLI at its defaults ({args.embedder} "
        f"{args.backbone}, bf16={args.bf16}, MILNet d={cfg.feats_size}, "
        f"{cfg.num_heads} heads, Lambda={cfg.big_lambda}, "
        f"rho={cfg.random_patch_share}, depth {cfg.depth}; seeded weights)")
    keys = ("read_filter_s", "read_decode_s", "embed_s", "classify_s",
            "total_s")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slide.tif")
        write_slide(path, CLI_SLIDE_GRID, seed=13)
        argv = ["--slide", path, "--device", "cuda"]
        cli.main(argv)                                         # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        pred = cli.main(argv)
        cli_launches = kernels.launch_counts()
    t = pred.timings
    log(f"  predict_slide.main on a {CLI_SLIDE_GRID}x{CLI_SLIDE_GRID} grid "
        f"of q{SLIDE_QUALITY} JPEG tiles (read at the 2x level by the "
        f"default objective {args.objective} over base {args.base_mag}): "
        f"decode_path={t['decode_path']} n_patches={t['n_patches']} "
        + " ".join(f"{k}={t[k]:.4f}" for k in keys)
        + f" bag_score={pred.bag_score:.6f} launches {cli_launches}")
    scores = np.append(pred.instance_scores, pred.bag_score)
    if t["n_patches"] <= 0 or not (np.isfinite(scores).all()
                                   and (scores >= 0).all()
                                   and (scores <= 1).all()):
        raise AssertionError("the slide CLI's scores are not finite in [0, 1]")
    if cli_launches[kernels.FWD.name] < cfg.depth:
        raise AssertionError("the slide CLI did not run K1")

    embedder = build_embedder(num_classes=cfg.num_classes,
                              compute_dtype="bfloat16", device=dev)
    milnet = build_milnet(cfg, seed=0, device=dev)
    gen = torch.Generator(dev).manual_seed(14)

    def tiles(n):
        return torch.randint(0, 256, (n, 224, 224, 3), dtype=torch.uint8,
                             device=dev, generator=gen)

    for n in REQUESTS:   # warm-up: allocator, cuDNN and GEMM plans
        predict_tiles(tiles(n), embedder, milnet)
    torch.cuda.synchronize()
    kernels.reset_launches()
    for n in REQUESTS:
        batch = tiles(n)
        torch.cuda.synchronize()
        before = kernels.launch_counts()[kernels.FWD.name]
        pred = predict_tiles(batch, embedder, milnet)
        t = pred.timings
        grew = kernels.launch_counts()[kernels.FWD.name] - before
        log(f"  request n_patches={t['n_patches']} embed_s={t['embed_s']:.4f} "
            f"classify_s={t['classify_s']:.4f} total_s={t['total_s']:.4f} "
            f"({n / t['embed_s']:.1f} tiles/s embedded) "
            f"bag_score={pred.bag_score:.6f} K1 launches={grew}")
        if t["n_patches"] != n or not np.isfinite(pred.instance_scores).all():
            raise AssertionError("wrong or non-finite request output")
        if grew < cfg.depth:
            raise AssertionError(f"K1 launched {grew} < depth times")
    tiles_launches = kernels.launch_counts()
    if tiles_launches[kernels.DENSE.name]:
        raise AssertionError("the ResNet path launched dense attention")

    # A small request in f32, the card (K1, cuDNN with TF32 off) against
    # the CPU (plain).
    emb32 = copy.deepcopy(embedder)
    emb32.backbone.compute_dtype = "float32"
    m32 = build_milnet(dataclasses.replace(cfg, compute_dtype="float32"),
                       device=dev)
    m32.load_state_dict(milnet.state_dict())
    small = tiles(16)
    with torch.inference_mode():
        f_gpu, _ = emb32(small)
        f_cpu, _ = copy.deepcopy(emb32).cpu()(small.cpu())
    check_kernel("ResNet-18 f32 embeddings, GPU vs CPU (relative)",
                 f_gpu.cpu(), f_cpu, CONV_TOL)
    gpu = predict_tiles(small, emb32, m32, embed_batch=8)
    cpu = predict_tiles(small.cpu(), copy.deepcopy(emb32).cpu(),
                        copy.deepcopy(m32).cpu(), embed_batch=8)
    check_scores("SimCLR -> d=512 MILNet f32 instance scores, GPU vs CPU",
                 gpu.instance_scores, cpu.instance_scores, SCORE_TOL)
    check_scores("SimCLR -> d=512 MILNet f32 bag score, GPU vs CPU",
                 [gpu.bag_score], [cpu.bag_score], SCORE_TOL)
    return {k: cli_launches[k] + tiles_launches[k] for k in cli_launches}


def max_ulps(got, want) -> float:
    """The largest difference of two bf16 tensors in ulps of the larger
    magnitude, values below 2^-8 of max |want| counted in the ulp of 2^-8
    max |want| (tests/test_torch_fused_attention.py `max_ulps`)."""
    import torch

    got, want = got.float(), want.float()
    floor = 2.0 ** -8 * float(want.abs().max())
    big = torch.maximum(got.abs(), want.abs()).clamp_min(floor)
    return float(((got - want).abs()
                  / torch.exp2(torch.floor(torch.log2(big)) - 7)).max())


@contextlib.contextmanager
def dense_calls(keep, check=False):
    """Inside it, the dense-attention wrapper keeps the inputs (detached
    copies) of its first call at each shape in `keep` and, with `check`,
    holds every bf16
    launch's output to the plain version within one bf16 ulp of max
    |plain|, 2^-7 (KERNEL_TOL's bf16 bound: phase 4's 2^-8 holds only
    where the largest output sits at the top of its binade). Where a
    launch is past 2^-8, it also prints the kernel's and the plain
    version's distance from the exact result (f64, p unrounded).
    keep[shape] is (q, k, v, n_valid), keep["errors"] each launch's (max
    abs error, relative to max |plain|, ulps by `max_ulps`). The launch
    counts are the kernel's alone."""
    import torch

    from snuffy_tpu_torch.ops import dense_attention as da

    launch = da._dense_cuda

    def kept(q, k, v, n_valid):
        out = launch(q, k, v, n_valid)
        if tuple(q.shape) not in keep:
            keep[tuple(q.shape)] = tuple(t.detach().clone()
                                         for t in (q, k, v)) + (
                n_valid,)
        if check:
            ref = da.dense_attention_reference(q, k, v, n_valid)
            if not bool(torch.isfinite(out.float()).all()):
                raise AssertionError("dense kernel output not finite")
            scale = max(float(ref.float().abs().max()), 1e-30)
            err = float((out.float() - ref.float()).abs().max())
            rel, ulps = err / scale, max_ulps(out, ref)
            keep.setdefault("errors", []).append((err, rel, ulps))
            if rel > DENSE_TOL["bfloat16"]:
                s_ = torch.bmm(q.double(), k.double().transpose(1, 2))
                s_ = s_ * q.shape[-1] ** -0.5
                s_[..., n_valid:] = -1e30
                exact = torch.bmm(torch.softmax(s_, dim=-1), v.double())
                log(f"    launch {len(keep['errors'])} at {tuple(q.shape)}: "
                    f"rel {rel:.3e}, {ulps:.1f} ulps; from the exact "
                    "result: kernel "
                    f"{float((out.double() - exact).abs().max()) / scale:.3e}"
                    ", plain "
                    f"{float((ref.double() - exact).abs().max()) / scale:.3e}"
                    " of max |plain|")
                del s_, exact
            if q.dtype != torch.bfloat16 or not rel <= KERNEL_TOL["bfloat16"]:
                raise AssertionError(f"dense kernel at {tuple(q.shape)} "
                                     f"disagrees with plain: rel {rel}, "
                                     f"{ulps} ulps")
        return out

    da._dense_cuda = kept
    try:
        yield keep
    finally:
        da._dense_cuda = launch


def traced_in_fresh_process(cases) -> list:
    """For each (q, k, v, n_valid) of `cases`, the [(device kernel, ms)]
    that torch.profiler records for K5 on those inputs, traced in one
    fresh Python process: late in a run this process's profiler records
    no device time (at phases 11, 12d and 14). None for a case where the
    fresh process's profiler records none either, at a second try."""
    import os
    import subprocess
    import tempfile

    import torch

    code = ("import json, sys, torch\n"
            "from snuffy_tpu_torch.ops.dense_attention import "
            "fused_self_attention\n"
            "from snuffy_tpu_torch.tools.profile_serve import device_profile\n"
            "def trace(q, k, v, n_valid):\n"
            "    for _ in range(2):\n"
            "        try:\n"
            "            return device_profile(lambda: fused_self_attention(\n"
            "                q, k, v, n_valid))[2]\n"
            "        except RuntimeError as e:\n"
            "            if 'no device time' not in str(e):\n"
            "                raise\n"
            "out = []\n"
            "for d in torch.load(sys.argv[1]):\n"
            "    q, k, v = (d[x].cuda() for x in 'qkv')\n"
            "    with torch.inference_mode():\n"
            "        out.append(trace(q, k, v, d['n_valid']))\n"
            "print(json.dumps(out))\n")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "qkv.pt")
        torch.save([{"q": q.cpu(), "k": k.cpu(), "v": v.cpu(),
                     "n_valid": n_valid} for q, k, v, n_valid in cases], path)
        proc = subprocess.run(
            [sys.executable, "-c", code, path], capture_output=True,
            text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"the traced K5 calls failed:\n{proc.stderr}")
    return [None if kernels is None else [tuple(x) for x in kernels]
            for kernels in json.loads(proc.stdout.strip().splitlines()[-1])]


def kernel_traces(cases) -> list:
    """`traced_in_fresh_process`'s lists, taken in this process while its
    profiler records device time; from the first case where it records
    none, the rest in one fresh process."""
    import torch

    from snuffy_tpu_torch.ops.dense_attention import fused_self_attention

    out = []
    for i, (q, k, v, n_valid) in enumerate(cases):
        with torch.inference_mode():
            trace = traced(lambda: fused_self_attention(q, k, v, n_valid))
        if trace is None:
            log(f"    the other {len(cases) - i} traces in a fresh process")
            return out + traced_in_fresh_process(cases[i:])
        out.append(trace[2])
    return out


def check_traced_bodies(fa, bodies, cases) -> None:
    """`check_body` for K5 at each of `cases` that a profiler traced."""
    from snuffy_tpu_torch.ops import kernels

    traces = kernel_traces(cases)
    for body, kernel_times in zip(bodies, traces):
        if kernel_times is not None:
            check_body(fa, kernels.DENSE, kernel_times, body)
    log(f"    K5's body checked against the trace at "
        f"{sum(t is not None for t in traces)} of {len(cases)} shapes "
        "(the others not traced)")


def time_dense(label, q, k, v, n_valid, trace=False):
    """K5 on these inputs: one call, plain, SDPA (one call and device) and
    the kernel's device time (20 calls back to back between CUDA events),
    beside the bound of the body the dispatch takes; with `trace`, that
    body is checked against the kernel names torch.profiler records for
    the same inputs in a fresh process."""
    import torch

    from snuffy_tpu_torch.ops import fused_attention as fa
    from snuffy_tpu_torch.ops import kernels
    from snuffy_tpu_torch.ops.dense_attention import (
        dense_attention_reference,
        fused_self_attention,
    )
    from snuffy_tpu_torch.tools.profile_vit_attention import dense_work, sdpa

    def kernel():
        return fused_self_attention(q, k, v, n_valid)

    def library():
        return sdpa(q, k, v, n_valid)

    with torch.inference_mode():
        body = fa.kernel_body(q, k, v, kernel())
        ms, lib_ms = time_ms(kernel), time_ms(library)
        plain_ms = time_ms(lambda: dense_attention_reference(q, k, v,
                                                             n_valid))
        device, lib_device = (back_to_back_ms(f) for f in (kernel, library))
    if trace:
        kernel_times = traced_in_fresh_process([(q, k, v, n_valid)])[0]
        trace = kernel_times is not None
        if trace:
            check_body(fa, kernels.DENSE, kernel_times, body)
    z, n, dk = q.shape
    bound, by, note = kernel_bound(fa, body, *dense_work(z, n, n_valid, dk,
                                                         q.dtype))
    log(f"    K5 at {label} (z={z}, n={n}, dk={dk}, "
        f"{str(q.dtype).removeprefix('torch.')}, the run's own inputs; "
        f"{body}{', traced' if trace else ''}): "
        f"kernel {ms:.4f} ms (device, back to back, {device:.4f})  plain "
        f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms (device, back to back, "
        f"{lib_device:.4f})  bound {bound:.4f} ms ({by}; {note}; "
        f"{100 * bound / device:.1f} % of b2b)")


def phase_extract_embedders(dev, kernels):
    """The extraction CLI's `main` at its defaults (SimCLR ResNet-18) and
    with MAE ViT-B/16 on phase 7's 300-tile bag written as JPEGs; then one
    batch of 128 tiles through MAE ViT-L/16, every K5 launch held to the
    plain version. Returns the launches."""
    import csv
    import glob
    import os
    import tempfile

    import numpy as np
    import torch

    from snuffy_tpu_torch import compute_feats as cf
    from snuffy_tpu_torch import native
    from snuffy_tpu_torch.embed.pipeline import embed_batch, embed_tiles
    from snuffy_tpu_torch.embed.registry import build_embedder

    log("== phase 11c: the extraction CLI (python -m "
        "snuffy_tpu_torch.compute_feats) at its defaults (SimCLR ResNet-18, "
        "bf16, batch 128, 8 decode workers) and with --embedder MAE "
        "--backbone mae_vit_base_patch16, on phase 7's 300-tile bag as "
        "q90 JPEGs; then a batch of 128 tiles through MAE ViT-L/16")
    rng = np.random.default_rng(8)
    bag = [rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
           for n in EXTRACT_BAGS][1]
    launches = {k.name: 0 for k in kernels.KERNELS}
    kept = {}
    cli_batch = cf.get_args_parser().parse_args([]).batch_size
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "datasets")
        bag_dir = os.path.join(data, "camelyon16", "single", "fold1", "train",
                               "1_tumor", "slide_jpeg")
        os.makedirs(bag_dir)
        for j, tile in enumerate(bag):
            name = f"{j % 20}_{j // 20}.jpeg"
            native.write_jpeg(os.path.join(bag_dir, name), tile, quality=90)
        paths = sorted(glob.glob(os.path.join(bag_dir, "*.jpeg")))
        decoded = np.stack([native.decode_jpeg(p, 224) for p in paths])
        for label, flags, dim, per_batch in (
                ("SimCLR", [], 512, 0),
                ("MAE", ["--embedder", "MAE", "--backbone",
                         "mae_vit_base_patch16"], 768, 12)):
            out = os.path.join(root, "embeddings")
            argv = flags + ["--datasets_path", data, "--embeddings_path",
                            out, "--device", "cuda"]
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            with dense_calls(kept):
                rows = cf.main(argv)
            elapsed = time.perf_counter() - t0
            got = kernels.launch_counts()
            for k in launches:
                launches[k] += got[k]
            dense = got[kernels.DENSE.name]
            log(f"  {label}: {len(bag)} tiles in {elapsed:.4f} s = "
                f"{len(bag) / elapsed:.3f} tiles/s through the CLI (model "
                f"build, decode pool, embed, CSVs); dense_attention_launches="
                f"{dense}")
            if dense != per_batch * math.ceil(len(bag) / cli_batch):
                raise AssertionError(f"{label}: dense attention launched "
                                     f"{dense} times")
            out_dir = os.path.join(out, "camelyon16", label)
            (csv_path, cls), = rows
            with open(csv_path, newline="") as fh:
                header, *body = list(csv.reader(fh))
            feats = np.array(body, np.float32)
            with open(os.path.join(out_dir, "camelyon16.csv"),
                      newline="") as fh:
                dataset = list(csv.reader(fh))
            if (header != [str(i) for i in range(dim)]
                    or feats.shape != (len(bag), dim)
                    or not np.isfinite(feats).all()
                    or dataset != [["0", "label"], [csv_path, str(cls)]]
                    or not os.path.exists(os.path.join(out_dir,
                                                       "embedder.pth"))):
                raise AssertionError(f"{label}: the CSVs do not read back")
            embedder = build_embedder(label, cf.get_args_parser().parse_args(
                argv).backbone, compute_dtype="bfloat16", device=dev)
            want = embed_tiles(embedder, decoded, cli_batch)
            check_kernel(f"{label} CSV vs the decoded tiles' embeddings",
                         torch.from_numpy(feats), torch.from_numpy(want),
                         EMBED_TOL)
            del embedder
    shape_b = next(s for s in kept if s[0] == 12 * cli_batch)
    time_dense(f"MAE ViT-B/16, batch {cli_batch}", *kept[shape_b])

    embedder = build_embedder("MAE", "mae_vit_large_patch16",
                              compute_dtype="bfloat16", device=dev)
    batch = bag[:EXTRACT_BATCH]
    embed_batch(embedder, batch, EXTRACT_BATCH)                # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    checked = {}
    t0 = time.perf_counter()
    with dense_calls(checked, check=True):
        feats = embed_batch(embedder, batch, EXTRACT_BATCH)
    elapsed = time.perf_counter() - t0
    got = kernels.launch_counts()
    for k in launches:
        launches[k] += got[k]
    errors = checked["errors"]
    over = sum(r > DENSE_TOL["bfloat16"] for _, r, _ in errors)
    log(f"  MAE ViT-L/16 bf16, one batch of {EXTRACT_BATCH}: "
        f"dense_attention_launches={got[kernels.DENSE.name]}, each within "
        f"{KERNEL_TOL['bfloat16']:.3e} of max |plain|: worst max_abs_err "
        f"{max(e for e, _, _ in errors):.3e}, rel "
        f"{max(r for _, r, _ in errors):.3e} ({over} of {len(errors)} "
        f"launches above phase 4's {DENSE_TOL['bfloat16']:.3e}), "
        f"{max(u for _, _, u in errors):.3f} ulps; {elapsed:.4f} s with the "
        "checks")
    if got[kernels.DENSE.name] != 24 or len(errors) != 24:
        raise AssertionError("MAE ViT-L/16 did not launch K5 24 times")
    if feats.shape != (EXTRACT_BATCH, 1024) or not np.isfinite(feats).all():
        raise AssertionError(f"MAE ViT-L/16 feats {feats.shape} not finite")
    shape_l = next(s for s in checked if s != "errors")
    time_dense(f"MAE ViT-L/16, batch {EXTRACT_BATCH}", *checked[shape_l])
    return launches, max(e for e, _, _ in errors)


def phase_vit_grid(dev):
    """ViT-S/16 at 256² input (the CLIs' --embed_size 256): the position
    grid resized from 14² to 16², f32, the card against the CPU."""
    import torch

    from snuffy_tpu_torch.embed.registry import build_embedder

    log("== phase 11d: DINO ViT-S/16 at 256² input (257 tokens, the "
        "position grid resized 14² -> 16²), f32, GPU vs CPU")
    emb = build_embedder("DINO", "vit_small", compute_dtype="float32",
                         device=dev)
    gen = torch.Generator(dev).manual_seed(15)
    x = torch.randint(0, 256, (4, 256, 256, 3), dtype=torch.uint8,
                      device=dev, generator=gen)
    keep = {}
    with torch.inference_mode(), dense_calls(keep):
        f_gpu, _ = emb(x)
    with torch.inference_mode():
        f_cpu, _ = copy.deepcopy(emb).cpu()(x.cpu())
    if list(keep) != [(4 * 6, 257, 64)]:
        raise AssertionError(f"dense attention shapes {list(keep)}")
    check_scores("ViT-S/16 256² f32 embeddings, GPU vs CPU",
                 f_gpu.cpu().numpy(), f_cpu.numpy(), EMBED_TOL)


def phase_resnet50(dev):
    """hubconf.load_dino_resnet50 from a `.pth` written here (seeded
    weights, BatchNorm statistics drawn, torchvision's names with fc and
    num_batches_tracked), f32, the card against the CPU."""
    import os
    import tempfile

    import torch

    from snuffy_tpu_torch import hubconf
    from snuffy_tpu_torch.models.resnet import FrozenBatchNorm, ResNet50

    log("== phase 11e: hubconf.load_dino_resnet50 from a written "
        "dino_resnet50.pth, f32, GPU vs CPU")
    src = ResNet50(seed=6)
    gen = torch.Generator().manual_seed(16)
    with torch.no_grad():
        for mod in src.modules():
            if isinstance(mod, FrozenBatchNorm):
                for t in (mod.weight, mod.running_var):
                    t.copy_(0.5 + torch.rand(t.shape, generator=gen))
                for t in (mod.bias, mod.running_mean):
                    t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    sd = dict(src.state_dict())
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    sd["bn1.num_batches_tracked"] = torch.tensor(100)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(sd, os.path.join(tmp, "dino_resnet50.pth"))
        gpu = hubconf.load_dino_resnet50(tmp, device=dev)
        cpu = hubconf.load_dino_resnet50(tmp, device="cpu")
    for k, v in src.state_dict().items():
        if not torch.equal(gpu.state_dict()[k].cpu(), v):
            raise AssertionError(f"{k} was not loaded")
    x = torch.rand((4, 224, 224, 3), generator=gen)
    with torch.inference_mode():
        f_gpu, f_cpu = gpu(x.to(dev)), cpu(x)
    if f_gpu.shape != (4, 2048):
        raise AssertionError(f"ResNet-50 feats {tuple(f_gpu.shape)}")
    check_kernel("ResNet-50 f32 features, GPU vs CPU (relative)",
                 f_gpu.cpu(), f_cpu, CONV_TOL)


# ---------------------------------------------------------------- phase 12

# The ROI fixture: phase 5b's SLIDE_GRID² slide carried down to an 8x
# level (the ROI's --thumb_level 3), named as a Camelyon16 test slide; an
# ASAP polygon over grid columns ROI_COLS and rows ROI_ROWS, inset 64 px
# from their edges; the nested layout on a NESTED_GRID² slide.
ROI_SLIDE, ROI_COLS, ROI_ROWS, NESTED_GRID = "test_001", (30, 60), (20, 40), 24
# A Camelyon16 slide's level-5 mask (≈ 97792 × 221184 px at level 0 over
# 32), and the scanners' 0.243 µm level-0 spacing.
FROC_MASK_SHAPE, FROC_SPACING_UM = (3056, 6912), 0.243
ROI_SUBSET = 300
# The DINO ROI run embeds the bag's first ROI_DINO_TILES tiles: its JPEG
# decode and resize run in the CLI's one process at ≈ 110 tiles/s on an
# H100 host (PERF.md), and the whole bag would take ≈ 68 s of the run.
ROI_DINO_TILES = 2500


def write_roi_polygon(path):
    """The ASAP XML of phase 12's polygon; returns the (col, row) grid
    tiles it covers."""
    (c0, c1), (r0, r1) = ROI_COLS, ROI_ROWS
    x0, x1, y0, y1 = 256 * c0 + 64, 256 * c1 - 64, 256 * r0 + 64, 256 * r1 - 64
    coords = "".join(f'<Coordinate Order="{i}" X="{x}" Y="{y}"/>'
                     for i, (x, y) in enumerate(((x0, y0), (x1, y0),
                                                 (x1, y1), (x0, y1))))
    with open(path, "w") as f:
        f.write('<ASAP_Annotations><Annotations><Annotation Name="_0" '
                'Type="Polygon" PartOfGroup="Tumor"><Coordinates>'
                f"{coords}</Coordinates></Annotation></Annotations>"
                "</ASAP_Annotations>")
    return {(c, r) for c in range(c0, c1) for r in range(r0, r1)}


def write_label_pyramid(path, lab_top, factor, pages, spacing_um=0.243):
    """A label TIFF whose page `pages - 1` is `lab_top` and page 0 is it
    blown up by `factor` (nearest), each page half the one before."""
    import numpy as np

    from snuffy_tpu_torch import native

    lab0 = np.repeat(np.repeat(lab_top, factor, axis=0), factor, axis=1)
    native.write_tiled_tiff_gray(
        path, [lab0[::2 ** i, ::2 ** i] for i in range(pages)], tile=512,
        spacing_um=spacing_um)
    return lab0


def roi_mask_at_level3(grid):
    """The ROI fixture's tumour labels at the 8x level (grid·32 px a
    side): the polygon's block, a disc, a thin bar and an ITC-sized
    speck, over a background of label 1 in one corner."""
    import numpy as np

    side = grid * 32
    lab = np.zeros((side, side), np.uint8)
    lab[:200, :200] = 1
    (c0, c1), (r0, r1) = ROI_COLS, ROI_ROWS
    lab[32 * r0 + 8:32 * r1 - 8, 32 * c0 + 8:32 * c1 - 8] = 2
    yy, xx = np.mgrid[0:side, 0:side]
    lab[(yy - 2200) ** 2 + (xx - 900) ** 2 <= 260 ** 2] = 2
    lab[2800:2830, 1800:2600] = 2
    lab[500:503, 2900:2903] = 2
    return lab


def contour_band(tumor):
    """The band mask_contour draws, by scipy's morphology (an independent
    implementation): the 3x3 gradient (no erosion from outside the image),
    dilated by 3x3."""
    import numpy as np
    import scipy.ndimage as ndi

    m = tumor > 0
    box = np.ones((3, 3), bool)
    grad = ndi.binary_dilation(m, box) & ~ndi.binary_erosion(
        m, box, border_value=1)
    return ndi.binary_dilation(grad, box)


def phase_tile_and_split(root):
    """12a-b: the Camelyon16 tiler CLI at its defaults on the ROI fixture
    and the nested layout on a small slide, then the splitter, n-shot and
    reverser CLIs. Returns (bag dir after the split, fixture paths)."""
    import csv
    import os

    import numpy as np

    from snuffy_tpu_torch import deepzoom_tiler_camelyon16 as tiler_cli
    from snuffy_tpu_torch.data.splits import n_shot_subset
    from snuffy_tpu_torch.datasets.camelyon16 import (
        train_validation_test_reverse_camelyon as reverse_cli,
    )
    from snuffy_tpu_torch.datasets.camelyon16 import (
        train_validation_test_splitter_camelyon as split_cli,
    )

    log(f"== phase 12a: the Camelyon16 tiler CLI at its defaults (-j 8, "
        f"256², q75, -t 20) on phase 5b's {SLIDE_GRID}x{SLIDE_GRID} slide "
        "carried down to 8x, with an ASAP polygon")
    base = os.path.join(root, "datasets", "camelyon16")
    for d in ("1_tumor", "0_normal", "annotations", "masks"):
        os.makedirs(os.path.join(base, d))
    slide = os.path.join(base, "1_tumor", f"{ROI_SLIDE}.tif")
    t0 = time.perf_counter()
    tissue = write_slide(slide, SLIDE_GRID, seed=31, levels=3)
    covered = write_roi_polygon(os.path.join(base, "annotations",
                                             f"{ROI_SLIDE}.xml"))
    lab3 = roi_mask_at_level3(SLIDE_GRID)
    write_label_pyramid(os.path.join(base, "masks",
                                     f"{ROI_SLIDE}_mask.tif"), lab3, 8, 4)
    log(f"  fixture: {len(tissue)} tissue tiles of {SLIDE_GRID ** 2}, "
        f"levels 1x-8x, {os.path.getsize(slide) / 2 ** 20:.1f} MiB, and a "
        f"4-page label mask; written in {time.perf_counter() - t0:.2f} s")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        t0 = time.perf_counter()
        tiler_cli.main([])
        tile_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    bag = os.path.join(base, "single", "1_tumor", ROI_SLIDE)
    names = sorted(os.listdir(bag))
    dz_level = int(np.ceil(np.log2(256 * SLIDE_GRID)))
    want = sorted(f"{c}_{r}-{dz_level}.jpeg" for c, r in tissue)
    log(f"  tiled {len(names)} of {SLIDE_GRID ** 2} grid tiles in "
        f"{tile_s:.3f} s: {len(names) / tile_s:.1f} kept tiles/s, "
        f"{SLIDE_GRID ** 2 / tile_s:.1f} grid tiles/s (8 worker processes, "
        "host clock)")
    if names != want:
        raise AssertionError(f"kept {len(names)} tiles, not the fixture's "
                             f"{len(want)} tissue tiles")
    with open(os.path.join(base, "tile_label.csv"), newline="") as f:
        labels = {row[0]: int(row[1]) for row in csv.reader(f)}
    expect = {f"{ROI_SLIDE}_{c}_{r}": int((c, r) in covered)
              for c, r in tissue}
    if labels != expect:
        raise AssertionError("tile_label.csv does not match the polygon")
    log(f"  tile_label.csv: {len(labels)} rows, {sum(labels.values())} "
        "tumour tiles, those the polygon covers")

    nested = os.path.join(root, "datasets", "nested")
    os.makedirs(os.path.join(nested, "1_tumor"))
    small = write_slide(os.path.join(nested, "1_tumor", "tumor_009.tif"),
                        NESTED_GRID, seed=32)
    os.chdir(root)
    try:
        t0 = time.perf_counter()
        tiler_cli.main(["-d", "nested", "-m", "0", "1"])
        nested_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    nbag = os.path.join(nested, "single", "1_tumor", "tumor_009")
    subs = [d for d in os.listdir(nbag)
            if os.path.isdir(os.path.join(nbag, d))]
    lows = [f for f in os.listdir(nbag) if f.endswith(".jpeg")]
    highs = sum(len(os.listdir(os.path.join(nbag, d))) for d in subs)
    for d in subs:
        c, r = (int(v) for v in d.split("-")[0].split("_"))
        for f in os.listdir(os.path.join(nbag, d)):
            hc, hr = (int(v) for v in f.split("-")[0].split("_"))
            if (hc // 2, hr // 2) != (c, r):
                raise AssertionError(f"{d}/{f} is not under its low patch")
    # a tissue tile stays under its low patch where that patch (the 2x2
    # tiles it covers, at half size) is not background
    parents = {tuple(int(v) for v in f.split("-")[0].split("_"))
               for f in lows}
    want_high = [t for t in small if (t[0] // 2, t[1] // 2) in parents]
    if not subs or highs != len(want_high):
        raise AssertionError(f"nested: {highs} high tiles in {len(subs)} "
                             f"folders, not {len(want_high)}")
    log(f"  nested (-m 0 1) on a {NESTED_GRID}x{NESTED_GRID} slide: "
        f"{len(lows)} low patches, {len(subs)} folders holding {highs} "
        f"high patches (the {len(small)} tissue tiles under a kept low "
        f"patch), {nested_s:.3f} s")
    # the tiler's cost a grid tile, in one process and in 8 spawned ones
    from snuffy_tpu_torch.tiling.deepzoom import TilerConfig, tile_slide

    for workers in (0, 8):
        cfg = TilerConfig(tile_size=256, objective_power=20, base_mag=20,
                          background_threshold=20, workers=workers)
        t0 = time.perf_counter()
        tile_slide(os.path.join(nested, "1_tumor", "tumor_009.tif"),
                   os.path.join(root, f"tiles_{workers}"), cfg)
        dt = time.perf_counter() - t0
        log(f"  tile_slide on its {NESTED_GRID ** 2} grid tiles, "
            f"{'in one process' if not workers else '8 spawned workers'}: "
            f"{dt:.4f} s, {1e3 * dt / NESTED_GRID ** 2:.3f} ms a grid tile")

    log("== phase 12b: the splitter, n-shot and reverser CLIs on that tree")
    for i in range(1, 5):      # four small normal bags beside the slide
        d = os.path.join(base, "single", "0_normal", f"normal_{i:03}")
        os.makedirs(d)
        for name in names[3 * i:3 * i + 3]:
            os.link(os.path.join(bag, name), os.path.join(d, name))
    with open(os.path.join(base, "reference.csv"), "w") as f:
        f.write("image,type\n" + "".join(f"normal_{i:03}.tif,Normal\n"
                                         for i in range(1, 5))
                + f"{ROI_SLIDE}.tif,Tumor\n")
    os.chdir(base)
    try:
        rows = split_cli.main([])
        fold = os.path.join("single", "fold1")
        shot = n_shot_subset(os.path.join(fold, "train"),
                             os.path.join(fold, "train_2shot"), 2, seed=0)
        moved = reverse_cli.main([])
        restored = sorted(os.listdir(os.path.join("single", "1_tumor",
                                                  ROI_SLIDE)))
        rows = split_cli.main([])
    finally:
        os.chdir(cwd)
    split = {r["name"]: r["split"] for r in rows}
    if (split[ROI_SLIDE] != "test" or moved != 5 or restored != names
            or shot != 6):
        raise AssertionError(f"split {split}, moved back {moved}, n-shot "
                             f"{shot}")
    log(f"  fold1: {split}; n-shot kept {shot} patches; the reverser moved "
        f"{moved} slides back, the bag intact; split again")
    bag = os.path.join(base, "single", "fold1", "test", "1_tumor", ROI_SLIDE)
    return bag, base, tissue, lab3


def write_aggregator(path, cfg):
    """A seeded MILNet of `cfg` saved as a reference `.pth`."""
    import torch

    from snuffy_tpu_torch.models.snuffy import build_milnet

    torch.save(build_milnet(cfg, seed=3, device=torch.device("cpu"))
               .state_dict(), path)


def roi_argv(bag_glob, base, weights, out, device, extra=()):
    import os

    return ["--aggregator_weights", weights, "--bags_path", bag_glob,
            "--slides_path", os.path.join(base, "1_tumor"),
            "--masks_path", os.path.join(base, "masks"), "--output", out,
            "--device", device, *extra]


def phase_roi(root, bag, base, lab3, fa, kernels, dev):
    """12c: the ROI CLI's `main` over the tiled bag, SimCLR ResNet-18 at
    its defaults (4 heads) and DINO ViT-S/16; K1's and K5's first call at
    each shape kept; the PNG read back; a 300-tile subset on the card
    against the CPU. Returns (launches, kept K1 calls, kept K5 calls, the
    SimCLR record)."""
    import os

    import numpy as np
    import torch

    from snuffy_tpu_torch import roi
    from snuffy_tpu_torch.configs import SnuffyModelConfig
    from snuffy_tpu_torch.viz.heatmap import mask_contour
    from snuffy_tpu_torch.viz.png import read_png

    defaults = roi.get_args_parser().parse_args(
        ["--aggregator_weights", "-", "--bags_path", "-"])
    runs = (("SimCLR ResNet-18", [], 4, 512, None),
            ("DINO ViT-S/16", ["--embedder", "DINO", "--backbone",
                               "vit_small", "--feats_size", "384"], 6, 384,
             ROI_DINO_TILES))
    log(f"== phase 12c: the ROI CLI (python -m snuffy_tpu_torch.roi) over "
        f"the tiled bag, f32, depth {defaults.depth}, Lambda "
        f"{defaults.big_lambda}, thumbnail level {defaults.thumb_level}")
    launches = {k.name: 0 for k in kernels.KERNELS}
    k1_calls, k5_calls, first = {}, {}, None
    def subset_of(tiles):
        """A bag directory of the bag's first `tiles` tiles (links)."""
        d = os.path.join(root, f"first_{tiles}", ROI_SLIDE)
        os.makedirs(d)
        for name in sorted(os.listdir(bag))[:tiles]:
            os.symlink(os.path.join(bag, name), os.path.join(d, name))
        return os.path.join(root, f"first_{tiles}", "*")

    small = subset_of(ROI_SUBSET)
    thumb = lab3 == 2
    want_band = contour_band(thumb)
    for label, flags, heads, d, tiles in runs:
        weights = os.path.join(root, f"milnet_{d}.pth")
        cfg = SnuffyModelConfig(
            feats_size=d, num_heads=heads, big_lambda=defaults.big_lambda,
            random_patch_share=defaults.random_patch_share,
            depth=defaults.depth)
        write_aggregator(weights, cfg)
        extra = flags + ["--num_heads", str(heads)]
        out = os.path.join(root, f"roi_{d}")
        torch.cuda.synchronize()
        with capture_calls(fa, k1_calls), dense_calls(k5_calls):
            kernels.reset_launches()
            (rec,) = roi.main(roi_argv(subset_of(tiles) if tiles else bag,
                                       base, weights, out, "cuda", extra))
            torch.cuda.synchronize()
            got = kernels.launch_counts()
        n = len(rec["scores"])
        batches = math.ceil(n / defaults.batch_size)
        want_k5 = 12 * batches if "DINO" in label else 0
        which = " (the bag's first)" if tiles else ""
        log(f"  {label} (d={d}, {heads} heads, dk={d // heads}): {n} tiles"
            f"{which}, "
            f"embed_s {rec['embed_s']:.4f} ({n / rec['embed_s']:.1f} "
            f"tiles/s, JPEG decode included) classify_s "
            f"{rec['classify_s']:.4f} per bag; bag score "
            f"{rec['bag_score']:.6f}; launches {got}")
        if (got[kernels.FWD.name] != cfg.depth or got[kernels.BWD.name]
                or got[kernels.DENSE.name] != want_k5):
            raise AssertionError(f"{label}: launches {got}, not K1 "
                                 f"{cfg.depth} and K5 {want_k5}")
        for k, v in got.items():
            launches[k] += v
        scores = np.append(rec["scores"], rec["bag_score"])
        if not (np.isfinite(scores).all() and (scores >= 0).all()
                and (scores <= 1).all()):
            raise AssertionError(f"{label}: scores not finite in [0, 1]")
        img = read_png(rec["png"])
        green = (img[..., :3] == (0, 255, 0)).all(-1)
        if img.shape != thumb.shape + (4,) or not (img[..., 3] == 255).all():
            raise AssertionError(f"{label}: PNG {img.shape}, not the "
                                 f"thumbnail's {thumb.shape}")
        if not (np.array_equal(green, want_band)
                and np.array_equal(green, mask_contour(thumb))):
            raise AssertionError(f"{label}: the green contour is not the "
                                 "mask's boundary band")
        log(f"    PNG {img.shape[1]}x{img.shape[0]} RGBA read back: "
            f"{int(green.sum())} green pixels, all on the mask's boundary "
            "band (scipy's morphology)")
        first = first or rec

        # the same models, card against CPU, on a 300-tile subset
        (gpu,) = roi.main(roi_argv(small, base, weights, out + "_gpu",
                                   "cuda", extra))
        (cpu,) = roi.main(roi_argv(small, base, weights, out + "_cpu",
                                   "cpu", extra))
        check_scores(f"{label}, {ROI_SUBSET} tiles: instance scores GPU vs "
                     "CPU", gpu["scores"], cpu["scores"], SCORE_TOL)
        check_scores(f"{label}: bag score GPU vs CPU", [gpu["bag_score"]],
                     [cpu["bag_score"]], SCORE_TOL)
    return launches, k1_calls, k5_calls, first


def phase_roi_kernels(fa, plain, plain_bwd, kernels, k1_calls, k5_calls):
    """12d: K1 (f32 at dk=128 and dk=64) and K5 (f32) on the inputs the
    ROI runs gave them: error against the tolerance, two launches bitwise
    equal, one-call and back-to-back times beside the bound; ptxas's
    registers and spills for K1's f32 tensor-core body at dk=128."""
    import torch

    from snuffy_tpu_torch.ops.dense_attention import (
        dense_attention_reference,
        fused_self_attention,
    )

    log("== phase 12d: K1 and K5 against their plain versions on the inputs "
        "the ROI runs gave them")
    built = kernels.load_kernel(kernels.FWD.name)
    lines = [line for line in ptxas_summary(built.log)
             if "tf32" in line and "Li128]" in line]
    if built.log and not lines:
        raise AssertionError("no ptxas line for K1's f32 tensor-core body at "
                             "dk=128")
    for line in lines or ["(built before this run: no ptxas output)"]:
        log(f"    ptxas {line}")
    k1_err = 0.0
    dks = sorted(key[3] for key in k1_calls)
    if dks != [64, 128]:
        raise AssertionError(f"the ROI runs gave K1 dk {dks}, not 64 and 128")
    for (h, kn, ks, dk, seg, rate), call in sorted(k1_calls.items()):
        err, _ = check_cli_call(fa, plain, plain_bwd, call, seg, rate, True)
        k1_err = max(k1_err, err)
    (shape,) = [s for s in k5_calls if s != "errors"]
    q, k, v, n_valid = k5_calls[shape]
    with torch.inference_mode():
        got = fused_self_attention(q, k, v, n_valid)
        k5_err = check_kernel(f"K5 f32 {tuple(q.shape)} out", got,
                              dense_attention_reference(q, k, v, n_valid),
                              DENSE_TOL["float32"])
        if not torch.equal(fused_self_attention(q, k, v, n_valid), got):
            raise AssertionError("K5: two launches on the same inputs differ")
    time_dense(f"the ROI's ViT-S/16 batch {q.shape[0] // 6}", q, k, v,
               n_valid, trace=True)
    return k1_err, k5_err


def phase_froc(roi_record, base, lab3):
    """12e: the ROI's instance scores as detections against the fixture's
    mask; then compute_evaluation_mask and EvalMaskCache (cold, warm in
    memory, warm from the npz) on a Camelyon16 level-5-sized label mask,
    its ITC set and score against an ArrayMaskReader of the same array."""
    import os
    import tempfile

    import numpy as np

    from snuffy_tpu_torch.eval import froc

    log("== phase 12e: FROC")
    path = os.path.join(base, "masks", f"{ROI_SLIDE}_mask.tif")
    dets = {ROI_SLIDE: [
        (float(p), 256 * int(pos.split("_")[0]) + 128,
         256 * int(pos.split("_")[1]) + 128)
        for p, pos in zip(roi_record["scores"], roi_record["positions"])]}
    types = {ROI_SLIDE: "tumor"}
    t0 = time.perf_counter()
    score, fps, sens = froc.froc_for_slides(dets, lambda s: path, types, 5)
    froc_s = time.perf_counter() - t0
    arr = froc.ArrayMaskReader({5: froc.MaskLevel(
        lab3[::4, ::4], 32.0, FROC_SPACING_UM)})
    want = froc.froc_for_slides(dets, lambda s: arr, types, 5)
    if (score, fps, sens) != want or not 0.0 <= score <= 1.0:
        raise AssertionError(f"ROI FROC {score} from the TIFF, {want[0]} "
                             "from the array")
    log(f"  the ROI's {len(dets[ROI_SLIDE])} instance scores as detections "
        f"(tile centres at level 0) against the fixture's mask, level 5: "
        f"score {score:.6f}, {len(fps)} curve points, {froc_s:.4f} s; the "
        "same from an ArrayMaskReader")

    h, w = FROC_MASK_SHAPE
    rng = np.random.default_rng(41)
    lab = np.zeros((h, w), np.uint8)
    lab[rng.random((h, w)) < 0.002] = 1
    yy, xx = np.ogrid[0:h, 0:w]
    for cy, cx, ry, rx in ((500, 900, 160, 220), (1800, 3000, 90, 60),
                           (2600, 5800, 240, 310), (1200, 6100, 40, 45),
                           (2900, 400, 120, 80)):
        lab[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 2
    lab[700:703, 4500:4503] = 2                        # an ITC
    lab[2200:2202, 1500:1502] = 2                      # an ITC
    # the page is the file's level 0 at the level-5 spacing (0.243 µm x 32)
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "tumor_level5_mask.tif")
        from snuffy_tpu_torch import native

        native.write_tiled_tiff_gray(mpath, [lab], tile=512,
                                     spacing_um=FROC_SPACING_UM * 32)
        reader = froc.NativeMaskReader(mpath)
        t0 = time.perf_counter()
        ev, itcs = froc.compute_evaluation_mask(reader, 0, False)
        plain_s = time.perf_counter() - t0
        ref = froc.ArrayMaskReader({5: froc.MaskLevel(lab, 32.0,
                                                      FROC_SPACING_UM)})
        ev_a, itcs_a = froc.compute_evaluation_mask(ref, 5, False)
        if not (np.array_equal(ev, ev_a) and itcs == itcs_a and itcs):
            raise AssertionError("the level-5 mask's evaluation mask or ITCs "
                                 "differ from the ArrayMaskReader's")
        cache_dir = os.path.join(tmp, "cache")
        cache = froc.EvalMaskCache(cache_dir)
        times = []
        for c in (cache, cache, froc.EvalMaskCache(cache_dir)):
            t0 = time.perf_counter()
            entry = c.get(mpath, 0, False)
            times.append(time.perf_counter() - t0)
            if not (np.array_equal(entry[0], ev) and entry[1] == itcs):
                raise AssertionError("EvalMaskCache served another mask")
        # detections at mask pixels: level-0 coordinates of the array
        # (level 5, downsample 32), the file's own of its page
        px = [(0.9, 900, 500), (0.7, 3000, 1800), (0.5, 1, 1),
              (0.3, 4501, 701), (0.2, 6000, 2600)]
        s_file = froc.froc_for_slides({"m": px}, lambda s: mpath,
                                      {"m": "tumor"}, 0, mask_cache=cache)
        s_arr = froc.froc_for_slides(
            {"m": [(p, 32.0 * x, 32.0 * y) for p, x, y in px]},
            lambda s: ref, {"m": "tumor"}, 5)
        if s_file != s_arr:
            raise AssertionError(f"level-5 mask: score {s_file[0]} from the "
                                 f"TIFF, {s_arr[0]} from the array")
        npz = len(os.listdir(cache_dir))
        reader.close()
    log(f"  a {w}x{h} level-5 label mask (spacing {FROC_SPACING_UM} um at "
        f"level 0; {int(ev.max())} regions, {len(itcs)} ITCs): "
        f"compute_evaluation_mask {plain_s:.4f} s; EvalMaskCache cold "
        f"{times[0]:.4f} s, warm in memory {times[1]:.6f} s, warm from the "
        f"npz {times[2]:.4f} s ({npz} npz); ITCs and score "
        f"{s_file[0]:.6f} equal the ArrayMaskReader's (host clock)")


def phase_dsmil(dev):
    """12g: the port's DSMIL MILNet (feats 512, C=2, 10000 rows padded to
    10240) on the card against the CPU, f32."""
    import copy

    import torch

    from snuffy_tpu_torch.models.dsmil import build_dsmil

    log("== phase 12g: DSMIL MILNet (512-d, C=2, 10000 rows in 10240), f32, "
        "GPU vs CPU")
    cpu = build_dsmil(512, 2, seed=5, device=torch.device("cpu"))
    gpu = copy.deepcopy(cpu).to(dev)
    gen = torch.Generator().manual_seed(6)
    feats = torch.randn((10240, 512), generator=gen)
    mask = torch.arange(10240) < 10000
    feats[10000:] = 0
    with torch.inference_mode():
        want = cpu(feats, mask)
        got = gpu(feats.to(dev), mask.to(dev))
        torch.cuda.synchronize()
    for name, g, w in zip(("instance logits", "bag logits", "attention"),
                          got, want):
        check_kernel(f"DSMIL {name} (relative to max |CPU|)", g.cpu(), w,
                     1e-5)
    if not (got[2][10000:] == 0).all():
        raise AssertionError("DSMIL: padded rows got attention")


def report_matplotlib():
    try:
        import matplotlib
    except ImportError as e:
        log(f"  matplotlib: not importable ({e}); plot_froc is the one "
            "caller")
        return
    log(f"  matplotlib {matplotlib.__version__} imports (plot_froc's "
        "lazy import)")


def phase_eval_viz(fa, plain, plain_bwd, kernels, dev):
    """Phase 12: tile, split, ROI heat maps, their kernels, FROC and DSMIL.
    Returns (launches of the ROI runs, K1's and K5's worst errors)."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        bag, base, tissue, lab3 = phase_tile_and_split(root)
        launches, k1_calls, k5_calls, rec = phase_roi(root, bag, base, lab3,
                                                      fa, kernels, dev)
        k1_err, k5_err = phase_roi_kernels(fa, plain, plain_bwd, kernels,
                                           k1_calls, k5_calls)
        del k1_calls, k5_calls
        phase_froc(rec, base, lab3)
    phase_dsmil(dev)
    report_matplotlib()
    return launches, k1_err, k5_err


# ---------------------------------------------------------------- phase 13

# Phase 13: the DINO-adapter CLI at its defaults on DINO_IMAGES 224² q75
# JPEGs (two classes; two full batches of 64), 2 epochs of 2 steps.
DINO_IMAGES = 128
DINO_ARGV = ("--epochs", "2", "--max_steps_per_epoch", "2",
             "--freeze_last_layer", "1", "--warmup_epochs", "1")
# (d) GPU vs CPU, one f32 step: loss and centre relative to their max,
# parameters within Adam's 2·lr and 99 % within 1e-4 (as phase 9).
DINO_GPU_CPU_TOL = 1e-4
DINO_GPU_CPU_LR = 1e-4
# (e): K5's (z, n, dk) at the DINO crops: bf16 (a, c) at ViT-S/16's
# globals and locals at batch 64 and S/8's at batch 16; f32 (b, d) at the
# extraction batch of 32 tiles and (d)'s 4 images
DINO_K5_SHAPES = {(768, 197, 64), (3072, 37, 64), (192, 785, 64),
                  (768, 145, 64), (192, 197, 64), (48, 197, 64), (48, 37, 64)}


def write_image_folder(root, count, size, seed):
    """`count` size² q75 JPEGs in two class folders: smooth seeded
    gradients with noise, as tissue tiles compress."""
    import os

    import numpy as np

    from snuffy_tpu_torch import native

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(count):
        cls = os.path.join(root, ("normal", "tumor")[i % 2])
        os.makedirs(cls, exist_ok=True)
        a, b, c = rng.uniform(0.2, 1.0, 3)
        base = np.stack([a * yy + (1 - a) * xx, b * xx, c * (1 - yy)], -1)
        img = np.clip(255 * (0.6 * base + 0.4 * rng.random(base.shape)), 0,
                      255).astype(np.uint8)
        native.write_jpeg(os.path.join(cls, f"{i:04d}.jpeg"), img, 75)
    return root


def decode_ways(paths, size):
    """Seconds to decode `paths`: one thread, the batcher's 8 threads, and
    a spawned pool of 8 (its start apart)."""
    import multiprocessing as mp

    from snuffy_tpu_torch.ssl.data import ImageBatcher, decode

    t0 = time.perf_counter()
    one = [decode(p, size) for p in paths]
    t1 = time.perf_counter()
    batcher = ImageBatcher(paths, len(paths), size, num_workers=8)
    threads = batcher.decode_batch(paths)
    t2 = time.perf_counter()
    batcher.close()
    pool = mp.get_context("spawn").Pool(8)
    try:
        pool.starmap(decode, [(paths[0], size)] * 8)
        t3 = time.perf_counter()
        spawned = pool.starmap(decode, [(p, size) for p in paths])
        t4 = time.perf_counter()
    finally:
        pool.close()
        pool.join()
    import numpy as np

    if not (np.array_equal(np.stack(one), threads)
            and np.array_equal(np.stack(one), np.stack(spawned))):
        raise AssertionError("the three decodes disagree")
    return t1 - t0, t2 - t1, t4 - t3, t3 - t2


def dino_state_dicts(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def check_dino_run(init, ckpt0, final):
    """(a)'s checks on the student/teacher state dicts: the frozen
    backbone bit for bit, adapters and head moved, the last layer frozen
    through epoch 0 and moved in epoch 1, the teacher neither the student
    nor its start."""
    import torch

    s0, s1, s2 = init["student"], ckpt0["student"], final["student"]
    frozen = [k for k in s0 if k.startswith("backbone.")
              and "adaptmlp" not in k]
    moved = [k for k in frozen if not torch.equal(s0[k], s2[k])]
    if moved or not frozen:
        raise AssertionError(f"frozen backbone tensors moved: {moved[:3]}")
    for group in ("adaptmlp", "head.mlp"):
        if not any(not torch.equal(s0[k], s2[k]) for k in s0 if group in k):
            raise AssertionError(f"no {group} tensor moved")
    v = "head.last_layer.weight_v"
    if not torch.equal(s0[v], s1[v]) or torch.equal(s1[v], s2[v]):
        raise AssertionError("last_layer: not frozen through epoch 0, or "
                             "not moved in epoch 1")
    t0, t2 = init["teacher"], final["teacher"]
    ad = [k for k in s0 if "adaptmlp" in k]
    if all(torch.equal(t2[k], s2[k]) for k in ad):
        raise AssertionError("the teacher's adapters equal the student's")
    if all(torch.equal(t2[k], t0[k]) for k in ad):
        raise AssertionError("the teacher's adapters did not move")
    log(f"    frozen backbone: {len(frozen)} tensors bit for bit; adapters, "
        "head moved; last_layer frozen through epoch 0, moved in epoch 1; "
        "teacher ≠ student, ≠ its start")


def classify_kernel(name: str) -> str:
    import re

    if "dense_attention" in name:
        return "K5"
    if re.search(r"gemm|cutlass|xmma|cublas|matmul|sm90_", name, re.I):
        return "GEMM"
    if re.search(r"elementwise|vectorized|unrolled|reduce|softmax|norm|"
                 r"index|gather|scatter|copy|fill|cat|where", name, re.I):
        return "elementwise/reductions"
    return "other"


def profile_step(augment, step, attention, dev):
    """Warm steps of a trainer (`step(timings)` runs one, `augment()` its
    input's augment alone): their host-clock split (the device
    synchronised between stages), then one augment and one augment + step
    under torch.profiler (device busy by kind, the idle share against the
    un-profiled wall); then the plain attention backward (K5's gradient)
    timed apart, 20 calls back to back, at each (label, z, n, dk, blocks)
    of `attention`, and its share of the step's device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from snuffy_tpu_torch.ops.dense_attention import dense_attention_reference

    for _ in range(2):
        step(None)
    torch.cuda.synchronize()
    reps, split = 3, {}
    t0 = time.perf_counter()
    for _ in range(reps):
        step(split)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / reps
    log(f"    a warm step (mean of {reps}): {wall:.2f} ms wall: " + ", ".join(
        f"{k.removesuffix('_s')} {1e3 * v / reps:.2f} ms"
        for k, v in split.items()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        augment()                        # the profiler's own start-up
    busy_of = {}
    for label, fn in (("augment", augment),
                      ("augment + step", lambda: step(None))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kinds = {}
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                kind = classify_kernel(e.key)
                kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
        busy = sum(kinds.values())
        if busy <= 0:
            log(f"    profile, {label}: torch.profiler recorded no device "
                "time; device busy and idle not measured")
            continue
        busy_of[label] = busy
        log(f"    profile, {label}: device busy {busy:.3f} ms; " +
            ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f} %)"
                      for k, v in sorted(kinds.items(), key=lambda r: -r[1])))
        top = sorted(((getattr(e, "self_device_time_total", 0) / 1e3,
                       e.count, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     reverse=True)[:8]
        for ms, count, name in top:
            log(f"      {ms:8.3f} ms  {count:4d}x  {name[:110]}")
    traced_all = len(busy_of) == 2
    if traced_all:
        log(f"    device idle over the warm step's {wall:.2f} ms wall: "
            f"{100 * (1 - busy_of['augment + step'] / wall):.1f} %")
    total = 0.0
    for label, z, n, dk, blocks in attention:
        q, k, v = (torch.randn((z, n, dk), device=dev, dtype=torch.bfloat16,
                               requires_grad=True) for _ in range(3))
        g = torch.randn((z, n, dk), device=dev, dtype=torch.bfloat16)

        def backward():
            return torch.autograd.grad(
                dense_attention_reference(q, k, v, n), (q, k, v), g)

        ms = back_to_back_ms(backward)
        total += ms * blocks
        log(f"    plain attention backward at the {label} (z={z}, n={n}, "
            f"dk={dk}, bf16): {ms:.4f} ms b2b (recompute + gradient), × "
            f"{blocks} blocks = {ms * blocks:.3f} ms a step")
    if not traced_all:
        log(f"    plain attention backward: {total:.3f} ms a step; its share "
            "of the step's device busy not measured")
        return
    step_busy = busy_of["augment + step"] - busy_of["augment"]
    log(f"    plain attention backward: {total:.3f} ms of the step's "
        f"{step_busy:.3f} ms device busy ({100 * total / step_busy:.1f} %)")


def profile_dino_step(trainer, state, batch, dev):
    """Warm DINO steps of the CLI's trainer under `profile_step`, the
    plain attention backward at the globals' and the locals' shapes."""
    import torch

    from snuffy_tpu_torch.ssl.augment import dino_multicrop_batch

    gen = torch.Generator(dev).manual_seed(5)
    imgs = torch.from_numpy(batch).to(dev)

    def augment():
        return dino_multicrop_batch(imgs, gen)

    def step(timings):
        t0 = time.perf_counter()
        g, loc = augment()
        if timings is not None:
            torch.cuda.synchronize()
            timings["augment_s"] = timings.get("augment_s", 0.0) + (
                time.perf_counter() - t0)
        return trainer.step(state, g, loc, 1e-5, 0.04, 0.996, 0.04, False,
                            gen, timings)

    b = batch.shape[0]
    heads = trainer.backbone.blocks[0].attn.num_heads
    dk = trainer.backbone.embed_dim // heads
    blocks = len(trainer.backbone.blocks)
    profile_step(augment, step,
                 (("globals", 2 * b * heads, 197, dk, blocks),
                  ("locals", trainer.n_local * b * heads, 37, dk, blocks)),
                 dev)


def check_phase_calls(fa, kernels, label, calls, want_shapes) -> float:
    """K5 against its plain version on the inputs a phase's runs gave it
    (`calls`, kept by `dense_calls`), the first call at each shape (each
    shape runs in one dtype): f32 within DENSE_TOL, bf16 (real
    activations) within one ulp of max |plain| (2^-7) as in phase 11, two
    launches bitwise equal, the body against the profiler's kernel names,
    one-call and b2b times beside plain, SDPA and the bound (the bodies
    checked after them, by `check_traced_bodies`). Raises if a shape of
    `want_shapes` never ran; returns the largest error."""
    import torch

    from snuffy_tpu_torch.ops.dense_attention import (
        dense_attention_reference,
        fused_self_attention,
    )

    worst, bodies, cases = 0.0, [], []
    log(f"  K5 against its plain version on the inputs the {label} runs "
        "gave it, the first call at each shape (each shape runs in one "
        "dtype)")
    for shape, (q, k, v, n_valid) in sorted(
            (key, val) for key, val in calls.items() if key != "errors"):
        dtype = str(q.dtype).removeprefix("torch.")
        with torch.inference_mode():
            got = fused_self_attention(q, k, v, n_valid)
            ref = dense_attention_reference(q, k, v, n_valid)
            if dtype == "float32":
                err = check_kernel(f"K5 {dtype} {shape}", got, ref,
                                   DENSE_TOL[dtype])
            else:
                # real activations: one bf16 ulp of max |plain|, 2^-7
                # (phase 11's rule for its launches: DENSE_TOL's 2^-8 is
                # under one ulp where the largest output sits low in its
                # binade); beside it, each side's distance from the exact
                # result (f64, p unrounded)
                err = check_kernel(f"K5 {dtype} {shape}", got, ref,
                                   KERNEL_TOL[dtype])
                scale = float(ref.float().abs().max())
                s_ = torch.bmm(q.double(), k.double().transpose(1, 2))
                s_ = (s_ * q.shape[-1] ** -0.5)[..., :n_valid]
                exact = torch.bmm(torch.softmax(s_, dim=-1),
                                  v.double()[:, :n_valid])
                log(f"      {max_ulps(got, ref):.2f} ulps (max_ulps); "
                    f"within DENSE_TOL's 2^-8: "
                    f"{err / scale <= DENSE_TOL[dtype]}; from the exact "
                    "result: kernel "
                    f"{float((got.double() - exact).abs().max()) / scale:.3e}"
                    ", plain "
                    f"{float((ref.double() - exact).abs().max()) / scale:.3e}"
                    " of max |plain|")
                del s_, exact
            worst = max(worst, err)
            if not torch.equal(fused_self_attention(q, k, v, n_valid), got):
                raise AssertionError("K5: two launches on the same inputs "
                                     "differ")
            bodies.append(fa.kernel_body(q, k, v, got))
        cases.append((q, k, v, n_valid))
        time_dense(f"{label} {shape}", q, k, v, n_valid)
    check_traced_bodies(fa, bodies, cases)
    missing = want_shapes - set(calls)
    if missing:
        raise AssertionError(f"K5 never ran at {sorted(missing)}; it ran at "
                             f"{sorted(k for k in calls if k != 'errors')}")
    return worst


def phase_dino(dev, fa, kernels):
    """13: DINO-adapter pretraining through its CLI (module docstring);
    returns (launches of the main-path runs (a)-(c), K5's largest error
    over (e))."""
    import glob
    import io
    import os
    import shutil
    import tempfile

    import torch

    from snuffy_tpu_torch import compute_feats
    from snuffy_tpu_torch import main_dino_adapter as cli
    from snuffy_tpu_torch.embed.pipeline import decode_batch, embed_tiles
    from snuffy_tpu_torch.embed.registry import build_embedder
    from snuffy_tpu_torch.ssl.data import ImageBatcher, list_image_folder

    log("== phase 13: DINO-adapter pretraining (python -m "
        "snuffy_tpu_torch.main_dino_adapter at its defaults: ViT-S/16 + "
        "adapter 64/4.0, bf16, out_dim 65536, 2x224 + 8x96 crops, batch 64, "
        "AdamW)")
    t_phase = time.perf_counter()
    launches = {k.name: 0 for k in kernels.KERNELS}
    calls = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = write_image_folder(os.path.join(tmp, "imgs"), DINO_IMAGES,
                                  224, 13)
        paths, _ = list_image_folder(data)
        one, threads, spawned, start = decode_ways(paths[:64], 224)
        log(f"  (a) decode of 64 224² JPEGs: one thread {one:.3f} s, 8 "
            f"threads (the batcher) {threads:.3f} s, a spawned pool of 8 "
            f"{spawned:.3f} s after its {start:.3f} s start")
        out = os.path.join(tmp, "out")
        argv = ["--data_path", data, "--valid_data_path", data,
                "--output_dir", out, *DINO_ARGV]
        args = cli.get_args_parser().parse_args(argv)
        start_state = cli.build_trainer(args, torch.device("cpu")
                                        ).init_state(args.seed)
        init = {"student": start_state.student.state_dict(),
                "teacher": start_state.teacher.state_dict()}
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with dense_calls(calls):
            state = cli.main(argv, timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_a = kernels.launch_counts()
        peak_a = torch.cuda.max_memory_allocated()
        with open(os.path.join(out, "log.txt")) as f:
            rows = [json.loads(line) for line in f]
        if len(rows) != 2 or rows[-1]["val_loss"] is None or not all(
                math.isfinite(r["train_loss"]) and math.isfinite(
                    r["val_loss"]) for r in rows):
            raise AssertionError(f"log.txt rows {rows}")
        check_dino_run(init, dino_state_dicts(
            os.path.join(out, "checkpoint0000.pth")),
            dino_state_dicts(os.path.join(out, "checkpoint.pth")))
        steps = timings["steps"]
        depth = len(state.student.backbone.blocks)
        dim = state.student.backbone.embed_dim
        want = depth * 3 * steps
        if state.step != 4 or steps != 4 or run_a[kernels.DENSE.name] < want:
            raise AssertionError(f"steps {state.step}/{steps}, K5 launches "
                                 f"{run_a[kernels.DENSE.name]} < {want}")
        per = {k: v / steps for k, v in timings.items() if k != "steps"}
        log(f"  (a) 2 epochs x 2 steps + validation in {wall:.2f} s; losses "
            f"{[round(r['train_loss'], 6) for r in rows]}, val "
            f"{[round(r['val_loss'], 6) for r in rows]}; a step "
            f"{sum(per.values()):.4f} s: " + ", ".join(
                f"{k} {v:.4f}" for k, v in per.items()) +
            f" (mean of {steps}, the first with its warm-up); peak "
            f"{peak_a / 2**30:.2f} GiB; K5 launches "
            f"{run_a[kernels.DENSE.name]} (≥ {want}: {depth} blocks × (2 "
            "student "
            "+ 1 teacher calls) × steps, plus validation)")
        for k, v in run_a.items():
            launches[k] += v

        # (b) the checkpoint into the extraction CLI, f32
        bag = os.path.join(tmp, "datasets", "dino", "single", "fold1",
                           "train", "1_tumor", "slide_1")
        os.makedirs(bag)
        for i, p in enumerate(paths[:32]):
            shutil.copy(p, os.path.join(bag, f"{i}_{i % 7}.jpeg"))
        ckpt = os.path.join(out, "checkpoint.pth")
        buf = io.StringIO()
        kernels.reset_launches()
        with contextlib.redirect_stdout(buf), dense_calls(calls):
            rows_b = compute_feats.main([
                "--embedder", "DINO", "--backbone", "vit_small",
                "--patch_size", "16", "--use_adapter", "--weights", ckpt,
                "--dataset", "dino", "--datasets_path",
                os.path.join(tmp, "datasets"), "--embeddings_path",
                os.path.join(tmp, "emb"), "--batch_size", "32",
                "--num_workers", "0", "--compute_dtype", "float32"])
        torch.cuda.synchronize()
        run_b = kernels.launch_counts()
        audit = [line for line in buf.getvalue().splitlines()
                 if line.startswith("layer audit")]
        log(f"  (b) compute_feats: {audit}")
        if len(audit) != 1 or " 0 missing/mismatched" not in audit[0]:
            raise AssertionError(f"the checkpoint did not load whole: {audit}")
        (csv_path, _), = rows_b
        with open(csv_path) as f:
            lines = f.read().splitlines()[1:]
        feats = torch.tensor([[float(x) for x in line.split(",")[:dim]]
                              for line in lines])
        emb = build_embedder("DINO", "vit_small", patch_size=16,
                             use_adapter=True, device=dev)
        emb.backbone.load_state_dict(
            {k[len("backbone."):]: v for k, v in
             state.teacher.state_dict().items() if k.startswith("backbone.")})
        tiles = sorted(glob.glob(os.path.join(bag, "*.jpeg")))
        want_f = torch.from_numpy(embed_tiles(emb, decode_batch(tiles, 224),
                                              32))
        err = float((feats - want_f).abs().max())
        if feats.shape != (32, dim) or not err <= 1e-6 * float(
                want_f.abs().max()):
            raise AssertionError(f"extraction CSV vs the teacher: {err}")
        log(f"    32 tiles' CSV features against the trained teacher's "
            f"backbone on the same tiles (f32): max |diff| {err:.3e} (tol "
            "1e-6 of max); K5 launches "
            f"{run_b[kernels.DENSE.name]}")
        for k, v in run_b.items():
            launches[k] += v

        # (c) the recipe's S/8 shapes
        out8 = os.path.join(tmp, "out8")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with dense_calls(calls):
            s8 = cli.main(["--data_path", data, "--output_dir", out8,
                           "--patch_size", "8", "--batch_size_per_gpu", "16",
                           "--epochs", "1", "--max_steps_per_epoch", "2",
                           "--warmup_epochs", "1"])
        torch.cuda.synchronize()
        run_c = kernels.launch_counts()
        if s8.step != 2 or run_c[kernels.DENSE.name] < depth * 3 * 2:
            raise AssertionError(f"S/8: {s8.step} steps, {run_c}")
        log(f"  (c) --patch_size 8 --batch_size_per_gpu 16, 2 steps in "
            f"{time.perf_counter() - t0:.2f} s: peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, K5 "
            f"launches {run_c[kernels.DENSE.name]}")
        for k, v in run_c.items():
            launches[k] += v
        del s8

        # profile one step at the defaults (not counted: a measurement)
        batcher = ImageBatcher(paths, 64, 224, num_workers=8)
        batch = batcher.decode_batch(paths[:64])
        batcher.close()
        trainer = cli.build_trainer(args, dev)
        profile_dino_step(trainer, trainer.init_state(0), batch, dev)
        del trainer, state

        # (d) one f32 step on the card and on the CPU
        phase_dino_gpu_vs_cpu(cli, dev, batch[:4], calls)

    # (e) K5 on this phase's own inputs
    worst = check_phase_calls(fa, kernels, "DINO", calls, DINO_K5_SHAPES)
    log(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return launches, worst


def phase_dino_gpu_vs_cpu(cli, dev, batch, calls):
    """13d: one f32 step (4 images, 2 local crops, adapter dropout and
    drop-path off, the up-projections drawn non-zero) on the card and on
    the CPU from the same weights and crops; K5's inputs kept in
    `calls`."""
    import torch

    from snuffy_tpu_torch.ssl.augment import dino_multicrop_batch

    args = cli.get_args_parser().parse_args(
        ["--compute_dtype", "float32", "--drop_path_rate", "0",
         "--local_crops_number", "2"])
    sides = []
    for device in (torch.device("cpu"), dev):
        trainer = cli.build_trainer(args, device)
        state = trainer.init_state(args.seed)
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for blk in trainer.backbone.blocks:
                blk.adaptmlp.dropout = 0.0
                w = blk.adaptmlp.up_proj.weight
                w.copy_(0.02 * torch.randn(w.shape, generator=gen))
        state.teacher.load_state_dict(state.student.state_dict())
        sides.append((trainer, state))
    g, loc = dino_multicrop_batch(torch.from_numpy(batch),
                                  torch.Generator().manual_seed(4),
                                  n_local=2)
    out = []
    for (trainer, state), device in zip(sides, (torch.device("cpu"), dev)):
        with dense_calls(calls):
            _, loss = trainer.step(state, g.to(device), loc.to(device),
                                   DINO_GPU_CPU_LR, 0.04, 0.996, 0.04, False)
        out.append((float(loss), state.center.cpu(),
                    {k: v.cpu() for k, v in
                     state.student.state_dict().items()}))
    (l_cpu, c_cpu, p_cpu), (l_gpu, c_gpu, p_gpu) = out
    d_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    d_center = float((c_gpu - c_cpu).abs().max() / c_cpu.abs().max())
    worst, share = 0.0, 1.0
    for k, v in p_cpu.items():
        if not v.is_floating_point():
            continue
        d = (p_gpu[k] - v).abs()
        worst = max(worst, float(d.max()))
        share = min(share, float((d <= DINO_GPU_CPU_TOL * (1 + v.abs()))
                                 .float().mean()))
    log(f"  (d) one f32 step, GPU vs CPU: loss {l_gpu:.6f} / {l_cpu:.6f} "
        f"(rel {d_loss:.2e}), centre rel {d_center:.2e} (tol "
        f"{DINO_GPU_CPU_TOL:.0e}); parameters max |diff| {worst:.3e} "
        f"(bound 2·lr {2 * DINO_GPU_CPU_LR:.0e}), least share within 1e-4 "
        f"{share:.4f}")
    if not (d_loss <= DINO_GPU_CPU_TOL and d_center <= DINO_GPU_CPU_TOL
            and worst <= 2 * DINO_GPU_CPU_LR and share >= 0.99):
        raise AssertionError("DINO step: GPU and CPU disagree")


# ---------------------------------------------------------------- phase 14

# Phase 14: the MAE-adapter CLI at its defaults on phase 13's image folder
# (regenerated: DINO_IMAGES 224² JPEGs, two full batches of 64), 2 epochs
# of 2 steps with validation; the warmup cut to 0 epochs so that the two
# epochs train at the recipe's blr.
MAE_ARGV = ("--epochs", "2", "--max_steps_per_epoch", "2",
            "--warmup_epochs", "0")
# (e) GPU vs CPU, one f32 step (as phase 13's (d)): loss relative to its
# size, parameters within Adam's 2·lr and 99 % within 1e-4.
MAE_GPU_CPU_TOL = 1e-4
MAE_GPU_CPU_LR = 1e-4
# (f): K5's (z, n, dk): bf16 at batch 64 (a, b, d), ViT-B's masked encoder
# (12 heads, 49 kept patches + CLS) and the decoder (16 heads of 32), and
# ViT-L's encoder (16 heads); f32 at the extraction batch of 32 tiles (c)
# and (e)'s 4 images
MAE_K5_SHAPES = {(768, 50, 64), (1024, 197, 32), (1024, 50, 64),
                 (384, 197, 64), (48, 50, 64), (64, 197, 32)}


def check_mae_run(start, final, trains):
    """(a)'s checks on the model's state dicts: every frozen tensor bit for
    bit; adapters (encoder and decoder) and the decoder linears moved."""
    import torch

    frozen = [k for k, t in trains.items() if not t]
    moved = [k for k in frozen if not torch.equal(start[k], final[k])]
    if moved or not frozen:
        raise AssertionError(f"frozen tensors moved: {moved[:3]}")
    for group in ("blocks.", "decoder_blocks.", "decoder_embed.",
                  "decoder_pred."):
        keys = [k for k in start if k.startswith(group) and trains[k]]
        if not keys or all(torch.equal(start[k], final[k]) for k in keys):
            raise AssertionError(f"no trainable {group}* tensor moved")
    log(f"    {len(frozen)} frozen tensors bit for bit; the encoder's and "
        "decoder's adapters and the decoder linears moved")


def phase_mae(dev, fa, kernels):
    """14: MAE-adapter pretraining through its CLI (module docstring);
    returns (launches of the main-path runs (a)-(d), K5's largest error
    over (f))."""
    import glob
    import io
    import os
    import shutil
    import tempfile

    import torch

    from snuffy_tpu_torch import compute_feats
    from snuffy_tpu_torch import main_pretrain_adapter as cli
    from snuffy_tpu_torch.embed.pipeline import decode_batch, embed_tiles
    from snuffy_tpu_torch.embed.registry import build_embedder
    from snuffy_tpu_torch.ssl.data import ImageBatcher, list_image_folder
    from snuffy_tpu_torch.ssl.mae_trainer import mae_trainable_mask

    log("== phase 14: MAE-adapter pretraining (python -m "
        "snuffy_tpu_torch.main_pretrain_adapter at its defaults: "
        "mae_vit_base_patch16 + adapters 64/4.0, 224², --mask_ratio 0.75, "
        "batch 64, bf16, device augment, decoder linears trained)")
    t_phase = time.perf_counter()
    launches = {k.name: 0 for k in kernels.KERNELS}
    calls = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = write_image_folder(os.path.join(tmp, "imgs"), DINO_IMAGES,
                                  224, 13)
        paths, _ = list_image_folder(data)
        out = os.path.join(tmp, "out")
        argv = ["--data_path", data, "--valid_data_path", data,
                "--output_dir", out, *MAE_ARGV]
        args = cli.get_args_parser().parse_args(argv)
        start = cli.build_trainer(args, torch.device("cpu")).model
        start = {k: v.clone() for k, v in start.state_dict().items()}
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with dense_calls(calls):
            state = cli.main(argv, timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_a = kernels.launch_counts()
        peak_a = torch.cuda.max_memory_allocated()
        with open(os.path.join(out, "log.txt")) as f:
            rows = [json.loads(line) for line in f]
        if len(rows) != 2 or not all(
                math.isfinite(r["train_loss"]) and math.isfinite(
                    r["val_loss"]) for r in rows):
            raise AssertionError(f"log.txt rows {rows}")
        trains = mae_trainable_mask(state.model, True, True)
        final = {k: v.cpu() for k, v in state.model.state_dict().items()}
        check_mae_run(start, final, trains)
        # from a random init the decoder linears and adapters cut the val
        # loss by ≈ 13 % in two steps on an H100 (0.8797 → 0.7684; the
        # data, draws and weights are seeded): epoch 1's best replaces
        # epoch 0's
        names = sorted(os.listdir(out))
        want_names = ["checkpoint-best-1.pth", "checkpoint.pth", "log.txt"]
        if not rows[1]["val_loss"] < rows[0]["val_loss"] or names != \
                want_names:
            raise AssertionError(f"{out} holds {names}, not {want_names} "
                                 f"(val losses {rows})")
        best = os.path.join(out, "checkpoint-best-1.pth")
        ckpt = torch.load(best, map_location="cpu", weights_only=True)
        if set(ckpt) != {"model", "optimizer", "step", "epoch", "args"}:
            raise AssertionError(f"checkpoint keys {sorted(ckpt)}")
        log(f"    checkpoints: {names} (val loss {rows[0]['val_loss']:.6f} → "
            f"{rows[1]['val_loss']:.6f}: epoch 0's best deleted)")
        steps = timings["steps"]
        blocks = len(state.model.blocks) + len(state.model.decoder_blocks)
        want = blocks * steps
        if state.step != 4 or steps != 4 or run_a[kernels.DENSE.name] < want:
            raise AssertionError(f"steps {state.step}/{steps}, K5 launches "
                                 f"{run_a[kernels.DENSE.name]} < {want}")
        per = {k: v / steps for k, v in timings.items() if k != "steps"}
        log(f"  (a) 2 epochs x 2 steps + validation in {wall:.2f} s; losses "
            f"{[round(r['train_loss'], 6) for r in rows]}, val "
            f"{[round(r['val_loss'], 6) for r in rows]}; a step "
            f"{sum(per.values()):.4f} s: " + ", ".join(
                f"{k} {v:.4f}" for k, v in per.items()) +
            f" (mean of {steps}, the first with its warm-up); peak "
            f"{peak_a / 2**30:.2f} GiB; K5 launches "
            f"{run_a[kernels.DENSE.name]} (≥ {want}: (12 encoder + 8 decoder "
            "blocks) × steps, plus validation)")
        for k, v in run_a.items():
            launches[k] += v

        # (c) the best checkpoint into the extraction CLI, f32
        bag = os.path.join(tmp, "datasets", "mae", "single", "fold1",
                           "train", "1_tumor", "slide_1")
        os.makedirs(bag)
        for i, p in enumerate(paths[:32]):
            shutil.copy(p, os.path.join(bag, f"{i}_{i % 7}.jpeg"))
        buf = io.StringIO()
        kernels.reset_launches()
        with contextlib.redirect_stdout(buf), dense_calls(calls):
            rows_c = compute_feats.main([
                "--embedder", "MAE", "--backbone", "mae_vit_base_patch16",
                "--use_adapter", "--weights", best, "--dataset", "mae",
                "--datasets_path", os.path.join(tmp, "datasets"),
                "--embeddings_path", os.path.join(tmp, "emb"),
                "--batch_size", "32", "--num_workers", "0",
                "--compute_dtype", "float32"])
        torch.cuda.synchronize()
        run_c = kernels.launch_counts()
        audit = [line for line in buf.getvalue().splitlines()
                 if line.startswith("layer audit")]
        log(f"  (c) compute_feats --embedder MAE on {os.path.basename(best)}:"
            f" {audit}")
        encoder = {k: v for k, v in ckpt["model"].items()
                   if not k.startswith(("decoder", "mask_token"))}
        if audit != [f"layer audit: {len(encoder)} matched, 0 "
                     "missing/mismatched, "
                     f"{len(ckpt['model']) - len(encoder)} unused in {best}"]:
            raise AssertionError(f"the encoder did not load whole: {audit}")
        (csv_path, _), = rows_c
        with open(csv_path) as f:
            lines = f.read().splitlines()[1:]
        dim = state.model.embed_dim
        feats = torch.tensor([[float(x) for x in line.split(",")[:dim]]
                              for line in lines])
        emb = build_embedder("MAE", "mae_vit_base_patch16", use_adapter=True,
                             device=dev)
        emb.backbone.load_state_dict(encoder)
        tiles = sorted(glob.glob(os.path.join(bag, "*.jpeg")))
        want_f = torch.from_numpy(embed_tiles(emb, decode_batch(tiles, 224),
                                              32))
        err = float((feats - want_f).abs().max())
        if feats.shape != (32, dim) or not err <= 1e-6 * float(
                want_f.abs().max()):
            raise AssertionError(f"extraction CSV vs the encoder: {err}")
        log(f"    32 tiles' CSV features against the checkpoint's encoder "
            f"on the same tiles (f32): max |diff| {err:.3e} (tol 1e-6 of "
            f"max); K5 launches {run_c[kernels.DENSE.name]}")
        for k, v in run_c.items():
            launches[k] += v
        del emb

        # (b) resume for one epoch, the moments restored
        kernels.reset_launches()
        t0 = time.perf_counter()
        with dense_calls(calls):
            resumed = cli.main(["--data_path", data, "--valid_data_path",
                                data, "--output_dir", out, "--epochs", "3",
                                "--max_steps_per_epoch", "2",
                                "--warmup_epochs", "0"])
        torch.cuda.synchronize()
        run_b = kernels.launch_counts()
        with open(os.path.join(out, "log.txt")) as f:
            epochs = [json.loads(line)["epoch"] for line in f]
        count = int(resumed.opt_state["count"])
        if resumed.step != 6 or count != 6 or epochs != [0, 1, 2]:
            raise AssertionError(f"resume: step {resumed.step}, Adam count "
                                 f"{count}, log epochs {epochs}")
        log(f"  (b) resumed at epoch 2 for 2 steps in "
            f"{time.perf_counter() - t0:.2f} s: step 6, Adam's count 6 (the "
            f"moments restored), log epochs {epochs}; K5 launches "
            f"{run_b[kernels.DENSE.name]}")
        for k, v in run_b.items():
            launches[k] += v
        del state, resumed

        # (d) one step at --img_pack 2, one with ViT-L/16
        for label, extra in (("--img_pack 2", ("--img_pack", "2")),
                             ("mae_vit_large_patch16",
                              ("--model", "mae_vit_large_patch16"))):
            out_d = os.path.join(tmp, "out_" + extra[1])
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            with dense_calls(calls):
                s_d = cli.main(["--data_path", data, "--output_dir", out_d,
                                "--epochs", "1", "--max_steps_per_epoch",
                                "1", "--warmup_epochs", "0", *extra])
            torch.cuda.synchronize()
            run_d = kernels.launch_counts()
            with open(os.path.join(out_d, "log.txt")) as f:
                loss = json.loads(f.readline())["train_loss"]
            depth = len(s_d.model.blocks) + len(s_d.model.decoder_blocks)
            if (s_d.step != 1 or not math.isfinite(loss)
                    or run_d[kernels.DENSE.name] < depth):
                raise AssertionError(f"{label}: {s_d.step} steps, loss "
                                     f"{loss}, {run_d}")
            log(f"  (d) {label}: 1 step in {time.perf_counter() - t0:.2f} s, "
                f"loss {loss:.6f}, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, K5 "
                f"launches {run_d[kernels.DENSE.name]}")
            for k, v in run_d.items():
                launches[k] += v
            del s_d
            shutil.rmtree(out_d)

        # (g) a warm step at the defaults (not counted: a measurement)
        batcher = ImageBatcher(paths, 64, 224, num_workers=8)
        batch = batcher.decode_batch(paths[:64])
        batcher.close()
        trainer = cli.build_trainer(args, dev)
        profile_mae_step(trainer, trainer.init_state(), batch, dev)
        del trainer

        # (e) one f32 step on the card and on the CPU
        phase_mae_gpu_vs_cpu(cli, dev, batch[:4], calls)

    # (f) K5 on this phase's own inputs
    worst = check_phase_calls(fa, kernels, "MAE", calls, MAE_K5_SHAPES)
    log(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return launches, worst


def profile_mae_step(trainer, state, batch, dev):
    """(g): warm MAE steps of the CLI's trainer under `profile_step`, the
    plain attention backward at the encoder's and the decoder's shapes."""
    import torch

    gen = torch.Generator(dev).manual_seed(5)
    imgs = torch.from_numpy(batch).to(dev)
    model = trainer.model
    b = batch.shape[0]
    n_vis = int(model.grid ** 2 * (1 - trainer.mask_ratio)) + 1
    enc, dec = model.blocks[0].attn, model.decoder_blocks[0].attn
    profile_step(
        lambda: trainer.prep(imgs, gen),
        lambda timings: trainer.step(state, imgs, 1e-5, gen,
                                     timings=timings),
        (("encoder", b * enc.num_heads, n_vis,
          model.embed_dim // enc.num_heads, len(model.blocks)),
         ("decoder", b * dec.num_heads, model.grid ** 2 + 1,
          model.decoder_embed.out_features // dec.num_heads,
          len(model.decoder_blocks))),
        dev)


def phase_mae_gpu_vs_cpu(cli, dev, batch, calls):
    """14e: one f32 step (4 images cropped once on the CPU, the adapters'
    dropout off, their up-projections drawn non-zero, the same masking
    noise) on the card and on the CPU from the same weights; K5's inputs
    kept in `calls`."""
    import torch

    from snuffy_tpu_torch.ssl.augment import mae_draws, mae_train_augment

    args = cli.get_args_parser().parse_args(["--compute_dtype", "float32"])
    imgs = mae_train_augment(
        torch.from_numpy(batch), None, 224,
        draws=mae_draws(torch.Generator().manual_seed(3), len(batch),
                        device=torch.device("cpu")))
    noise = torch.rand((len(batch), 196),
                       generator=torch.Generator().manual_seed(4))
    out = []
    for device in (torch.device("cpu"), dev):
        trainer = cli.build_trainer(args, device)
        trainer.augment = False            # the crops above, on both sides
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for blk in [*trainer.model.blocks, *trainer.model.decoder_blocks]:
                blk.adaptmlp.dropout = 0.0
                w = blk.adaptmlp.up_proj.weight
                w.copy_(0.02 * torch.randn(w.shape, generator=gen))
        state = trainer.init_state()
        with dense_calls(calls):
            _, loss = trainer.step(state, imgs.to(device), MAE_GPU_CPU_LR,
                                   noise=noise.to(device))
        out.append((float(loss), {k: v.cpu() for k, v in
                                  state.model.state_dict().items()}))
    (l_cpu, p_cpu), (l_gpu, p_gpu) = out
    d_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst, share = 0.0, 1.0
    for k, v in p_cpu.items():
        d = (p_gpu[k] - v).abs()
        worst = max(worst, float(d.max()))
        share = min(share, float((d <= MAE_GPU_CPU_TOL * (1 + v.abs()))
                                 .float().mean()))
    log(f"  (e) one f32 step, GPU vs CPU: loss {l_gpu:.6f} / {l_cpu:.6f} "
        f"(rel {d_loss:.2e}, tol {MAE_GPU_CPU_TOL:.0e}); parameters max "
        f"|diff| {worst:.3e} (bound 2·lr {2 * MAE_GPU_CPU_LR:.0e}), least "
        f"share within 1e-4 {share:.4f}")
    if not (d_loss <= MAE_GPU_CPU_TOL and worst <= 2 * MAE_GPU_CPU_LR
            and share >= 0.99):
        raise AssertionError("MAE step: GPU and CPU disagree")


# ---------------------------------------------------------------- phase 15

# Phase 15: data parallelism (Slice 7a) through
# snuffy_tpu_torch/tools/multiproc_worker.py, two ranks sharing the one
# card: gloo over CUDA tensors, both on cuda:0 (NCCL refuses two ranks on
# one device); then NCCL in a group of one rank. Each launch kills its
# ranks past MULTI_RANK_TIMEOUT s. The tolerances of (a)-(c) are the
# worker's (LOSS_TOL, CENTER_TOL, GRAD_TOL, PARAM_TOL, PARAM_SHARE: bf16
# at these widths). The gradients each step hands its optimizer carry
# the check of the averaging: Adam's update and MIL's clip do not change
# when a gradient is scaled, so the parameters cannot show a factor of W.
MULTI_RANK_TIMEOUT = 300
# (d): phase 11c's 300-tile bag (its seed) split into 4 bags of 75 tiles,
# two classes, the extraction CLI at ViT-S/8 + adapter in bf16
MULTI_EXTRACT_BAGS = 4


def launch_timing(launch, ranks) -> str:
    """When each rank's group was up, from the launch's start, and each
    scenario's seconds on rank 0."""
    ready = [round(r["ready_at"] - launch.started_at, 1) for r in ranks]
    spent = {k: round(v, 1) for k, v in ranks[0]["scenario_s"].items()}
    return f"ranks up after {ready} s; scenarios (rank 0) {spent} s"


def write_multi_extract_tree(root):
    """Phase 11c's 300 tiles (seed 8) as q90 JPEGs in MULTI_EXTRACT_BAGS
    bags under camelyon16/single/fold1/train/<class>/<bag>."""
    import os

    import numpy as np

    from snuffy_tpu_torch import native

    rng = np.random.default_rng(8)
    bag = [rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
           for n in EXTRACT_BAGS][1]
    per = len(bag) // MULTI_EXTRACT_BAGS
    for b in range(MULTI_EXTRACT_BAGS):
        cls = ("0_normal", "1_tumor")[b % 2]
        bag_dir = os.path.join(root, "camelyon16", "single", "fold1",
                               "train", cls, f"slide_{b}")
        os.makedirs(bag_dir)
        for j, tile in enumerate(bag[b * per:(b + 1) * per]):
            native.write_jpeg(
                os.path.join(bag_dir, f"{j % 20}_{j // 20}.jpeg"), tile,
                quality=90)


def check_multi_step(ranks, label, mpw, smi, lr, steps):
    """(a)-(c): the 2-rank step(s) against one rank, replicas bitwise
    equal; the walls, all-reduce buckets and peak memory logged."""
    r0, r1 = ranks
    if r0[f"{label}_digest"] != r1[f"{label}_digest"]:
        raise AssertionError(f"{label}: the replicas differ after the step")
    grads, tol = r0[f"{label}_grads"], mpw.GRAD_TOL["bfloat16"]
    log(f"  {label}: the gradients each step hands its optimizer (after "
        f"the all-reduce, before any clip), 2 ranks vs 1: "
        f"{[f'{e:.3e}' for e in grads]} of max |g| (tol {tol:.0e})")
    if len(grads) != steps or max(grads) > tol:
        raise AssertionError(f"{label}: 2 ranks' gradients are not 1 "
                             "rank's")
    worst, share = r0[f"{label}_params" if label != "dino"
                      else "dino_student"]
    tol = mpw.PARAM_TOL["bfloat16"]
    log(f"  {label}: parameters after {steps} step(s), 2 ranks vs 1: max "
        f"|diff| {worst:.3e} (bound 2·lr·steps {2 * lr * steps:.0e}), least "
        f"share within {tol:.0e}·(1 + |x|) {share:.5f} (needed "
        f"{mpw.PARAM_SHARE}); replicas bitwise equal")
    if not (worst <= 2 * lr * steps and share >= mpw.PARAM_SHARE):
        raise AssertionError(f"{label}: 2 ranks and 1 disagree")
    two, one = r0[f"{label}_step_s_ranks"], r0[f"{label}_step_s_one"]
    log(f"    step wall, s ({smi}): 2 ranks sharing the card "
        f"{[round(x, 4) for x in two]} (rank 1: "
        f"{[round(x, 4) for x in r1[f'{label}_step_s_ranks']]}), 1 rank "
        f"on the whole batch {[round(x, 4) for x in one]}; the last is "
        "warm")
    log(f"    peak memory, GiB: rank 0 {r0[f'{label}_peak_bytes'] / 2**30:.2f}"
        f" (with the 1-rank reference), rank 1 "
        f"{r1[f'{label}_peak_bytes'] / 2**30:.2f}")
    for r in (r0, r1):
        buckets = r.get(f"{label}_buckets")
        if buckets:
            log(f"    rank {r['rank']} gradient all-reduce (gloo, CUDA "
                "tensors), per bucket: " + ", ".join(
                    f"{b['bytes'] / 2**20:.2f} MiB in {1e3 * b['s']:.2f} ms"
                    for b in buckets))


def phase_multi_rank(dev, kernels, smi):
    """15 (module docstring): returns (the launch counts of (a)-(d) summed
    over both ranks, plus (e)'s rank; each kernel's largest error against
    its plain version on either rank)."""
    import filecmp
    import os
    import tempfile

    import torch

    from snuffy_tpu_torch import compute_feats
    from snuffy_tpu_torch.tools import multiproc_worker as mpw

    log("== phase 15: data parallelism, 2 ranks sharing the card (gloo over "
        "CUDA tensors, cuda:0 each; python -m snuffy_tpu_torch.tools."
        "multiproc_worker): (a) the packed MIL step at bench.py's point, 8 "
        "bags as 4 a rank; (b) DINO at the CLI's defaults, 32 a rank; (c) "
        "MAE likewise; (d) the extraction CLI over 4 bags; (e) NCCL, one "
        f"rank  [{smi}]")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {k.name: 0 for k in kernels.KERNELS}
    errors = {k.name: 0.0 for k in kernels.KERNELS}
    with tempfile.TemporaryDirectory() as root:
        write_multi_extract_tree(os.path.join(root, "datasets"))
        t0 = time.perf_counter()
        first = mpw.Launch("mil,dino,mae,extract", root, world=2,
                           size="full", device="cuda:0", backend="gloo",
                           timeout=MULTI_RANK_TIMEOUT)
        ranks = first.results()
        log(f"  (a)-(d) on 2 ranks: {time.perf_counter() - t0:.1f} s of "
            f"wall, the processes' start included; "
            f"{launch_timing(first, ranks)}")
        r0, r1 = ranks
        if [r["backend"] for r in ranks] != ["gloo", "gloo"] or \
                [r["device"] for r in ranks] != ["cuda:0", "cuda:0"]:
            raise AssertionError(f"ranks: {[r['backend'] for r in ranks]}"
                                 f" on {[r['device'] for r in ranks]}")
        for r in ranks:
            for key in ("mil", "dino", "mae", "extract"):
                for name, n in r[f"{key}_launches"].items():
                    launches[name] += n
                for name, e in r[f"{key}_kernel_errors"].items():
                    errors[name] = max(errors[name], e)
            log(f"  rank {r['rank']} launches: " + ", ".join(
                f"{key} {r[f'{key}_launches']}"
                for key in ("mil", "dino", "mae", "extract")))
            # at least: K1 and K2 a layer of the step; K5 a block of each
            # ViT call of the step (the student's two crop sizes and the
            # teacher's; the MAE encoder and decoder); a block a batch
            least = (("mil", kernels.FWD, 2), ("mil", kernels.BWD, 2),
                     ("dino", kernels.DENSE, 12 * 3),
                     ("mae", kernels.DENSE, 12 + 8),
                     ("extract", kernels.DENSE, 12))
            for key, kernel, n in least:
                if r[f"{key}_launches"][kernel.name] < n:
                    raise AssertionError(
                        f"rank {r['rank']} {key}: {kernel.name} launched "
                        f"{r[f'{key}_launches'][kernel.name]} < {n} times")
        # (a)
        tol = mpw.LOSS_TOL[r0["mil_dtype"]]
        for i, errs in enumerate(r0["mil_errors"]):
            log(f"  (a) MIL step {i} ({('8 real bags', '3 real bags')[i]}): "
                f"losses, bag scores, instance scores vs 1 rank: "
                f"{[f'{e:.3e}' for e in errs]} of max |x| (tol {tol:.0e})")
            if max(errs) > tol:
                raise AssertionError("MIL: 2 ranks and 1 disagree")
        check_multi_step(ranks, "mil", mpw, smi, mpw.MIL_LR, 2)
        if not (r0["mil_rand_finite"] and r0["mil_rand_digest"]
                == r1["mil_rand_digest"]
                and r0["mil_rand_order"] == r1["mil_rand_order"]):
            raise AssertionError("MIL at rho 0.5, rate 0.1: not finite, or "
                                 "the replicas differ")
        log("    rho 0.5, rate 0.1 (rank folded into the seeds): finite, "
            "replicas bitwise equal")
        # (b), (c)
        for label in ("dino", "mae"):
            loss, loss1 = r0[f"{label}_loss"]
            tol = mpw.LOSS_TOL["bfloat16"]
            log(f"  ({'bc'[label == 'mae']}) {label.upper()}: loss 2 ranks "
                f"{loss:.6f}, 1 rank {loss1:.6f} (rel "
                f"{abs(loss - loss1) / abs(loss1):.2e}, tol {tol:.0e})")
            if abs(loss - loss1) > tol * abs(loss1):
                raise AssertionError(f"{label}: 2 ranks and 1 disagree")
            if label == "dino":
                tol = mpw.CENTER_TOL["bfloat16"]
                log(f"    centre rel {r0['dino_center']:.3e} (tol "
                    f"{tol:.0e}); teacher max |diff| "
                    f"{r0['dino_teacher'][0]:.3e}")
                if r0["dino_center"] > tol:
                    raise AssertionError("DINO centre: 2 ranks and 1 differ")
            check_multi_step(ranks, label, mpw, smi, mpw.SSL_LR,
                             mpw.SSL_STEPS)
        # (d) one process on the card against the ranks' files
        one = os.path.join(root, "one")
        os.makedirs(one)
        cwd = os.getcwd()
        os.chdir(one)
        try:
            want = compute_feats.main(mpw.extract_flags("full") + [
                "--datasets_path", os.path.join(root, "datasets"),
                "--dataset", "camelyon16", "--device", "cuda"])
        finally:
            os.chdir(cwd)
        want = [list(w) for w in want]
        got = r0["extract_rows"]["camelyon16"]
        files = sorted(os.path.relpath(os.path.join(d, f), one)
                       for d, _, fs in os.walk(one) for f in fs
                       if f.endswith(".csv"))
        _, bad, missing = filecmp.cmpfiles(
            one, os.path.join(root, "ranks"), files, shallow=False)
        dataset_csv = os.path.join("embeddings", "camelyon16", "DINO",
                                   "camelyon16.csv")
        writers = [r["rank"] for r in ranks
                   if dataset_csv in {os.path.relpath(w, "ranks")
                                      for w in r["extract_writes"]}]
        log(f"  (d) extraction: {len(got)} bags, {len(files)} CSVs, byte "
            f"for byte one process's: {not bad and not missing}; the "
            f"dataset CSV written by rank(s) {writers}; 2-rank wall "
            f"{r0['extract_s']:.2f} s ({smi})")
        if got != want or r1["extract_rows"] != r0["extract_rows"] or bad \
                or missing or writers != [0] or \
                len(got) != MULTI_EXTRACT_BAGS:
            raise AssertionError(f"extraction on 2 ranks: rows equal "
                                 f"{got == want}, differing {bad}, missing "
                                 f"{missing}, dataset CSV by {writers}")
        # (e)
        (nccl,) = mpw.launch("nccl1", root, world=1, size="full",
                             device="cuda:0", backend="nccl",
                             timeout=MULTI_RANK_TIMEOUT)
        log(f"  (e) NCCL, one rank: backend {nccl['backend']}, all-reduce "
            f"{nccl['allreduce']}, a DINO step under the mesh bit for bit "
            f"the step without a group: {nccl['nccl1_bitwise']}")
        if not (nccl["backend"] == "nccl" and nccl["allreduce"]
                == [0.0, 1.0, 2.0, 3.0] and nccl["nccl1_bitwise"]):
            raise AssertionError("NCCL at world size 1")
    log(f"  each rank's K1, K2 and K5 first launches at each shape against "
        f"the plain versions: largest error {errors}")
    log(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return launches, errors


# Phase 16: sequence and tensor parallelism, remat and sharded checkpoints
# (Slice 7b), two ranks of multiproc_worker sharing the card over gloo as
# in phase 15, at bench.py's training point; each rank's K1/K2 first
# launches at the new shapes to KERNEL_TOL (2^-7). The limits below were
# set from the readings of these checks on an NVIDIA H100 80GB HBM3 at
# 700 W (two runs, equal to 4 digits), at 2.5-9× the reading; the
# parameters after one Adam step keep phase 15's bound 2·lr and share
# within PARAM_TOL (Adam moves each element by at most lr, so a tighter
# bound would sit on Adam's own ceiling).
# (a), (b): losses and scores read at most 1.47e-5 of max |x|; the
# gradients before the clip 1.64e-5 (sp) and 1.03e-5 (tp) of max |g|.
MESH_LOSS_TOL = 5e-5
MESH_GRAD_TOL = 1e-4
# (d): the long bag's instance scores read 0 and its bag score 2.47e-7 of
# max |score| apart; its gradients 3.43e-5 of max |g| (MESH_GRAD_TOL).
LONG_TOL = 1e-6
MESH_SCENARIOS = "sp,tp,long,ckpt:save,dino_bn,dino_bn:f32"
# (f): in bf16, the CLI's dtype, the head's BatchNorms divide by small
# batch deviations, which turns the bf16 rounding of 2 ranks against 1
# into a second step's gradient 7.84e-2 of max |g| apart (step 1 2.98e-3;
# without BatchNorms 4.1e-3); in f32 the same two steps read 1.18e-6 and
# 2.62e-5, the student parameters 2.79e-6 apart. Per dtype: the loss
# (relative), the centre (of max |centre|), each step's gradients (of
# max |g|), and (f32) the parameters' largest |diff|; bf16's parameters
# keep phase 15's bound and share.
BN_TOL = {"bfloat16": dict(loss=2e-5, center=2e-3, grads=(1e-2, 2e-1),
                           params=None),
          "float32": dict(loss=1e-6, center=1e-6, grads=(5e-6, 1e-4),
                          params=1e-5)}


def audit_summary(rows):
    """The timed all-reduces of a step, by axis, what they carried and
    shape: → {key: (calls, MiB a call, ms in all)}."""
    out = {}
    for axis, what, shape, numel, nbytes, secs in rows:
        key = (axis, what, tuple(shape))
        n, _, s = out.get(key, (0, 0.0, 0.0))
        out[key] = (n + 1, nbytes / 2**20, s + 1e3 * secs)
    return out


def phase_remat(dev, kernels, smi):
    """16c: one packed step of 8 bags at bench.py's point, ρ=0.5 and
    rate 0.1, with remat and without, from the same weights and
    generators: → K1/K2 launches of the step with remat."""
    import torch

    from snuffy_tpu_torch.tools import multiproc_worker as mpw

    feats, masks, labels = mpw.mil_bags("full", 384, dev)
    got, launches = {}, {}
    for remat in (False, True):
        trainer = mpw.mesh_trainer(mpw.mesh_cfg("full", 0.5, 0.1, remat,
                                                use_mesh=0), dev)
        grads = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with mpw.gradients_before_clip(trainer, grads):
            out = trainer.packed_train_step(
                feats, masks, labels, torch.ones(8, device=dev),
                *mpw.mil_gens(dev, 5))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[remat] = kernels.launch_counts()
        got[remat] = (out, grads, torch.cuda.max_memory_allocated(dev), wall)
        del trainer
    (o0, g0, peak0, s0), (o1, g1, peak1, s1) = got[False], got[True]
    same = (all(torch.equal(a, b) for a, b in zip(o0, o1))
            and all(torch.equal(a, b) for a, b in zip(g0, g1)))
    fwd = kernels.FWD.name
    log(f"  (c) remat, one rank, 8 bags packed: losses, scores and the "
        f"gradients bitwise the step without it: {same}; peak memory "
        f"{peak1 / 2**30:.2f} GiB with remat, {peak0 / 2**30:.2f} GiB "
        f"without; K1 launches {launches[True][fwd]} with remat, "
        f"{launches[False][fwd]} without (the recompute's "
        f"{launches[True][fwd] - launches[False][fwd]}); step wall "
        f"{s1:.3f} s with, {s0:.3f} s without (first steps) ({smi})")
    if not same:
        raise AssertionError("remat: the step differs from the step "
                             "without it")
    if launches[True][fwd] <= launches[False][fwd]:
        raise AssertionError("remat: no K1 launch of a recompute")
    return launches[True]


def check_mesh_step(ranks, kind, mpw, smi):
    """16a/b: the sp or tp step against one rank; → the all-reduces of a
    layer (timed step)."""
    r0, r1 = ranks
    tol = MESH_LOSS_TOL
    errs = r0[f"{kind}_errors"]
    log(f"  ({'ab'[kind == 'tp']}) {kind}=2, mesh (batch, size, sp, sp "
        f"size, tp, tp size) {r0[f'{kind}_mesh']} / {r1[f'{kind}_mesh']}: "
        f"losses, bag scores, instance scores vs 1 rank "
        f"{[f'{e:.3e}' for e in errs]} of max |x| (tol {tol:.0e})")
    if max(errs) > tol:
        raise AssertionError(f"{kind}: 2 ranks and 1 disagree")
    grads, tol = r0[f"{kind}_grads"], MESH_GRAD_TOL
    worst, share = r0[f"{kind}_params"]
    log(f"    gradients before the clip {grads[0]:.3e} of max |g| (tol "
        f"{tol:.0e}); parameters max |diff| {worst:.3e} (bound 2·lr "
        f"{2 * mpw.MIL_LR:.0e}), least share within "
        f"{mpw.PARAM_TOL['bfloat16']:.0e}·(1 + |x|) {share:.5f}")
    if grads[0] > tol or worst > 2 * mpw.MIL_LR or share < mpw.PARAM_SHARE:
        raise AssertionError(f"{kind}: 2 ranks and 1 disagree")
    if r0[f"{kind}_digest"] != r1[f"{kind}_digest"] or \
            r0[f"{kind}_rand_digest"] != r1[f"{kind}_rand_digest"] or \
            not (r0[f"{kind}_rand_finite"] and r1[f"{kind}_rand_finite"]):
        raise AssertionError(f"{kind}: the ranks' whole models differ, or "
                             "rho 0.5 is not finite")
    log("    whole model bitwise equal on both ranks after the step and "
        "after one at rho 0.5, rate 0.1 (finite)")
    log(f"    parameters a rank {r0[f'{kind}_local_params']} of "
        f"{r0[f'{kind}_n_params']}; step wall, s ({smi}): 2 ranks "
        f"{[round(x, 4) for x in r0[f'{kind}_step_s_ranks']]} (first, "
        f"warm with each all-reduce synchronised), 1 rank "
        f"{[round(x, 4) for x in r0[f'{kind}_step_s_one']]} (8 bags "
        f"packed, first); peak memory, GiB: rank 0 "
        f"{r0[f'{kind}_peak_bytes'] / 2**30:.2f}, rank 1 "
        f"{r1[f'{kind}_peak_bytes'] / 2**30:.2f}, 1 rank "
        f"{r0[f'{kind}_peak_bytes_one'] / 2**30:.2f}")
    summary = audit_summary(r0[f"{kind}_audit_timed"])
    log("    the warm step's all-reduces on rank 0 (8 bags, 2 layers; gloo "
        "over CUDA tensors, the device synchronised around each):")
    for (axis, what, shape), (n, mib, ms) in sorted(summary.items()):
        log(f"      over {axis}, {what} {list(shape)}: {n} call(s), "
            f"{mib:.4f} MiB each, {ms:.3f} ms in all")
    return summary


def phase_mesh(dev, kernels, smi):
    """16 (module docstring): → (the launch counts of 16's paths, summed
    over the ranks; each kernel's largest error on either rank)."""
    import os
    import tempfile

    import torch

    from snuffy_tpu_torch.parallel.sharded_train import tp_dim
    from snuffy_tpu_torch.tools import multiproc_worker as mpw

    log("== phase 16: sequence and tensor parallelism, remat, sharded "
        "checkpoints: 2 ranks sharing the card (gloo over CUDA tensors) at "
        "bench.py's point, 8 bags padded to 10240: (a) sp=2, (b) tp=2, "
        "(c) remat on one rank, (d) a 40960-row bag over sp=2, (e) a tp=2 "
        f"checkpoint restored by fresh ranks, (f) DINO use_bn_in_head  "
        f"[{smi}]")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {k.name: 0 for k in kernels.KERNELS}
    errors = {k.name: 0.0 for k in kernels.KERNELS}
    with tempfile.TemporaryDirectory() as root:
        # (e)'s restoring ranks start now, so that their start-up overlaps
        # the first launch; they read the checkpoint once its ranks exited
        restore = mpw.Launch("ckpt:restore", root, world=2, size="full",
                             device="cuda:0", backend="gloo",
                             timeout=2 * MULTI_RANK_TIMEOUT)
        try:
            first = mpw.Launch(MESH_SCENARIOS, root, world=2, size="full",
                               device="cuda:0", backend="gloo",
                               timeout=MULTI_RANK_TIMEOUT)
            ranks = first.results()
            t0 = time.perf_counter()
            mpw.saved_and_exited(root)
            log(f"  (a), (b), (d), (e) save, (f) on 2 ranks: "
                f"{t0 - t_phase:.1f} s of wall from the phase's start; "
                f"{launch_timing(first, ranks)}")
            restored = restore.results()
        finally:
            restore.close()
        log(f"  (e) restore on 2 fresh ranks, started with the first: "
            f"{time.perf_counter() - t0:.1f} s of wall after the savers "
            f"exited; {launch_timing(restore, restored)}")
    r0, r1 = ranks
    for r in ranks:
        for key in ("sp", "tp", "long", "dino_bn", "dino_bn32"):
            for name, n in r[f"{key}_launches"].items():
                launches[name] += n
            for name, e in r[f"{key}_kernel_errors"].items():
                errors[name] = max(errors[name], e)
        log(f"  rank {r['rank']} launches: " + ", ".join(
            f"{key} {r[f'{key}_launches']}" for key in (
                "sp", "tp", "long", "dino_bn", "dino_bn32")))
        for key in ("sp", "tp"):   # K1 and K2: one a layer of each bag
            for kernel in (kernels.FWD, kernels.BWD):
                if r[f"{key}_launches"][kernel.name] < 8 * 2:
                    raise AssertionError(
                        f"rank {r['rank']} {key}: {kernel.name} launched "
                        f"{r[f'{key}_launches'][kernel.name]} < 16 times")
    for kind in ("sp", "tp"):
        check_mesh_step(ranks, kind, mpw, smi)
    launches_c = phase_remat(dev, kernels, smi)
    for name, n in launches_c.items():
        launches[name] += n
    # (d)
    errs, gerr = r0["long_errors"], r0["long_grads"]
    log(f"  (d) one bag of {r0['long_rows']} rows, forward and backward, "
        f"sp=2 vs 1 rank: instance and bag scores {errs[0]:.3e}, "
        f"{errs[1]:.3e} of max |score| (tol {LONG_TOL:.0e}); gradients "
        f"{gerr:.3e} of max |g| (tol {MESH_GRAD_TOL:.0e}); peak memory, GiB: rank 0 "
        f"{r0['long_peak_bytes'] / 2**30:.3f}, rank 1 "
        f"{r1['long_peak_bytes'] / 2**30:.3f}, 1 rank "
        f"{r0['long_peak_bytes_one'] / 2**30:.3f}; wall s: sp "
        f"{r0['long_s_ranks']:.3f}, 1 rank {r0['long_s_one']:.3f} ({smi})")
    if max(errs) > LONG_TOL or gerr > MESH_GRAD_TOL:
        raise AssertionError("the long bag: sp=2 and 1 rank disagree")
    # (e)
    for saved, back in zip(ranks, restored):
        if back["ckpt_restore_shards"] != saved["ckpt_save_shards"] or \
                back["ckpt_tp_rank"] != saved["ckpt_tp_rank"]:
            raise AssertionError(f"checkpoint: rank {saved['rank']}'s "
                                 "shards differ after the restore")
    s0, s1 = (r["ckpt_save_shards"] for r in ranks)
    split = [k for k in s0 if tp_dim(k) is not None]
    own = all(s0[k][0] != s1[k][0] for k in split)
    files = [sorted(os.path.basename(w) for w in r["ckpt_writes"])
             for r in ranks]
    log(f"  (e) tp=2 checkpoint: saved in {r0['ckpt_save_s']:.3f} s, "
        f"restored by 2 fresh ranks in {restored[0]['ckpt_restore_s']:.3f}"
        f" s ({smi}); each rank's {len(s0)} tensors' checksums equal after "
        f"the restore; {len(split)} split tensors, each rank its own block "
        f"({own}); files by rank: {files}")
    if not own or not split:
        raise AssertionError("checkpoint: the ranks do not hold their own "
                             "blocks")
    # (f)
    bound = 2 * mpw.SSL_LR * mpw.SSL_STEPS
    for key, dtype in (("dino_bn", "bfloat16"), ("dino_bn32", "float32")):
        tol = BN_TOL[dtype]
        loss, loss1 = r0[f"{key}_loss"]
        rel_loss = abs(loss - loss1) / abs(loss1)
        grads = r0[f"{key}_grads"]
        worst, share = r0[f"{key}_student"]
        name, where, _ = r0[f"{key}_grad_worst"]
        log(f"  (f) DINO use_bn_in_head, {dtype}, 32 a rank vs 64 on one "
            f"rank: loss {loss:.6f} vs {loss1:.6f}, {rel_loss:.3e} apart "
            f"(tol {tol['loss']:.0e}); gradients "
            f"{[f'{e:.3e}' for e in grads]} of max |g| (tol "
            f"{[f'{t:.0e}' for t in tol['grads']]}; the second's farthest "
            f"tensor {name}); centre {r0[f'{key}_center']:.3e} (tol "
            f"{tol['center']:.0e}); student max |diff| {worst:.3e} (tol "
            f"{tol['params'] or bound:.0e}), share {share:.5f} (the "
            f"pre-BatchNorm biases {r0[f'{key}_noise_biases']:.3e}); "
            f"running statistics and replicas bitwise equal on both ranks:"
            f" {r0[f'{key}_running'] == r1[f'{key}_running']}; step wall s "
            f"{[round(x, 4) for x in r0[f'{key}_step_s_ranks']]} (1 rank "
            f"{[round(x, 4) for x in r0[f'{key}_step_s_one']]}); peak GiB "
            f"{r0[f'{key}_peak_bytes'] / 2**30:.2f}")
        if rel_loss > tol["loss"] or len(grads) != len(tol["grads"]) or \
                any(e > t for e, t in zip(grads, tol["grads"])) or \
                r0[f"{key}_center"] > tol["center"] or \
                worst > (tol["params"] or bound) or \
                share < mpw.PARAM_SHARE or \
                r0[f"{key}_noise_biases"] > bound or \
                r0[f"{key}_running"] != r1[f"{key}_running"] or \
                r0[f"{key}_digest"] != r1[f"{key}_digest"]:
            raise AssertionError(f"DINO use_bn_in_head ({dtype}): 2 ranks "
                                 "and 1 disagree")
    log(f"  each rank's K1, K2 and K5 first launches at each new shape "
        f"against the plain versions: largest error {errors}")
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return launches, errors


def build_kernels(kernels):
    """Build every kernel at once, one nvcc each; print ptxas's lines."""
    with concurrent.futures.ThreadPoolExecutor(len(kernels.KERNELS)) as pool:
        futures = [pool.submit(kernels.load_kernel, k.name)
                   for k in kernels.KERNELS]
        builds = [f.result() for f in futures]
    for kernel, built in zip(kernels.KERNELS, builds):
        log(f"  kernel {kernel.name}: {built.path} built by nvcc in "
            f"{built.build_s:.2f} s (0.00 = already built)")
        for line in ptxas_summary(built.log):
            log(f"    {line}")


def kernel_symbol_name(symbol: str) -> str:
    """A kernel's name and template arguments from its mangled symbol: the
    shortest length-prefixed identifier ending in "_kernel" (the anonymous
    namespace's own name holds digits and letters too, so a longer run can
    pass for one)."""
    import re

    found = []
    for m in re.finditer(r"\d+", symbol):
        digits = m.group()
        for i in range(len(digits)):
            name = symbol[m.end():m.end() + int(digits[i:])]
            if (name.endswith("_kernel")
                    and re.fullmatch(r"[a-z_][a-z0-9_]*", name)):
                found.append((len(name), m.end()))
    if not found:
        return symbol
    size, start = min(found)
    name = symbol[start:start + size]
    args = re.match(r"I(\w*?)E[Ev]", symbol[start + size:])
    return name + (f"[{args.group(1)}]" if args else "")


def ptxas_summary(log_text: str) -> list:
    """One line per entry function of `nvcc -Xptxas -v`'s output: the
    kernel's name and template arguments as they stand in the mangled
    symbol, its registers, stack and spills."""
    import re

    lines, name, frame = [], "?", ""
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = kernel_symbol_name(entry.group(1))
            frame = ""
        elif "bytes spill stores" in line:
            frame = line.strip()
        elif "ptxas info" in line and "Used" in line and "registers" in line:
            used = line.split(":", 1)[1].strip()
            lines.append(f"{name}: {used}; {frame}")
    return lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 2
    from snuffy_tpu_torch.models.snuffy import SnuffyModelConfig
    from snuffy_tpu_torch.ops import fused_attention as fa
    from snuffy_tpu_torch.ops import kernels
    from snuffy_tpu_torch.ops.sparse_attention import (
        packed_inverted_sparse_attention,
        packed_inverted_sparse_attention_bwd,
    )
    from snuffy_tpu_torch.tools.profile_vit_attention import nvidia_smi_line

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 GEMMs in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()

    log("== phase 1: environment")
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    log(f"  nvidia-smi: {smi}")
    build_kernels(kernels)

    # the JSON record's times and bounds: bf16, one bag, no dropout
    fwd_err, fwd_record = phase_kernel(
        fa, packed_inverted_sparse_attention, dev)
    bwd_err, bwd_record = phase_backward(
        fa, packed_inverted_sparse_attention_bwd, dev)
    dense_err, dense_record = phase_dense(fa, dev)
    # early in the run: its step profile needs torch.profiler's device
    # times, which late phases have found empty (phases 11, 12d)
    dino_launches, k5_dino_err = phase_dino(dev, fa, kernels)
    mae_launches, k5_mae_err = phase_mae(dev, fa, kernels)

    cfg = SnuffyModelConfig(
        feats_size=384, num_classes=1, num_heads=4, big_lambda=512,
        random_patch_share=0.5, activation="gelu", depth=2,
        compute_dtype="bfloat16",
    )
    milnet, serve_launches = phase_serve(cfg, dev, kernels)
    slide_launches = phase_slide(cfg, milnet, dev, kernels)
    eval_launches, bags_per_s = phase_eval(cfg, milnet, dev, kernels)
    extract_launches = phase_extract(dev, kernels)
    train_launches = phase_train(cfg, dev, kernels)
    phase_train_gpu_vs_cpu(cfg, dev)
    cli_launches, cli_calls = phase_cli(dev, fa, kernels)
    k1_cli_err, k2_cli_err = phase_cli_kernels(
        fa, packed_inverted_sparse_attention,
        packed_inverted_sparse_attention_bwd, cli_calls, dev)
    del cli_calls
    phase_cli_gpu_vs_cpu(dev)
    k1_dk128_err, k1_dk128_record = phase_k1_dk128(
        fa, packed_inverted_sparse_attention, kernels, dev)
    simclr_launches = phase_simclr_serve(dev, kernels)
    embedders_launches, k5_vitl_err = phase_extract_embedders(dev, kernels)
    phase_vit_grid(dev)
    phase_resnet50(dev)
    roi_launches, k1_roi_err, k5_roi_err = phase_eval_viz(
        fa, packed_inverted_sparse_attention,
        packed_inverted_sparse_attention_bwd, kernels, dev)
    multi_launches, multi_err = phase_multi_rank(dev, kernels, smi)
    mesh_launches, mesh_err = phase_mesh(dev, kernels, smi)

    log(f"  main-path kernel launches: serve {serve_launches}, whole slide "
        f"{slide_launches}, eval {eval_launches}, extraction "
        f"{extract_launches}, train {train_launches}, training CLI "
        f"{cli_launches}, SimCLR serve (slide CLI and requests) "
        f"{simclr_launches}, SimCLR/MAE extraction {embedders_launches}, "
        f"ROI heat maps {roi_launches}, DINO pretraining {dino_launches}, "
        f"MAE pretraining {mae_launches}, 2 ranks (phase 15) "
        f"{multi_launches}, sp/tp/remat/DINO BatchNorm (phase 16) "
        f"{mesh_launches}")
    log(f"  K1 at dk=128, one bag: kernel {k1_dk128_record[0]:.4f} ms "
        f"(device {k1_dk128_record[4]:.4f}), bound {k1_dk128_record[2]:.4f} "
        f"ms ({k1_dk128_record[3]})")
    paths = (serve_launches, slide_launches, eval_launches, extract_launches,
             train_launches, cli_launches, simclr_launches,
             embedders_launches, roi_launches, dino_launches, mae_launches,
             multi_launches, mesh_launches)
    no_library = None  # no one PyTorch call computes the slot sums σᵀv
    records = []
    for kernel, err, (ms, plain_ms, bound, bound_by, library_ms) in (
            (kernels.FWD, max(fwd_err, k1_cli_err, k1_dk128_err,
                              k1_roi_err, multi_err[kernels.FWD.name],
                              mesh_err[kernels.FWD.name]),
             (*fwd_record, no_library)),
            (kernels.BWD, max(bwd_err, k2_cli_err,
                              multi_err[kernels.BWD.name],
                              mesh_err[kernels.BWD.name]),
             (*bwd_record, no_library)),
            (kernels.DENSE, max(dense_err, k5_vitl_err, k5_roi_err,
                                k5_dino_err, k5_mae_err,
                                multi_err[kernels.DENSE.name],
                                mesh_err[kernels.DENSE.name]),
             dense_record)):
        records.append({
            "name": kernel.name,
            "route": "cuda",
            "source": kernel.source,
            "replaces": kernel.replaces,
            "launches": sum(p[kernel.name] for p in paths),
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": library_ms,
        })
    log(smi)
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
