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
     0/0.1, with a dummy bag and an all-dead segment; errors against the
     stated tolerance, two launches bitwise equal, median times of one
     call by CUDA events, and the device time of a call and of each pass
     (row stats, slot accumulate, reduce of the N splits) by
     torch.profiler, which must find every pass the call launches;
  3. backward kernel vs plain: the same inputs and cases with a seeded
     output gradient; dq, dk and dv errors, no gradient into the dummy bag
     or dead slots, two launches bitwise equal, median times of one call
     of the kernel and of the plain version, and the device time of a
     call and of each pass (row grad, slot grad, reduce of the N splits)
     by torch.profiler;
  4. dense-attention kernel vs plain: f32 and bf16 at the shapes of the
     TPU probes P1-P3 (z=1536, n=197, dk=64: a ViT-S/16 batch of 256) and
     P4 (z=384, n=785, dk=64), at the extraction batch (z=768, n=785), and
     ragged (n_valid < n, dk=32); errors against the stated tolerance,
     median times of one call by CUDA events and the device time of a call
     by torch.profiler, the bound, and scaled_dot_product_attention as the
     library yardstick, timed both ways;
  5. serve: ViT-S/16 + MILNet (d=384, 4 heads, Λ=512, ρ=0.5, depth 2,
     bf16) from seeded weights answer requests of 10000, 2500 and 300
     uint8 224² tiles, 12 dense-attention launches a 256-tile batch; a
     small request is checked against the same models in f32 on the CPU
     (plain attention path);
  6. packed eval: 30 bags of seeded (10240, 384) embeddings through
     run_eval_epoch (chunks of 8, the tail padded with dummy bags), and
     each bag's score against a one-bag (segments=1) run;
  7. extraction: DINO ViT-S/8 + adapter (384-d, depth 12, 6 heads,
     bottleneck 64, scale 4.0, up-projections drawn non-zero), bf16, batch
     128, embeds two bags of 700 and 300 seeded uint8 224² tiles (tails
     padded), writes the per-bag and dataset CSVs to a temporary directory
     and reads them back; tiles/s, 12 dense-attention launches a batch; a
     GPU (kernel) vs CPU (plain) f32 check on two tiles;
  8. train: the same MILNet with attention dropout 0.1, AdamW (lr 2e-2,
     weight decay 5e-2, soft_average), 8 bags of 10240 rows (10000 valid)
     in serial steps, then 16 bags in packed steps of 8;
  9. GPU vs CPU training: from the same weights, f32, ρ=0, no dropout,
     3 serial steps through the kernels on the card and through the plain
     versions on the CPU.

Each path of the main path (serve, eval, extraction, train) runs with the
launch counts set to 0 just before it and read just after. Every phase asserts;
any failure exits non-zero. The line before the last is the kernels' JSON
record, the last line the device record. It exits non-zero at once
without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
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
               ("S/8 extract", 768, 785, 785, 64),
               ("ragged", 96, 300, 280, 32))
# ViT embeddings, f32: GPU (kernel) vs CPU (plain), absolute.
EMBED_TOL = 1e-3
EXTRACT_BAGS, EXTRACT_BATCH = (700, 300), 128
# Bag/instance scores, f32 model: GPU (kernel) vs CPU (plain), and packed
# (segments=8) vs one bag (segments=1), both f32 GEMMs in other orders.
SCORE_TOL = 1e-4

H, N, N_VALID, S, DK = 4, 10240, 10000, 512, 96
REQUESTS = (10000, 2500, 300)
EVAL_BAGS = 30
TRAIN_BAGS, TRAIN_BATCH, PACKED_BAGS = 8, 8, 16
# The H100 SXM's datasheet peaks (NVIDIA), at a 700 W power limit: HBM3
# bytes/s and dense bf16 tensor-core FLOP/s. The bound of a kernel is the
# larger of its bytes and its operations over these.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989.4e12


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


def attention_inputs(dtype, segments, gen, dev):
    import torch

    q = torch.randn((H, segments * N, DK), generator=gen, device=dev)
    k = torch.randn((H, segments * S, DK), generator=gen, device=dev)
    v = torch.randn((H, segments * N, DK), generator=gen, device=dev)
    q_valid = (torch.arange(N, device=dev) < N_VALID).repeat(segments)
    slot_valid = torch.rand(segments * S, generator=gen, device=dev) > 0.1
    if segments > 1:
        # segment 6: a dummy bag (no live rows or slots); segment 7: live
        # rows but every slot dead. Both must stay finite.
        q_valid[6 * N:7 * N] = False
        slot_valid[6 * S:8 * S] = False
    return [t.to(dtype).contiguous() for t in (q, k, v)] + [slot_valid,
                                                           q_valid]


def live_pairs(slot_valid, q_valid, segments) -> int:
    """(row, slot) pairs the attention needs: live rows × live slots of
    each segment."""
    rows = q_valid.reshape(segments, -1).sum(dim=1)
    slots = slot_valid.reshape(segments, -1).sum(dim=1)
    return int((rows * slots).sum())


def bound_ms(nbytes: int, flops: int):
    """(least time on the card in ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS
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

    from snuffy_tpu_torch.tools.profile_serve import device_profile

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
                log(f"  {name:8s} segments={segments} rate={rate}:")
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
                    device, _, passes = device_profile(kernel)
                split = pass_split(fa, fa.FWD, passes, segments)
                log(f"    kernel {ms:.4f} ms (device {device:.4f}: {split})  "
                    f"plain {plain_ms:.4f} ms  (bitwise equal over two "
                    "launches)")
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

    from snuffy_tpu_torch.tools.profile_serve import device_profile

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
                    log(f"  {name:8s} segments={segments} rate={rate}:")
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
                    device, _, passes = device_profile(kernel)
                split = pass_split(fa, fa.BWD, passes, segments)
                log(f"    kernel {ms:.4f} ms (device {device:.4f}: {split})  "
                    f"plain {plain_ms:.4f} ms  (bitwise equal over two "
                    "launches)")
                if (name, segments, rate) == ("bfloat16", 1, 0.0):
                    nbytes = (sum(t.numel() * t.element_size()
                                  for t in (q, k, v, g, sv, row_max,
                                            row_scale))
                              + sum(t.numel() * t.element_size()
                                    for t in got))
                    flops = 10 * H * DK * live_pairs(sv, qv, segments)
                    record = (ms, plain_ms, *bound_ms(nbytes, flops))
    return worst, record


def phase_dense(dev):
    import torch

    from snuffy_tpu_torch.ops.dense_attention import (
        dense_attention_reference,
        fused_self_attention,
    )
    from snuffy_tpu_torch.tools.profile_serve import device_profile
    from snuffy_tpu_torch.tools.profile_vit_attention import (
        dense_bound_ms,
        sdpa,
    )

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
                log(f"  {name:8s} {label} z={z} n={n} n_valid={n_valid} "
                    f"dk={dk}:")
                worst = max(worst, check_kernel("out", got, ref,
                                                DENSE_TOL[name]))

                def kernel():
                    return fused_self_attention(q, k, v, n_valid)

                def library():
                    return sdpa(q, k, v, n_valid)

                ms, lib_ms = time_ms(kernel), time_ms(library)
                plain_ms = time_ms(
                    lambda: dense_attention_reference(q, k, v, n_valid))
                # device ms per call (torch.profiler)
                device, lib_device = (device_profile(f)[0]
                                      for f in (kernel, library))
            bound, by = dense_bound_ms(z, n, n_valid, dk, dtype)
            log(f"    kernel {ms:.4f} ms (device {device:.4f})  plain "
                f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms (device "
                f"{lib_device:.4f})  bound {bound:.4f} ms ({by})")
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
    return extract_launches


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


def ptxas_summary(log_text: str) -> list:
    """One line per entry function of `nvcc -Xptxas -v`'s output: the
    kernel's name and template arguments as they stand in the mangled
    symbol, its registers, stack and spills."""
    import re

    lines, name, frame = [], "?", ""
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"([a-z_]+_kernel)(?:I(\w*?)E[Ev])?",
                          entry.group(1))
            name = (entry.group(1) if m is None
                    else m.group(1) + (f"[{m.group(2)}]" if m.group(2)
                                       else ""))
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
    dense_err, dense_record = phase_dense(dev)

    cfg = SnuffyModelConfig(
        feats_size=384, num_classes=1, num_heads=4, big_lambda=512,
        random_patch_share=0.5, activation="gelu", depth=2,
        compute_dtype="bfloat16",
    )
    milnet, serve_launches = phase_serve(cfg, dev, kernels)
    eval_launches, bags_per_s = phase_eval(cfg, milnet, dev, kernels)
    extract_launches = phase_extract(dev, kernels)
    train_launches = phase_train(cfg, dev, kernels)
    phase_train_gpu_vs_cpu(cfg, dev)

    log(f"  main-path kernel launches: serve {serve_launches}, eval "
        f"{eval_launches}, extraction {extract_launches}, train "
        f"{train_launches}")
    paths = (serve_launches, eval_launches, extract_launches, train_launches)
    no_library = None  # no one PyTorch call computes the slot sums σᵀv
    records = []
    for kernel, err, (ms, plain_ms, bound, bound_by, library_ms) in (
            (kernels.FWD, fwd_err, (*fwd_record, no_library)),
            (kernels.BWD, bwd_err, (*bwd_record, no_library)),
            (kernels.DENSE, dense_err, dense_record)):
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
