#!/usr/bin/env python3
"""Smoke run of the PyTorch port (snuffy_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit. It builds the sparse-attention kernels from csrc/ with nvcc (one
nvcc per kernel, all at once), then:

  1. environment: torch/CUDA versions, the nvcc builds, the card's name
     and power limit (nvidia-smi);
  2. forward kernel vs plain: at h=4, N=10240 (10000 rows valid), S=512
     (some slots dead), dk=96, for f32/bf16, segments 1/8 and dropout
     0/0.1, with a dummy bag and an all-dead segment; errors against the
     stated tolerance, median times by CUDA events;
  3. backward kernel vs plain: the same inputs and cases with a seeded
     output gradient; dq, dk and dv errors, median times of the kernel,
     of each of its passes (torch.profiler) and of the plain version;
  4. serve: ViT-S/16 + MILNet (d=384, 4 heads, Λ=512, ρ=0.5, depth 2,
     bf16) from seeded weights answer requests of 10000, 2500 and 300
     uint8 224² tiles; a small request is checked against the same models
     in f32 on the CPU (plain attention path);
  5. packed eval: 30 bags of seeded (10240, 384) embeddings through
     run_eval_epoch (chunks of 8, the tail padded with dummy bags), and
     each bag's score against a one-bag (segments=1) run;
  6. train: the same MILNet with attention dropout 0.1, AdamW (lr 2e-2,
     weight decay 5e-2, soft_average), 8 bags of 10240 rows (10000 valid)
     in serial steps, then 16 bags in packed steps of 8;
  7. GPU vs CPU training: from the same weights, f32, ρ=0, no dropout,
     3 serial steps through the kernels on the card and through the plain
     versions on the CPU.

Each path of the main path (serve, eval, train) runs with the launch
counts set to 0 just before it and read just after. Every phase asserts;
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
import subprocess
import sys
import time

# Tolerances (max |kernel − plain| over an output, relative to max |plain|).
# f32: both sum in f32, in different orders, over 10000 rows (forward,
# dq, dv) or 512 slots (dk), so a few f32 roundings of the largest value.
# bf16: both compute in f32 from the same bf16 inputs and round the result
# to bf16 once; one-ulp flips are 2^-7.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
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


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def launch_counts(fa) -> dict:
    return {k.name: k.launches for k in fa.KERNELS}


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
                log(f"  {name:8s} segments={segments} rate={rate}:")
                err = check_kernel("out", got, ref, KERNEL_TOL[name])
                with torch.inference_mode():
                    ms = time_ms(lambda: fa.fused_packed_inverted_sparse_attention(
                        *args, segments, **kw))
                    plain_ms = time_ms(lambda: plain(*args, segments, **kw))
                log(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
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
                    ms, plain_ms = time_ms(kernel), time_ms(plain)
                    # device ms per call of each pass, from torch.profiler
                    _, _, kernels = device_profile(kernel)
                split = "  ".join(
                    f"{p} {sum(t for key, t in kernels if p in key):.4f} ms"
                    for p in ("row_grad", "slot_grad"))
                log(f"    kernel {ms:.4f} ms ({split})  plain "
                    f"{plain_ms:.4f} ms")
                if (name, segments, rate) == ("bfloat16", 1, 0.0):
                    nbytes = (sum(t.numel() * t.element_size()
                                  for t in (q, k, v, g, sv, row_max,
                                            row_scale))
                              + sum(t.numel() * t.element_size()
                                    for t in got))
                    flops = 10 * H * DK * live_pairs(sv, qv, segments)
                    record = (ms, plain_ms, *bound_ms(nbytes, flops))
    return worst, record


def check_scores(label, got, ref, tol):
    import numpy as np

    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    log(f"  {label}: max |diff| = {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{label}: {err} > {tol}")


def phase_serve(cfg, dev, fa):
    import numpy as np
    import torch

    from snuffy_tpu_torch.embed.registry import build_embedder
    from snuffy_tpu_torch.models.snuffy import build_milnet
    from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles

    log("== phase 4: serve (ViT-S/16 + MILNet, bf16, seeded weights)")
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

    fa.reset_launches()
    before = 0
    for n in REQUESTS:
        batch = tiles(n)
        torch.cuda.synchronize()
        pred = predict_tiles(batch, embedder, milnet)
        t = pred.timings
        grew = fa.FWD.launches - before
        before = fa.FWD.launches
        log(f"  request n_patches={t['n_patches']} embed_s={t['embed_s']:.4f} "
            f"classify_s={t['classify_s']:.4f} total_s={t['total_s']:.4f} "
            f"bag_score={pred.bag_score:.6f} kernel_launches={grew}")
        if t["n_patches"] != n or pred.instance_scores.shape != (n,):
            raise AssertionError("wrong output shape")
        if not (math.isfinite(pred.bag_score) and 0.0 <= pred.bag_score <= 1.0):
            raise AssertionError(f"bag score {pred.bag_score}")
        if not np.isfinite(pred.instance_scores).all():
            raise AssertionError("instance scores not finite")
        if grew < cfg.depth:
            raise AssertionError(f"kernel launched {grew} < depth times")
    serve_launches = launch_counts(fa)

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
                 f_cpu.numpy(), 1e-3)
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


def phase_eval(cfg, milnet, dev, fa):
    import torch

    from snuffy_tpu_torch.models.snuffy import build_milnet
    from snuffy_tpu_torch.train.losses import mixed_mil_loss
    from snuffy_tpu_torch.train.trainer import MILTrainConfig, SnuffyTrainer

    log(f"== phase 5: packed eval ({EVAL_BAGS} bags of ({N}, "
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
    fa.reset_launches()
    t0 = time.perf_counter()
    losses, scores, ins, order = trainer.run_eval_epoch(bucketed, seed=0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    eval_launches = launch_counts(fa)
    import numpy as np

    if scores.shape != (EVAL_BAGS, 1) or not np.isfinite(scores).all():
        raise AssertionError(f"eval scores {scores.shape} not finite")
    if not np.isfinite(losses).all() or len(ins) != EVAL_BAGS:
        raise AssertionError("eval losses/instances malformed")
    log(f"  eval: {EVAL_BAGS} bags in {elapsed:.4f} s = "
        f"{EVAL_BAGS / elapsed:.3f} bags/s (bf16, rho={cfg.random_patch_share}"
        f") kernel_launches={eval_launches}")
    if eval_launches[fa.FWD.name] < cfg.depth * math.ceil(EVAL_BAGS / 8):
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


def train_bags(count, d, gen, dev):
    import torch

    feats = torch.randn((count, N, d), generator=gen, device=dev)
    masks = (torch.arange(N, device=dev) < N_VALID).repeat(count, 1)
    labels = (torch.arange(count, device=dev) % 2).float()[:, None]
    return {N: (feats, masks, labels, list(range(count)))}


def phase_train(cfg, dev, fa):
    import numpy as np
    import torch

    from snuffy_tpu_torch.models.snuffy import build_milnet
    from snuffy_tpu_torch.train.trainer import (
        MILTrainConfig,
        OptimizerConfig,
        SnuffyTrainer,
    )

    log(f"== phase 6: train (MILNet d={cfg.feats_size}, bf16, attention "
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
        fa.reset_launches()
        t0 = time.perf_counter()
        losses, scores, ins, order = trainer.run_train_epoch(
            bucketed, optim.lr, np.random.default_rng(1), 7)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = launch_counts(fa)
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
        for kernel in fa.KERNELS:
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
    log("== phase 7: GPU (kernels) vs CPU (plain) training, f32, rho=0, no "
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


def build_kernels(fa):
    """Build every kernel at once, one nvcc each; print ptxas's lines."""
    with concurrent.futures.ThreadPoolExecutor(len(fa.KERNELS)) as pool:
        futures = [pool.submit(fa.load_kernel, k.name) for k in fa.KERNELS]
        builds = [f.result() for f in futures]
    for kernel, built in zip(fa.KERNELS, builds):
        log(f"  kernel {kernel.name}: {built.path} built by nvcc in "
            f"{built.build_s:.2f} s (0.00 = already built)")
        for line in built.log.splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "spill" in line):
                log(f"    {line.strip()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 2
    from snuffy_tpu_torch.models.snuffy import SnuffyModelConfig
    from snuffy_tpu_torch.ops import fused_attention as fa
    from snuffy_tpu_torch.ops.sparse_attention import (
        packed_inverted_sparse_attention,
        packed_inverted_sparse_attention_bwd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 GEMMs in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()

    log("== phase 1: environment")
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    log(f"  nvidia-smi: {smi}")
    build_kernels(fa)

    # the JSON record's times and bounds: bf16, one bag, no dropout
    fwd_err, fwd_record = phase_kernel(
        fa, packed_inverted_sparse_attention, dev)
    bwd_err, bwd_record = phase_backward(
        fa, packed_inverted_sparse_attention_bwd, dev)

    cfg = SnuffyModelConfig(
        feats_size=384, num_classes=1, num_heads=4, big_lambda=512,
        random_patch_share=0.5, activation="gelu", depth=2,
        compute_dtype="bfloat16",
    )
    milnet, serve_launches = phase_serve(cfg, dev, fa)
    eval_launches, bags_per_s = phase_eval(cfg, milnet, dev, fa)
    train_launches = phase_train(cfg, dev, fa)
    phase_train_gpu_vs_cpu(cfg, dev)

    log(f"  main-path kernel launches: serve {serve_launches}, eval "
        f"{eval_launches}, train {train_launches}")
    paths = (serve_launches, eval_launches, train_launches)
    no_library = None  # no one PyTorch call computes the slot sums σᵀv
    records = []
    for kernel, err, (ms, plain_ms, bound, bound_by) in (
            (fa.FWD, fwd_err, fwd_record), (fa.BWD, bwd_err, bwd_record)):
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
            "library_ms": no_library,
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
