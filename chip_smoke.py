#!/usr/bin/env python3
"""Smoke run of the PyTorch port (snuffy_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit. It builds the sparse-attention kernel from csrc/ with nvcc, then:

  1. environment: torch/CUDA versions, the nvcc build, the card's name and
     power limit (nvidia-smi);
  2. kernel vs plain: the CUDA kernel against its plain PyTorch version at
     h=4, N=10240 (10000 rows valid), S=512 (some slots dead), dk=96, for
     f32/bf16, segments 1/8 and dropout 0/0.1, with an all-dead segment;
     errors against the stated tolerance, median times by CUDA events;
  3. serve: ViT-S/16 + MILNet (d=384, 4 heads, Λ=512, ρ=0.5, depth 2,
     bf16) from seeded weights answer requests of 10000, 2500 and 300
     uint8 224² tiles; a small request is checked against the same models
     in f32 on the CPU (plain attention path);
  4. packed eval: 30 bags of seeded (10240, 384) embeddings through
     run_eval_epoch (chunks of 8, the tail padded with dummy bags), and
     each bag's score against a one-bag (segments=1) run.

Every phase asserts; any failure exits non-zero. The line before the last
is the kernels' JSON record, the last line the device record. It exits
non-zero at once without a CUDA device.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

# Tolerances (max |kernel − plain| over the output, relative to max |plain|).
# f32: both sum in f32, in different orders, over 10000 rows.
# bf16: both round the same f32 sums to bf16; one-ulp flips are 2^-7.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# Bag/instance scores, f32 model: GPU (kernel) vs CPU (plain), and packed
# (segments=8) vs one bag (segments=1), both f32 GEMMs in other orders.
SCORE_TOL = 1e-4

H, N, N_VALID, S, DK = 4, 10240, 10000, 512, 96
REQUESTS = (10000, 2500, 300)
EVAL_BAGS = 30


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


def phase_kernel(fa, plain, dev):
    import torch

    log("== phase 2: kernel vs plain PyTorch "
        f"(h={H}, N={N} with {N_VALID} valid, S={S}, dk={DK})")
    gen = torch.Generator(dev).manual_seed(1)
    worst = 0.0
    times = {}
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
                if not bool(torch.isfinite(got.float()).all()):
                    raise AssertionError(f"kernel output not finite ({name}, "
                                         f"segments={segments}, rate={rate})")
                err = float((got.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                rel = err / max(scale, 1e-30)
                tol = KERNEL_TOL[name]
                with torch.inference_mode():
                    ms = time_ms(lambda: fa.fused_packed_inverted_sparse_attention(
                        *args, segments, **kw))
                    plain_ms = time_ms(lambda: plain(*args, segments, **kw))
                log(f"  {name:8s} segments={segments} rate={rate}: "
                    f"max_abs_err={err:.3e} max|ref|={scale:.3e} "
                    f"rel={rel:.3e} (tol {tol:.3e})  kernel {ms:.4f} ms  "
                    f"plain {plain_ms:.4f} ms")
                if not rel <= tol:
                    raise AssertionError(
                        f"kernel disagrees with plain: rel {rel} > {tol}")
                worst = max(worst, err)
                times[(name, segments, rate)] = (ms, plain_ms)
    return worst, times


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

    log("== phase 3: serve (ViT-S/16 + MILNet, bf16, seeded weights)")
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
        grew = fa.launches - before
        before = fa.launches
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
    serve_launches = fa.launches

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

    log(f"== phase 4: packed eval ({EVAL_BAGS} bags of ({N}, "
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
    eval_launches = fa.launches
    import numpy as np

    if scores.shape != (EVAL_BAGS, 1) or not np.isfinite(scores).all():
        raise AssertionError(f"eval scores {scores.shape} not finite")
    if not np.isfinite(losses).all() or len(ins) != EVAL_BAGS:
        raise AssertionError("eval losses/instances malformed")
    log(f"  eval: {EVAL_BAGS} bags in {elapsed:.4f} s = "
        f"{EVAL_BAGS / elapsed:.3f} bags/s (bf16, rho={cfg.random_patch_share}"
        f") kernel_launches={eval_launches}")
    if eval_launches < cfg.depth * math.ceil(EVAL_BAGS / 8):
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
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 GEMMs in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()

    log("== phase 1: environment")
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    log(f"  nvidia-smi: {smi}")
    built = fa.load_kernel()
    log(f"  kernel {fa.KERNEL}: {built.path} built by nvcc in "
        f"{built.build_s:.2f} s (0.00 = already built)")
    for line in built.log.splitlines():
        if "ptxas info" in line and ("registers" in line or "spill" in line
                                     or "Compiling" in line):
            log(f"    {line.strip()}")

    worst, times = phase_kernel(fa, packed_inverted_sparse_attention, dev)

    cfg = SnuffyModelConfig(
        feats_size=384, num_classes=1, num_heads=4, big_lambda=512,
        random_patch_share=0.5, activation="gelu", depth=2,
        compute_dtype="bfloat16",
    )
    milnet, serve_launches = phase_serve(cfg, dev, fa)
    eval_launches, bags_per_s = phase_eval(cfg, milnet, dev, fa)

    ms, plain_ms = times[("bfloat16", 1, 0.0)]
    log(f"  main-path kernel launches: serve {serve_launches}, eval "
        f"{eval_launches}")
    log(smi)
    log(json.dumps({"kernels": [{
        "name": fa.KERNEL,
        "route": "cuda",
        "source": fa.SOURCE,
        "replaces": fa.REPLACES,
        "launches": serve_launches + eval_launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
