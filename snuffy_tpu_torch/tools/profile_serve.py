"""Profile one warm serve request of the port on a CUDA GPU.

    python -m snuffy_tpu_torch.tools.profile_serve [--out FILE]

Builds ViT-S/16 + MILNet at the serving widths chip_smoke.py uses (d=384,
4 heads, Λ=512, ρ=0.5, depth 2, gelu, bf16; seeded weights), warms a
request of 10000 uint8 224² tiles through `predict_tiles`, then prints:

  * the warm request's embed_s, classify_s and total_s;
  * for one 256-tile embed batch and one classify forward (the padded bag
    of the request): the wall time (median of CUDA-event timings), the
    device-busy time (sum of the kernels' and copies' durations in a
    torch.profiler trace, per iteration), the idle share 1 − busy/wall,
    the FLOP rate from counted FLOPs, and the ops with the most self
    device time;
  * the sparse-attention kernel's passes (row_stats, slot_accumulate and
    split_reduce, the sum of its N splits).

`--out` also writes the full per-op tables to FILE. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

TILES = 10000
EMBED_BATCH = 256
ITERS = 5


def vit_flops_per_tile(dim=384, depth=12, patch=16, size=224) -> int:
    """Multiply-adds × 2 of one ViT forward: patch GEMM, per block the
    qkv/proj/MLP GEMMs (24·n·d²) and the two attention products (4·n²·d)."""
    n_patch = (size // patch) ** 2
    n = n_patch + 1
    return (2 * n_patch * 3 * patch * patch * dim
            + depth * (24 * n * dim * dim + 4 * n * n * dim))


def attention_flops(heads, rows, slots, dk) -> int:
    """q·kᵀ and pᵀ·v of one sparse-attention call, multiply-adds × 2."""
    return 2 * 2 * heads * rows * slots * dk


def wall_ms(fn, reps=10) -> float:
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


def _self_device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return float(t if t is not None else e.self_cuda_time_total)


def device_profile(fn):
    """(busy ms per call, [(op, self device ms per call, calls)] for host
    ops, [(kernel, ms per call)]) from a torch.profiler trace of ITERS
    calls; busy is the sum of the kernels' and copies' times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    ops, kernels = [], []
    for e in prof.key_averages():
        ms = _self_device_us(e) / 1e3 / ITERS
        if getattr(e, "is_user_annotation", False):
            # a record_function range drawn on the device timeline (the
            # optimizer's step): it spans kernels counted on their own,
            # and the gaps between them
            continue
        if e.device_type == DeviceType.CUDA:
            kernels.append((e.key, ms))
        elif ms > 0:
            ops.append((e.key, ms, e.count / ITERS))
    busy = sum(ms for _, ms in kernels)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time; it cannot "
                           "trace this GPU")
    ops.sort(key=lambda r: -r[1])
    kernels.sort(key=lambda r: -r[1])
    return busy, ops, kernels


def report(label, wall, busy, ops, flops=None, top=10):
    head = (f"{label}: wall {wall:.4f} ms, device busy {busy:.4f} ms, "
            f"idle {100 * (1 - busy / wall):.2f} %")
    if flops is not None:
        head += (f", {flops / 1e9:.3f} GFLOP -> {flops / busy / 1e9:.3f} "
                 "TFLOP/s over busy time")
    lines = [head]
    for name, ms, calls in ops[:top]:
        lines.append(f"    {100 * ms / busy:6.2f} %  {ms:9.4f} ms  "
                     f"x{calls:g}  {name}")
    return lines


def table(label, ops, kernels):
    out = [f"## {label}: host ops by self device time (ms per call)"]
    out += [f"{ms:10.4f}  x{calls:g}  {name}" for name, ms, calls in ops]
    out.append(f"## {label}: device kernels and copies (ms per call)")
    out += [f"{ms:10.4f}  {name}" for name, ms in kernels]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="write the full per-op tables to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: needs a CUDA GPU", file=sys.stderr)
        return 2

    from snuffy_tpu_torch.data.bucketing import bucket_length
    from snuffy_tpu_torch.embed.registry import build_embedder
    from snuffy_tpu_torch.models.snuffy import SnuffyModelConfig, build_milnet
    from snuffy_tpu_torch.ops import fused_attention as fa
    from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles

    dev = torch.device("cuda", 0)
    cfg = SnuffyModelConfig(
        feats_size=384, num_classes=1, num_heads=4, big_lambda=512,
        random_patch_share=0.5, activation="gelu", depth=2,
        compute_dtype="bfloat16",
    )
    embedder = build_embedder("DINO", "vit_small", patch_size=16,
                              compute_dtype="bfloat16", device=dev)
    milnet = build_milnet(cfg, seed=0, device=dev)
    gen = torch.Generator(dev).manual_seed(2)
    tiles = torch.randint(0, 256, (TILES, 224, 224, 3),
                          dtype=torch.uint8, device=dev, generator=gen)

    print(f"device {torch.cuda.get_device_name(0)}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}", flush=True)
    predict_tiles(tiles, embedder, milnet)  # warm-up: allocator, GEMM plans
    t = predict_tiles(tiles, embedder, milnet).timings
    print(f"request n_patches={t['n_patches']} embed_s={t['embed_s']:.4f} "
          f"classify_s={t['classify_s']:.4f} total_s={t['total_s']:.4f}",
          flush=True)

    n_pad = bucket_length(TILES)
    batch = tiles[:EMBED_BATCH]
    bag = torch.randn((n_pad, cfg.feats_size), generator=gen, device=dev)
    mask = torch.arange(n_pad, device=dev) < TILES

    def embed():
        with torch.inference_mode():
            embedder(batch)

    def classify():
        with torch.inference_mode():
            milnet(bag, mask, generator=torch.Generator(dev).manual_seed(0))

    lines, tables = [], []
    wall = wall_ms(embed)
    busy, ops, kernels = device_profile(embed)
    lines += report(f"embed, {EMBED_BATCH} tiles", wall, busy, ops,
                    flops=EMBED_BATCH * vit_flops_per_tile())
    tables += table("embed", ops, kernels)

    wall = wall_ms(classify)
    busy, ops, kernels = device_profile(classify)
    lines += report(f"classify, bag of {n_pad} rows", wall, busy, ops)
    tables += table("classify", ops, kernels)
    kernel_ms = 0.0
    for pass_name in fa.FWD.passes:
        ms = sum(m for name, m in kernels if pass_name in name) / cfg.depth
        kernel_ms += ms
        lines.append(f"{fa.FWD.name} {pass_name}: {ms:.4f} ms per call, "
                     f"{100 * ms * cfg.depth / busy:.2f} % of classify busy")
    flops = attention_flops(cfg.num_heads, n_pad, cfg.big_lambda,
                            cfg.feats_size // cfg.num_heads)
    lines.append(f"{fa.FWD.name}: {kernel_ms:.4f} ms per call, "
                 f"{flops / 1e9:.3f} GFLOP -> "
                 f"{flops / kernel_ms / 1e9:.3f} TFLOP/s")
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines + tables) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
