"""Profile one warm serve request of the port on a CUDA GPU.

    python -m snuffy_tpu_torch.tools.profile_serve [--out FILE] [--trace DIR]

Builds ViT-S/16 + MILNet at the serving widths chip_smoke.py uses (d=384,
4 heads, Λ=512, ρ=0.5, depth 2, gelu, bf16; seeded weights), warms a
request of 10000 uint8 224² tiles through `predict_tiles`, then prints:

  * the warm request's embed_s (of it upload_s), classify_s (of it
    milnet_s) and total_s;
  * for one 256-tile embed batch and one classify forward (the padded bag
    of the request): the wall time (median of CUDA-event timings), the
    device-busy time (sum of the kernels' and copies' durations in a
    torch.profiler trace, per iteration), the idle share 1 − busy/wall,
    the FLOP rate from counted FLOPs, and the ops with the most self
    device time;
  * the sparse-attention kernel's passes (row_stats, slot_accumulate and
    split_reduce, the sum of its N splits).

`--out` also writes the full per-op tables to FILE. `--trace` writes a
trace of the warm request under DIR (`traced_request`: a Chrome/Perfetto
`*.pt.trace.json` with the program's `serve.*` spans) and prints the
device kernels `serve.embed` and `serve.classify` hold, and the traced
request's upload_s and upload_stream_s. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys

import torch

from snuffy_tpu_torch.utils.profiling import device_profile, device_trace

TILES = 10000
EMBED_BATCH = 256


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


def traced_request(tiles, embedder, milnet, log_dir, *,
                   embed_batch=EMBED_BATCH):
    """`predict_tiles` on one request of n ≥ 1 tiles under
    `device_trace(log_dir)`: the trace holds the program's own spans
    (`serve.request`, `serve.embed` with one `serve.upload` a batch,
    `serve.classify` with `serve.milnet`). → (the prediction, the trace
    file written)."""
    from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles

    before = set(trace_files(log_dir))
    with device_trace(log_dir):
        pred = predict_tiles(tiles, embedder, milnet, embed_batch=embed_batch)
    written = sorted(set(trace_files(log_dir)) - before)
    if len(written) != 1:
        raise RuntimeError(f"device_trace wrote {len(written)} trace files "
                           f"under {log_dir}")
    return pred, written[0]


def trace_files(log_dir) -> list:
    return glob.glob(os.path.join(log_dir, "*.pt.trace.json"))


def read_trace(path, spans):
    """The `spans` (names of `annotate` ranges) of a trace file and the
    device kernels it recorded: ({span: [(start, end) µs on the host's
    clock]}, [(kernel name, the span it ran in, or None)]). A kernel runs
    in the span its launch was made in: the host-side launch call that
    carries its correlation id; a kernel with no such call is in None."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host = {name: [] for name in spans}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in host:
            host[e["name"]].append((e["ts"], e["ts"] + e.get("dur", 0)))

    def span_at(t):
        for name, rs in host.items():
            if any(a <= t <= b for a, b in rs):
                return name
        return None

    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = []
    for e in events:
        if e.get("cat") != "kernel":
            continue
        at = launched.get(e.get("args", {}).get("correlation"))
        kernels.append((e["name"], None if at is None else span_at(at)))
    return host, kernels


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="write the full per-op tables to this file")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a trace of the warm request under DIR")
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
          f"(upload_s={t['upload_s']:.4f}) classify_s={t['classify_s']:.4f} "
          f"(milnet_s={t['milnet_s']:.4f}) total_s={t['total_s']:.4f}",
          flush=True)
    if args.trace:
        pred, path = traced_request(tiles, embedder, milnet, args.trace)
        _, kernels = read_trace(path, ("serve.embed", "serve.classify"))
        counts = {}
        for _, span in kernels:
            counts[span] = counts.get(span, 0) + 1
        t = pred.timings
        print(f"trace {path}: {os.path.getsize(path) / 2**20:.2f} MiB, "
              f"device kernels by span {counts}; traced request total_s="
              f"{t['total_s']:.4f} upload_s={t['upload_s']:.4f} "
              f"upload_stream_s={t['upload_stream_s']:.4f}", flush=True)

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
