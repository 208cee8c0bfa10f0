"""Time the dense-attention kernel and profile a ViT-S/8 + adapter batch on
a CUDA GPU.

    python -m snuffy_tpu_torch.tools.profile_vit_attention [--out FILE]

The counterpart of the JAX package's TPU probes (tools/profile_vit_attention
{3,4,5}.py, tools/profile_vit8_attention2.py). At their shapes, bf16,

  P1-P3  z=1536 (256 tiles x 6 heads), n=197, dk=64   (ViT-S/16 serve batch)
  P4     z=384 (64 tiles x 6 heads),   n=785, dk=64   (ViT-S/8)
  S/8    z=768 (128 tiles x 6 heads),  n=785, dk=64   (the extraction batch)

it prints the median CUDA-event time of the dense kernel, its plain
version, the port ViT's former attention (bf16 matmul, softmax, bf16
matmul on (b, h, n, dk)) and `scaled_dot_product_attention` (a yardstick:
the port never calls it), beside the bound: the larger of the bytes (q, k,
v read once, out written once) over 3.35 TB/s and the operations over the
989.4 TFLOP/s bf16 tensor-core peak. Then it runs one ViT-S/8 + adapter
forward of 128 uint8 224² tiles (bf16, seeded weights, adapters drawn
non-zero) under torch.profiler: wall time, device busy time, idle share,
FLOP rate and the ops with the most device time, the dense kernel's share
among them. `--out` also writes the full per-op tables. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from snuffy_tpu_torch.tools.profile_serve import (
    report,
    table,
    vit_flops_per_tile,
    wall_ms,
)
from snuffy_tpu_torch.utils.profiling import device_profile

# The H100 SXM's datasheet peaks (NVIDIA) at a 700 W power limit.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989.4e12, torch.float32: 67e12}
SHAPES = {"P1-P3": (1536, 197, 64), "P4": (384, 785, 64),
          "S/8": (768, 785, 64)}
HEADS = 6
EXTRACT_BATCH = 128


def dense_work(z, n, n_valid, dk, dtype):
    """(bytes, FLOPs) of one dense attention call: q, k, v read and out
    written once; q·kᵀ over the n_valid live keys and p·v, multiply-adds
    × 2."""
    return 4 * z * n * dk * dtype.itemsize, 4 * z * n * n_valid * dk


def dense_bound_ms(z, n, n_valid, dk, dtype):
    """(least time on the card in ms, "bytes" or "operations") for one
    dense attention call (`dense_work`) over the dtype's peak."""
    nbytes, flops = dense_work(z, n, n_valid, dk, dtype)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def former_vit_attention(q, k, v, heads=HEADS):
    """The port ViT's attention before the dense kernel, on (z, n, dk)
    viewed as (b, h, n, dk): matmul, softmax, matmul in the input type."""
    z, n, dk = q.shape
    q4, k4, v4 = (t.view(z // heads, heads, n, dk) for t in (q, k, v))
    attn = torch.matmul(q4, k4.transpose(-2, -1)) * (dk ** -0.5)
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return torch.matmul(attn, v4).view(z, n, dk)


def sdpa(q, k, v, n_valid):
    """`scaled_dot_product_attention` over the first n_valid keys, on
    (z, n, dk) viewed as (1, z, n, dk): its fused kernels take 4-D inputs."""
    n = q.shape[1]
    mask = (None if n_valid == n
            else (torch.arange(n, device=q.device) < n_valid)[None])
    return torch.nn.functional.scaled_dot_product_attention(
        q[None], k[None], v[None], attn_mask=mask)[0]


def draw_adapters(vit: torch.nn.Module, seed: int) -> None:
    """Seeded non-zero adapter up-projections: at init they are zeros, and
    the adapter then adds exactly 0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in vit.blocks:
            w = blk.adaptmlp.up_proj.weight
            w.copy_(0.02 * torch.randn(w.shape, generator=gen))


def extraction_embedder(device):
    """ViT-S/8 + adapter (bottleneck 64, scale 4.0), bf16, seeded."""
    from snuffy_tpu_torch.embed.registry import build_embedder

    emb = build_embedder("DINO", "vit_small", patch_size=8, use_adapter=True,
                         adapter_ffn_num=64, adapter_ffn_scalar=4.0,
                         compute_dtype="bfloat16", device=device)
    draw_adapters(emb.backbone, seed=0)
    return emb


def vit8_adapter_flops_per_tile() -> int:
    """ViT-S/8 FLOPs plus the adapters' two GEMMs (4·n·d·64 a block)."""
    n = (224 // 8) ** 2 + 1
    return vit_flops_per_tile(patch=8) + 12 * 4 * n * 384 * 64


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="write the full per-op tables to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_vit_attention: needs a CUDA GPU", file=sys.stderr)
        return 2

    from snuffy_tpu_torch.ops.dense_attention import (
        dense_attention_reference,
        fused_self_attention,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"device {torch.cuda.get_device_name(0)}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}\nnvidia-smi: {nvidia_smi_line()}",
          flush=True)
    lines = []
    gen = torch.Generator(dev).manual_seed(0)
    for label, (z, n, dk) in SHAPES.items():
        q, k, v = (torch.randn((z, n, dk), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        with torch.inference_mode():
            times = {
                "kernel": wall_ms(lambda: fused_self_attention(q, k, v, n)),
                "plain": wall_ms(
                    lambda: dense_attention_reference(q, k, v, n)),
                "former ViT bmm": wall_ms(
                    lambda: former_vit_attention(q, k, v)),
                "sdpa": wall_ms(lambda: sdpa(q, k, v, n)),
            }
        bound, by = dense_bound_ms(z, n, n, dk, torch.bfloat16)
        lines.append(
            f"{label} z={z} n={n} dk={dk} bf16: " + "  ".join(
                f"{name} {ms:.4f} ms" for name, ms in times.items())
            + f"  bound {bound:.4f} ms ({by}); kernel/bound "
            f"{times['kernel'] / bound:.1f}x, kernel/sdpa "
            f"{times['kernel'] / times['sdpa']:.2f}x")
        print(lines[-1], flush=True)
        del q, k, v

    embedder = extraction_embedder(dev)
    tiles = torch.randint(0, 256, (EXTRACT_BATCH, 224, 224, 3),
                          dtype=torch.uint8, device=dev, generator=gen)

    def embed():
        with torch.inference_mode():
            embedder(tiles)

    wall = wall_ms(embed)
    busy, ops, kernels = device_profile(embed)
    lines += report(f"ViT-S/8 + adapter, {EXTRACT_BATCH} tiles, bf16", wall,
                    busy, ops,
                    flops=EXTRACT_BATCH * vit8_adapter_flops_per_tile())
    dense_ms = sum(ms for name, ms in kernels if "dense_attention" in name)
    lines.append(f"dense_attention kernel: {dense_ms:.4f} ms a batch "
                 f"({dense_ms / 12:.4f} ms a layer), "
                 f"{100 * dense_ms / busy:.2f} % of busy; "
                 f"{EXTRACT_BATCH / wall * 1e3:.1f} tiles/s at the wall time")
    print("\n".join(lines[-(len(ops[:10]) + 2):]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines + table("vit8", ops, kernels)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
