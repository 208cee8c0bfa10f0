"""Virchow2 (arXiv:2408.13985): the port's `models/vit.VisionTransformer`
with its register tokens, LayerScale, packed SwiGLU and class-plus-mean
pooling, the plain reference `reference/virchow2.py`, and K5 (dense
attention) at heads of 80 in every block.

`flops_per_tile` counts the products of models/vit.py at these options:
the patch GEMM, then a block of qkv 3d², proj d², fc1 d·h and fc2
(h/2)·d a token (h = int(d · mlp_ratio), fc1's both halves), and q·kᵀ
and p·v 2·n²·d; n = 1 + registers + patches. The SiLU gate, LayerScale and
the norms are elementwise and not counted.
"""

from __future__ import annotations

from benchmark import roofline
from benchmark.reference import virchow2 as reference  # noqa: F401


def tokens(e: dict) -> int:
    return 1 + e["reg_tokens"] + (e["img_size"] // e["patch"]) ** 2


def backbone(e: dict):
    from snuffy_tpu_torch.models.vit import VisionTransformer

    return VisionTransformer(
        patch_size=e["patch"], embed_dim=e["dim"], depth=e["depth"],
        num_heads=e["heads"], mlp_ratio=e["mlp_ratio"],
        img_size=e["img_size"], reg_tokens=e["reg_tokens"],
        init_values=e["init_values"], mlp="swiglu_packed", pool="cls_mean",
        compute_dtype=e["compute_dtype"]), 2 * e["dim"]


def flops_per_tile(e: dict) -> int:
    d, p, h = e["dim"], e["patch"], reference.hidden(e)
    n, n_patch = tokens(e), (e["img_size"] // p) ** 2
    per_block = (2 * n * (3 * d * d + d * d + d * h + (h // 2) * d)
                 + 4 * n * n * d)
    return 2 * n_patch * 3 * p * p * d + e["depth"] * per_block


def kernel_bounds(e: dict, batches) -> dict:
    """K5 on each block of each batch: (batch·heads) sequences of the class
    token, the registers and the patches, at dk = dim / heads (80, not the
    128 the bf16 body pads it to)."""
    return {"dense_attention": sum(
        e["depth"] * roofline.dense_bound(
            b * e["heads"], tokens(e), e["dim"] // e["heads"],
            e["compute_dtype"])
        for b in batches)}
