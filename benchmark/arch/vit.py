"""ViT embedders (DINO ViT-S/16 and its kin): the port's
`models/vit.VisionTransformer`, the plain reference `reference/vit.py`,
and K5 (dense attention) in every block.

`flops_per_tile` is frozen from snuffy_tpu_torch/tools/profile_serve.py:46
(models/vit.py: the patch GEMM, qkv 3d², proj d², MLP 2·4d² a token,
q·kᵀ and p·v 2·n²·d a block).
"""

from __future__ import annotations

from benchmark import roofline
from benchmark.reference import vit as reference  # noqa: F401


def backbone(e: dict):
    from snuffy_tpu_torch.models.vit import VisionTransformer

    return VisionTransformer(
        patch_size=e["patch"], embed_dim=e["dim"], depth=e["depth"],
        num_heads=e["heads"], mlp_ratio=e["mlp_ratio"],
        compute_dtype=e["compute_dtype"]), e["dim"]


def flops(dim=384, depth=12, patch=16, size=224, mlp_ratio=4) -> int:
    n_patch = (size // patch) ** 2
    n = n_patch + 1
    per_block = (2 * n * dim * (3 * dim + dim + 2 * mlp_ratio * dim)
                 + 4 * n * n * dim)
    return 2 * n_patch * 3 * patch * patch * dim + depth * per_block


def flops_per_tile(e: dict) -> int:
    return flops(e["dim"], e["depth"], e["patch"], e["img_size"],
                 e["mlp_ratio"])


def kernel_bounds(e: dict, batches) -> dict:
    """K5 on each block of each batch: (batch·heads) sequences of the
    class token and the patches."""
    tokens = 1 + (e["img_size"] // e["patch"]) ** 2
    return {"dense_attention": sum(
        e["depth"] * roofline.dense_bound(
            b * e["heads"], tokens, e["dim"] // e["heads"],
            e["compute_dtype"])
        for b in batches)}
