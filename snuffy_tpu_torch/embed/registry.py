"""Embedder registry: backbone + linear instance head, uint8 in.

Port of `snuffy_tpu/embed/registry.py` (the reference registry, reference
compute_feats.py:328-446):
  SimCLR → ResNet-18 with InstanceNorm (or frozen BatchNorm), 512-d,
           global-average pool
  DINO   → ViT-S/B (patch 16 or 8), CLS output, optional parallel adapter
  MAE    → MAE ViT-B/L encoder, masking off, mean-pooled patch tokens
  Virchow2 → ViT-H/14 with 4 registers, LayerScale and packed SwiGLU
           (`vit_huge_patch14_reg4`), the class token and the mean patch
           token concatenated (2560-d), ImageNet-normalised always (its
           published preprocessing)

`Embedder` takes uint8 (or float in [0, 1]) images (B, H, W, 3) on its
device, casts and normalises them there (uint8 payloads are 4× smaller to
upload), and returns (feats (B, D) f32, logits (B, C) f32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from snuffy_tpu_torch.models.mae import (
    mae_vit_base_patch16,
    mae_vit_large_patch16,
)
from snuffy_tpu_torch.models.resnet import ResNet18
from snuffy_tpu_torch.models.vit import (
    vit_base,
    vit_huge_patch14_reg4,
    vit_small,
)
from snuffy_tpu_torch.ops.init import lecun_normal

EMBEDDER_FEAT_DIMS = {
    "resnet18": 512,
    "vit_small": 384,
    "vit_base": 768,
    "mae_vit_base_patch16": 768,
    "mae_vit_large_patch16": 1024,
    "vit_huge_patch14_reg4": 2560,
}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Embedder(nn.Module):
    """Backbone + linear head (the dsmil IClassifier contract)."""

    def __init__(self, backbone: nn.Module, num_feats: int, num_classes: int,
                 imagenet_norm: bool = False, seed: int = 0):
        super().__init__()
        self.backbone = backbone
        self.head = nn.Linear(num_feats, num_classes)
        self.imagenet_norm = imagenet_norm
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        with torch.no_grad():
            lecun_normal(self.head.weight, torch.Generator().manual_seed(seed))
            self.head.bias.zero_()

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        if self.imagenet_norm:
            images = (images - self.mean) / self.std
        feats = self.backbone(images)
        return feats, self.head(feats)


def build_embedder(
    embedder: str = "SimCLR",
    backbone: str = "resnet18",
    num_classes: int = 2,
    patch_size: int = 16,
    use_adapter: bool = False,
    adapter_ffn_num: int = 64,
    adapter_ffn_scalar: float = 4.0,
    norm_layer: str = "instance",
    img_size: int = 224,
    seed: int = 0,
    compute_dtype: str = "float32",
    imagenet_norm: bool = False,
    device: Optional[torch.device] = None,
) -> Embedder:
    """Seeded embedder in eval mode on `device`, the card unless the caller
    passes another (weights are overlaid by a checkpoint load). The JAX
    `build_embedder`'s arguments, in its order, then `imagenet_norm` (the
    JAX `Embedder.jit_apply`'s) and `device`. compute_dtype="bfloat16" runs
    the products in bf16; the embeddings leave in f32. Virchow2 is the
    published model: patch 14, no adapter, ImageNet normalisation on."""
    adapter_kw = dict(use_adapter=use_adapter,
                      adapter_bottleneck=adapter_ffn_num,
                      adapter_scale=adapter_ffn_scalar)
    if embedder.lower() == "simclr" or backbone == "resnet18":
        model = ResNet18(norm=norm_layer, compute_dtype=compute_dtype,
                         seed=seed)
        dim = 512
    elif embedder.upper() == "DINO":
        factory = {"vit_small": vit_small, "vit_base": vit_base}[backbone]
        model = factory(patch_size=patch_size, compute_dtype=compute_dtype,
                        seed=seed, **adapter_kw)
        dim = model.embed_dim
    elif embedder.upper() == "VIRCHOW2":
        factory = {"vit_huge_patch14_reg4": vit_huge_patch14_reg4}[backbone]
        model = factory(img_size=img_size, compute_dtype=compute_dtype,
                        seed=seed)
        dim = model.num_features
        imagenet_norm = True
    elif embedder.upper() == "MAE":
        factory = {
            "mae_vit_base_patch16": mae_vit_base_patch16,
            "mae_vit_large_patch16": mae_vit_large_patch16,
        }[backbone]
        model = factory(img_size=img_size, compute_dtype=compute_dtype,
                        seed=seed, **adapter_kw)
        dim = model.embed_dim
    else:
        raise KeyError(f"Unknown embedder {embedder!r}/{backbone!r}")
    emb = Embedder(model, dim, num_classes, imagenet_norm, seed)
    return emb.to(device or torch.device("cuda")).eval()
