"""Embedder registry: backbone + linear instance head, uint8 in.

Port of `snuffy_tpu/embed/registry.py` for the DINO ViTs. `Embedder`
takes uint8 (or float in [0, 1]) images (B, H, W, 3) on its device, casts
and normalises them there (uint8 payloads are 4× smaller to upload), and
returns (feats (B, D) f32, logits (B, C) f32). SimCLR/ResNet18 and MAE are
not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from snuffy_tpu_torch.models.vit import vit_base, vit_small
from snuffy_tpu_torch.ops.init import lecun_normal

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
    embedder: str = "DINO",
    backbone: str = "vit_small",
    num_classes: int = 2,
    patch_size: int = 16,
    compute_dtype: str = "float32",
    imagenet_norm: bool = False,
    seed: int = 0,
    device: Optional[torch.device] = None,
) -> Embedder:
    """Seeded embedder in eval mode on `device`, the card unless the caller
    passes another (weights are overlaid by a checkpoint load)."""
    if embedder.upper() == "SIMCLR" or backbone == "resnet18":
        raise NotImplementedError(
            "SimCLR/ResNet18 is not ported yet (ROADMAP.md Queue 1, slice 3)"
        )
    if embedder.upper() == "MAE":
        raise NotImplementedError(
            "MAE is not ported yet (ROADMAP.md Queue 1, slice 3)"
        )
    if embedder.upper() != "DINO":
        raise KeyError(f"Unknown embedder {embedder!r}/{backbone!r}")
    factories = {"vit_small": vit_small, "vit_base": vit_base}
    if backbone not in factories:
        raise KeyError(f"Unknown DINO backbone {backbone!r}; have "
                       f"{list(factories)}")
    model = factories[backbone](patch_size=patch_size,
                                compute_dtype=compute_dtype, seed=seed)
    emb = Embedder(model, model.embed_dim, num_classes, imagenet_norm, seed)
    return emb.to(device or torch.device("cuda")).eval()
