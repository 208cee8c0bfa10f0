"""Published-checkpoint registry: the port of the root `hubconf.py` (the
reference's torch.hub entries, reference dino_adapter/hubconf.py:22-151).

Nothing is fetched: an entry reads `<weights_dir>/<name>.pth` and, when
the file is missing, raises `FileNotFoundError` naming the official URL to
download it from. Weights go through `embed.torch_import` onto the port's
models, non-strictly, with the layer audit printed. Models are built in
eval mode on `device`, the card unless the caller passes another.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

DINO_CHECKPOINTS = {
    "dino_vits16": "https://dl.fbaipublicfiles.com/dino/dino_deitsmall16_pretrain/dino_deitsmall16_pretrain.pth",
    "dino_vits8": "https://dl.fbaipublicfiles.com/dino/dino_deitsmall8_pretrain/dino_deitsmall8_pretrain.pth",
    "dino_vitb16": "https://dl.fbaipublicfiles.com/dino/dino_vitbase16_pretrain/dino_vitbase16_pretrain.pth",
    "dino_vitb8": "https://dl.fbaipublicfiles.com/dino/dino_vitbase8_pretrain/dino_vitbase8_pretrain.pth",
    "dino_resnet50": "https://dl.fbaipublicfiles.com/dino/dino_resnet50_pretrain/dino_resnet50_pretrain.pth",
    "dino_xcit_small_12_p16": "https://dl.fbaipublicfiles.com/dino/dino_xcit_small_12_p16_pretrain/dino_xcit_small_12_p16_pretrain.pth",
    "dino_xcit_small_12_p8": "https://dl.fbaipublicfiles.com/dino/dino_xcit_small_12_p8_pretrain/dino_xcit_small_12_p8_pretrain.pth",
    "dino_xcit_medium_24_p16": "https://dl.fbaipublicfiles.com/dino/dino_xcit_medium_24_p16_pretrain/dino_xcit_medium_24_p16_pretrain.pth",
    "dino_xcit_medium_24_p8": "https://dl.fbaipublicfiles.com/dino/dino_xcit_medium_24_p8_pretrain/dino_xcit_medium_24_p8_pretrain.pth",
}

MAE_CHECKPOINTS = {
    "mae_vit_base_patch16": "https://dl.fbaipublicfiles.com/mae/pretrain/mae_pretrain_vit_base.pth",
    "mae_vit_large_patch16": "https://dl.fbaipublicfiles.com/mae/pretrain/mae_pretrain_vit_large.pth",
}

_ARCH = {
    "dino_vits16": ("vit_small", 16),
    "dino_vits8": ("vit_small", 8),
    "dino_vitb16": ("vit_base", 16),
    "dino_vitb8": ("vit_base", 8),
}


def checkpoint_path(name: str, weights_dir: str) -> str:
    """`<weights_dir>/<name>.pth`; raises FileNotFoundError naming the
    official URL when it is missing."""
    path = os.path.join(weights_dir, f"{name}.pth")
    if not os.path.exists(path):
        url = {**DINO_CHECKPOINTS, **MAE_CHECKPOINTS}[name]
        raise FileNotFoundError(f"{path} not found; download it from {url}")
    return path


def load_dino_backbone(name: str, weights_dir: str = "weights",
                       use_adapter: bool = False,
                       device: Optional[torch.device] = None):
    """The port's ViT for a published DINO checkpoint (CLS output), its
    weights read from `<weights_dir>/<name>.pth`."""
    from snuffy_tpu_torch.embed import torch_import as ti
    from snuffy_tpu_torch.models.vit import vit_base, vit_small

    arch, patch = _ARCH[name]
    factory = {"vit_small": vit_small, "vit_base": vit_base}[arch]
    path = checkpoint_path(name, weights_dir)
    model = factory(patch_size=patch, use_adapter=use_adapter)
    sd = ti.load_torch_state_dict(path)
    ti.overlay_checkpoint(model, ti.import_vit(sd), sd, path)
    return model.to(device or torch.device("cuda")).eval()


def load_dino_resnet50(weights_dir: str = "weights",
                       compute_dtype: str = "float32",
                       device: Optional[torch.device] = None):
    """The DINO ResNet-50 backbone, fc removed (reference
    dino_adapter/hubconf.py:84-99): the port's ResNet50 with frozen
    BatchNorm off the published running stats; features are the
    (B, 2048) global-average pool."""
    from snuffy_tpu_torch.embed import torch_import as ti
    from snuffy_tpu_torch.models.resnet import ResNet50

    path = checkpoint_path("dino_resnet50", weights_dir)
    model = ResNet50(norm="batch", compute_dtype=compute_dtype)
    sd = ti.load_torch_state_dict(path)
    ti.overlay_checkpoint(model, ti.import_resnet50(sd), sd, path)
    return model.to(device or torch.device("cuda")).eval()


def load_dino_xcit(name: str, weights_dir: str = "weights",
                   compute_dtype: str = "float32"):
    """DINO XCiT backbones: not available. The root hubconf.py imports
    `snuffy_tpu.models.xcit` and `torch_import.import_xcit`, which were
    never written, so it has no model to port (ROADMAP.md Queue 1)."""
    raise NotImplementedError(
        f"{name}: the XCiT backbones have no implementation to port (the "
        "root hubconf.py's snuffy_tpu.models.xcit was never written; "
        "ROADMAP.md Queue 1)"
    )
