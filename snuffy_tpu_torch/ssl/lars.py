"""LARS and the layer-wise learning-rate decay, as functions on tensors.

The port of `snuffy_tpu/ssl/lars.py` (an optax transform there):
  * LARS (reference dino_adapter/utils.py:567-607, the DINO optimizer for
    ConvNet backbones and large batches): SGD momentum on trust-ratio
    scaled updates, decay and trust scaling skipped for 1-D parameters;
  * the layer-wise LR decay of ViT fine-tuning (reference
    mae_adapter/util/lr_decay.py): lr_scale = decay^(n_layers − layer_id).

A parameter's dimension count is the JAX leaf's (`jax_ndim`): a DINO
head's `last_layer.weight_g` is (out, 1) under torch's name and (out,) in
the JAX tree, so it counts as 1-D.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Sequence

import torch

_BLOCK_RE = re.compile(r"blocks?[._/](\d+)")


def jax_ndim(name: str, p: torch.Tensor) -> int:
    """The number of dimensions of the JAX package's leaf for the port's
    parameter `name`."""
    return 1 if name.endswith("last_layer.weight_g") else p.ndim


def lars_direction(g: torch.Tensor, m: torch.Tensor, p: torch.Tensor,
                   ndim: int, momentum: float = 0.9,
                   weight_decay: float = 0.0, eta: float = 0.001,
                   eps: float = 1e-8) -> torch.Tensor:
    """The new momentum buffer, which is also the positive descent
    direction (the caller applies −lr): m·momentum + local_lr·(g + wd·p),
    local_lr = eta·‖p‖/(‖g + wd·p‖ + eps) where both norms are positive
    and the parameter is not 1-D (`ndim` ≤ 1 takes d = g)."""
    if ndim <= 1:
        d = g
    else:
        d = g + weight_decay * p
        p_norm = torch.linalg.vector_norm(p)
        d_norm = torch.linalg.vector_norm(d)
        trust = torch.where((p_norm > 0) & (d_norm > 0),
                            eta * p_norm / (d_norm + eps),
                            torch.ones_like(p_norm))
        d = d * trust
    return momentum * m + d


def vit_layer_id(path_names: Sequence[str], num_layers: int) -> int:
    """MAE lr_decay layer ids: embed/cls/pos → 0, block i → i + 1, the
    rest (norm, head) → num_layers. Takes the JAX path names
    (`blocks_3`) or the parts of a torch name (`blocks.3...` split on
    dots)."""
    joined = "/".join(path_names)
    if any(n in ("cls_token", "pos_embed", "patch_embed") for n in path_names):
        return 0
    m = _BLOCK_RE.search(joined)
    if m:
        return int(m.group(1)) + 1
    return num_layers


def layerwise_lr_decay_mask(names: Iterable[str], num_layers: int,
                            decay: float) -> Dict[str, float]:
    """{name: decay^(num_layers − layer_id)} for torch parameter names."""
    return {name: decay ** (num_layers - vit_layer_id(name.split("."),
                                                      num_layers))
            for name in names}


def scale_by_layerwise_lr(updates: Dict[str, torch.Tensor],
                          factors: Dict[str, float]
                          ) -> Dict[str, torch.Tensor]:
    """Each update times its layer's decayed LR factor."""
    return {k: u * factors[k] for k, u in updates.items()}
