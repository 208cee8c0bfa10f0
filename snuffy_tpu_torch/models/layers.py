"""Layer helpers shared by the ViT and MILNet: flax's dtype semantics.

flax's `Dense(dtype=…)` casts its input and its f32 parameters to the
compute dtype; its `LayerNorm(dtype=…)` normalises in f32 and returns the
compute dtype. Its LayerNorm eps is 1e-6, not torch's 1e-5. Its Dropout
keeps x / (1 − rate) with probability 1 − rate and zeroes the rest.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from snuffy_tpu_torch.ops.residual_norm import (
    residual_norm,
    residual_norm_reference,
)

LN_EPS = 1e-6


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """flax Dense(dtype=…): input and f32 parameters cast to `dtype`."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype):
    """flax LayerNorm(dtype=…): normalise in f32, return `dtype`."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def residual_layer_norm(x: torch.Tensor, ln: nn.LayerNorm,
                        dtype: torch.dtype, b: torch.Tensor = None,
                        gamma: torch.Tensor = None):
    """(s, layer_norm(s, ln, dtype)) for s = x + γ ⊙ b (x where b is None),
    in one launch of the residual-norm kernel on the card
    (`ops/residual_norm.py`; the composed ops on the CPU). It records no
    gradient: `composed_residual_layer_norm` does."""
    return residual_norm(x, ln.weight, ln.bias, ln.eps, b, gamma, dtype)


def composed_residual_layer_norm(x: torch.Tensor, ln: nn.LayerNorm,
                                 dtype: torch.dtype, b: torch.Tensor = None,
                                 gamma: torch.Tensor = None):
    """`residual_layer_norm` as the composed PyTorch ops, on every device:
    γ's multiply, the add, then `layer_norm`."""
    return residual_norm_reference(x, ln.weight, ln.bias, ln.eps, b, gamma,
                                   dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator
            ) -> torch.Tensor:
    """Inverted dropout drawn from `generator` (F.dropout takes none): keep
    each element with probability 1 − rate and scale it by 1/(1 − rate).
    The generator lives on x's device."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
