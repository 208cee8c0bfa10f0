"""Layer helpers shared by the ViT and MILNet: flax's dtype semantics.

flax's `Dense(dtype=…)` casts its input and its f32 parameters to the
compute dtype; its `LayerNorm(dtype=…)` normalises in f32 and returns the
compute dtype. Its LayerNorm eps is 1e-6, not torch's 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """flax Dense(dtype=…): input and f32 parameters cast to `dtype`."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype):
    """flax LayerNorm(dtype=…): normalise in f32, return `dtype`."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)
