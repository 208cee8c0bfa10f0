"""Weight initializers matching the JAX package's distributions.

Port of `snuffy_tpu/ops/init.py`. Each function fills a torch Linear
weight (out, in) in place from an explicit generator; fan_in is `in` and
fan_out is `out`, as for the JAX (in, out) kernel. The names follow the
reference's `WEIGHT_INITS`, and the distributions are JAX's, not torch's:

  xavier_normal   → glorot_normal: a normal TRUNCATED at ±2σ, σ corrected
                    by 1/0.8796 so the variance stays 1/fan_avg (torch's
                    xavier_normal_ does not truncate)
  xavier_uniform  → glorot_uniform: U(±√(3/fan_avg))
  kaiming_normal  → he_normal: truncated as above, variance 2/fan_in
                    (torch's kaiming_normal_ does not truncate)
  kaiming_uniform → he_uniform: U(±√(6/fan_in))
  trunc_normal    → truncated normal, σ=1, cut at ±2 (no correction)
  orthogonal      → trunc_normal too: the reference's utils.orthogonal_
                    calls trunc_normal_, and the JAX package keeps that quirk.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

# stddev of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def _fans(w: torch.Tensor):
    fan_out, fan_in = w.shape[0], w.shape[1]
    return fan_in, fan_out


def _truncated(w, std, generator):
    with torch.no_grad():
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return w.mul_(std)


def _uniform(w, limit, generator):
    with torch.no_grad():
        return torch.nn.init.uniform_(w, -limit, limit, generator=generator)


def glorot_normal(w, generator=None):
    fan_in, fan_out = _fans(w)
    return _truncated(w, math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD,
                      generator)


def glorot_uniform(w, generator=None):
    fan_in, fan_out = _fans(w)
    return _uniform(w, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def he_normal(w, generator=None):
    fan_in, _ = _fans(w)
    return _truncated(w, math.sqrt(2.0 / fan_in) / _TRUNC_STD, generator)


def he_uniform(w, generator=None):
    fan_in, _ = _fans(w)
    return _uniform(w, math.sqrt(6.0 / fan_in), generator)


def lecun_normal(w, generator=None):
    """flax's default Dense/Conv kernel init (variance 1/fan_in, truncated);
    for a conv weight (out, in, kh, kw) fan_in is in·kh·kw."""
    fan_in = w[0].numel()
    return _truncated(w, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)


def trunc_normal(w, generator=None):
    return _truncated(w, 1.0, generator)


WEIGHT_INITS: Dict[str, Callable] = {
    "xavier_normal": glorot_normal,
    "xavier_uniform": glorot_uniform,
    "kaiming_normal": he_normal,
    "kaiming_uniform": he_uniform,
    "trunc_normal": trunc_normal,
    "orthogonal": trunc_normal,  # reference quirk, see module docstring
}


def get_weight_init(name: str) -> Callable:
    try:
        return WEIGHT_INITS[name]
    except KeyError:
        raise KeyError(
            f"Weight init not found. Given: {name}, Have: {list(WEIGHT_INITS)}"
        )


def init_linear(layer: torch.nn.Linear, name: str,
                generator: Optional[torch.Generator] = None) -> None:
    """weight ← WEIGHT_INITS[name], bias ← 0 (reference utils.py:69-130)."""
    get_weight_init(name)(layer.weight, generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()
