"""Seeds and weights made by the benchmark, for the program and the
reference alike.

Every parameter of a model comes from one `torch.randn` of the whole
parameter count on the run's device, drawn from a generator seeded from
`--seed`, then cut into the named tensors and scaled by their kind:
products' weights to unit gain (std 1/√fan_in), biases and tokens to 0.02,
LayerNorm scales to 1 ± 0.1. The names and shapes come from the
reference's `param_spec`; the program loads the same tensors with
`strict=True`, so a layout that differs from the reference's fails there.
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (`tag`) of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make(spec, seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for [(name, shape, kind)]."""
    gen = torch.Generator(device).manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        size = math.prod(shape)
        z = flat[at:at + size].reshape(shape)
        at += size
        if kind == "weight":
            z.mul_(math.prod(shape[1:]) ** -0.5)
        elif kind == "ln_weight":
            z.mul_(0.1).add_(1.0)
        elif kind in ("bias", "token"):
            z.mul_(0.02)
        else:
            raise KeyError(f"{name}: unknown kind {kind!r}")
        out[name] = z
    return out
