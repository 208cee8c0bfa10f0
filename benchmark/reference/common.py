"""Pieces the plain references share: float32 linear algebra with TF32 off,
and the lower-precision twin that the controls run.

Everything here is plain PyTorch. Nothing imports the program under test:
the references re-derive the models from their published equations and
from the weights the benchmark makes.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LN_EPS = 1e-6           # flax's LayerNorm eps, which the MILNet and ViT use
FP8_MAX = 448.0         # largest finite float8_e4m3fn


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _straight_through(x: torch.Tensor, rounded: torch.Tensor):
    """The rounded value forward, x's gradient backward."""
    return x + (rounded - x).detach()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 under one per-tensor scale (amax to
    the format's largest value), back in float32: what an fp8 product
    reads of its operands."""
    x = x.float()
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return _straight_through(
        x, (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest even), in float32:
    what a TF32 tensor-core product reads of its operands."""
    x = x.float()
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return _straight_through(x, bits.view(torch.float32))


# the control of a configuration: its stated precision's next step down
CONTROLS = {"bfloat16": fp8, "float32": tf32}


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def dense(x, w, b, q=identity):
    """x @ wᵀ + b with both operands read through `q`."""
    return F.linear(q(x), q(w), b)


def layer_norm(x, w, b):
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, LN_EPS)
