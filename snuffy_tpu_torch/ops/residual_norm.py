"""A transformer block's residual sum, LayerScale and LayerNorm in one
pass: the hand-written Hopper kernel and its plain version.

`residual_norm(x, weight, bias, eps, b, gamma, dtype)` → (s, y):

    s = x + γ ⊙ b     (x where b is None; γ ⊙ b is b where γ is None)
    y = LayerNorm(s)  statistics in f32, returned in `dtype`

b (…, d), γ (d,) and y are in the compute dtype (f32 or bf16; x's dtype
where `dtype` is None); x and s, the residual stream, in the compute
dtype or in f32 (an adapter's learnable f32 scale promotes a bf16
stream); the norm's weight and bias (d,) are f32. This is the composed
ops the ViT block runs around each norm (`models/vit.Block`: LayerScale's
multiply, the add, then `layers.layer_norm`'s x.float(), F.layer_norm and
.to(dtype)), in one read of x and b and one write of s and y. s is bit for
bit the composed sum, y differs from it only by the order of the f32 sums
(`csrc/residual_norm.cu`). For CUDA tensors the kernel runs or the call
raises; for CPU tensors the plain version runs. The kernel records no
gradient: a CUDA call with grad on and an input that requires one raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from snuffy_tpu_torch.ops.kernels import DTYPES, RESIDUAL_NORM, launch

MAX_D = 8192


def residual_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, eps: float,
                            b: Optional[torch.Tensor] = None,
                            gamma: Optional[torch.Tensor] = None,
                            dtype: Optional[torch.dtype] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The composed ops, step for step: t = b · γ (LayerScale), s = x + t,
    y = F.layer_norm(s.float()) cast to `dtype` (x's where None)."""
    s = x
    if b is not None:
        s = x + (b if gamma is None else b * gamma)
    y = F.layer_norm(s.float(), (s.shape[-1],), weight, bias, eps)
    return s, y.to(x.dtype if dtype is None else dtype)


def _check_args(x, weight, bias, b, gamma, dtype) -> None:
    named = [("x", x), ("weight", weight), ("bias", bias), ("b", b),
             ("gamma", gamma)]
    for name, t in named[1:]:
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no residual norm for device {x.device}")
    if dtype not in DTYPES:
        raise TypeError(f"the compute dtype must be one of {list(DTYPES)}, "
                        f"got {dtype}")
    if x.dtype not in (dtype, torch.float32):
        raise TypeError(f"x must be {dtype} or float32, got {x.dtype}")
    for name, t in (("b", b), ("gamma", gamma)):
        if t is not None and t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, not the compute {dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"the norm's {name} must be float32, got "
                            f"{t.dtype}")
    if gamma is not None and b is None:
        raise ValueError("gamma scales b: give b too")
    if x.dim() < 1 or not 1 <= x.shape[-1] <= MAX_D:
        raise ValueError(f"want x of (..., d) with 1 <= d <= {MAX_D}, got "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    if b is not None and b.shape != x.shape:
        raise ValueError(f"b is {tuple(b.shape)}, x {tuple(x.shape)}")
    for name, t in (("gamma", gamma), ("weight", weight), ("bias", bias)):
        if t is not None and tuple(t.shape) != (d,):
            raise ValueError(f"{name} is {tuple(t.shape)}, want ({d},)")
    for name, t in named:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.numel() // d >= 2**31:
        raise ValueError("2**31 or more rows are not supported")


def _residual_norm_cuda(x, weight, bias, eps, b, gamma, dtype):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, bias, b, gamma)):
        raise RuntimeError("the residual-norm kernel records no gradient: "
                           "call it with grad off")
    y = torch.empty_like(x, dtype=dtype)
    s = x if b is None else torch.empty_like(x)
    if x.numel() == 0:
        return s, y
    d = x.shape[-1]
    launch(RESIDUAL_NORM, x.device, x.data_ptr(),
           None if b is None else b.data_ptr(),
           None if gamma is None else gamma.data_ptr(),
           weight.data_ptr(), bias.data_ptr(),
           None if b is None else s.data_ptr(), y.data_ptr(),
           x.numel() // d, d, DTYPES[x.dtype], DTYPES[dtype], float(eps))
    return s, y


def residual_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float, b: Optional[torch.Tensor] = None,
                  gamma: Optional[torch.Tensor] = None,
                  dtype: Optional[torch.dtype] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, y): s = x + γ ⊙ b in x's dtype and y = LayerNorm(s) with the
    f32 `weight`, `bias` and `eps` in `dtype` (module docstring)."""
    dtype = x.dtype if dtype is None else dtype
    _check_args(x, weight, bias, b, gamma, dtype)
    if x.device.type == "cpu":
        return residual_norm_reference(x, weight, bias, eps, b, gamma, dtype)
    return _residual_norm_cuda(x, weight, bias, eps, b, gamma, dtype)
