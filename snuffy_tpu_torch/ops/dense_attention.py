"""Dense masked self-attention: the hand-written Hopper kernel and its
plain version.

Replaces the TPU kernel `snuffy_tpu/ops/experimental/dense_attention.py`
(`_kernel`, launched by `_kernel_call`) and the TPU probes of the same
function in `tools/profile_vit_attention{3,4,5}.py` and
`tools/profile_vit8_attention2.py`, by `csrc/dense_attention.cu`. The
port's ViT runs its attention through it.

`fused_self_attention(q, k, v, n_valid)` keeps the JAX signature: q, k, v
(z, n, dk) with heads folded into z → (z, n, dk), every query row
computed, the softmax over the first `n_valid` key columns. For CUDA
tensors its forward launches the kernel or raises; for CPU tensors it runs
`dense_attention_reference`. The backward differentiates the plain version
(one recompute), as the JAX `custom_vjp` does: the TPU kernel has no
backward kernel.

The kernel has three bodies, picked per call by the rule of
`kernels.kernel_body` (q, k, v and out are the tensors whose bases count):
  f32, dk ≤ 128, dk % 4 == 0    tensor cores, one pass (online softmax),
                                every product as 3xTF32
  bf16, dk ≤ 128, dk % 8 == 0   tensor cores (wgmma, TMA), two sweeps
  anything else (dk > 128, dk % 4 ≠ 0, an unaligned base)   CUDA cores

`n_valid = 0` raises. The JAX kernel pads n to 128 and its softmax then
averages over the padded zeros too, while its einsum reference averages
over n: the two disagree there, and the port follows neither.
"""

from __future__ import annotations

import torch

from snuffy_tpu_torch.ops.kernels import DENSE, DTYPES, MAX_DK, launch


def dense_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, n_valid: int) -> torch.Tensor:
    """`_einsum_reference` step for step: scores in f32, columns at or past
    `n_valid` set to −1e30 (never −inf), softmax in f32, p cast to q.dtype,
    p·v in f32, the output cast to q.dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * scale
    col = torch.arange(s.shape[-1], device=s.device)
    s = s.masked_fill(col >= n_valid, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.bmm(p.float(), v.float()).to(q.dtype)


def _check_args(q, k, v, n_valid) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no dense attention for device {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(DTYPES)}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"want q, k, v of one shape (z, n, dk); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    z, n, dk = q.shape
    if not 1 <= dk <= MAX_DK:
        raise ValueError(f"the kernel takes 1 <= dk <= {MAX_DK}, got {dk}")
    if not 1 <= n_valid <= n:
        raise ValueError(f"want 1 <= n_valid <= n = {n}, got {n_valid}")
    if q.numel() >= 2**31:
        raise ValueError("tensors of 2**31 or more elements are not supported")


def _dense_cuda(q, k, v, n_valid: int) -> torch.Tensor:
    z, n, dk = q.shape
    out = torch.empty_like(q)
    launch(DENSE, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), z, n, n_valid, dk, DTYPES[q.dtype], dk ** -0.5)
    return out


class DenseAttention(torch.autograd.Function):
    """softmax(q·kᵀ/√dk over n_valid keys)·v, its gradient through the
    plain version."""

    @staticmethod
    def forward(ctx, q, k, v, n_valid):
        ctx.n_valid = n_valid
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return dense_attention_reference(q, k, v, n_valid)
        return _dense_cuda(q, k, v, n_valid)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = dense_attention_reference(*leaves, ctx.n_valid)
        return (*torch.autograd.grad(out, leaves, g), None)


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_valid: int) -> torch.Tensor:
    """softmax(q·kᵀ/√dk)·v over the first `n_valid` key columns: (z, n, dk)
    → (z, n, dk), differentiable in q, k and v."""
    _check_args(q, k, v, n_valid)
    return DenseAttention.apply(q, k, v, int(n_valid))
