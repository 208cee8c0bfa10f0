"""Fused inverted sparse attention: the hand-written Hopper kernels.

Replaces the TPU kernels of `snuffy_tpu/ops/pallas_attention.py`, with
their `_keep_factor` dropout hash and their segment mode:

  sparse_attention_fwd  `_fwd_kernel` → `csrc/sparse_attention_fwd.cu`
  sparse_attention_bwd  `_bwd_kernel` → `csrc/sparse_attention_bwd.cu`

Each is built for sm_90a and launched through the registry in
`kernels.py`, which counts launches. A `torch.autograd.Function` ties
them together as `jax.custom_vjp` does in the JAX package: the forward
launches the forward kernel and keeps its row statistics (max and
q_valid/sum, 8 bytes a row) for the backward kernel, which runs no
softmax again. The public functions keep the JAX signatures.

For CUDA tensors the wrappers launch the kernels or raise; for CPU
tensors the same Function runs the plain versions in `sparse_attention.py`,
which are the kernels' oracles.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from snuffy_tpu_torch.ops.kernels import BWD, DTYPES, FWD, MAX_DK, launch
from snuffy_tpu_torch.ops.sparse_attention import (
    packed_inverted_sparse_attention,
    packed_inverted_sparse_attention_bwd,
)


def _int32(seed: int) -> int:
    return (int(seed) + 2**31) % 2**32 - 2**31


def _check_cuda_args(q, k, v, slot_valid, q_valid, segments):
    tensors = {"q": q, "k": k, "v": v, "slot_valid": slot_valid,
               "q_valid": q_valid}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q/k/v must share one of {list(DTYPES)}, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if slot_valid.dtype != torch.bool or q_valid.dtype != torch.bool:
        raise TypeError("slot_valid and q_valid must be bool")
    if q.dim() != 3 or k.dim() != 3 or v.shape != q.shape:
        raise ValueError(
            f"want q, v (h, k·N, dk) and k (h, k·S, dk); got q {tuple(q.shape)}"
            f", k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    h, kn, dk = q.shape
    if k.shape[0] != h or k.shape[2] != dk:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if slot_valid.shape != (k.shape[1],) or q_valid.shape != (kn,):
        raise ValueError(
            f"masks {tuple(slot_valid.shape)}, {tuple(q_valid.shape)} do not "
            f"match {k.shape[1]} slots and {kn} rows"
        )
    if segments < 1 or kn % segments or k.shape[1] % segments:
        raise ValueError(
            f"packed rows ({kn}) and slots ({k.shape[1]}) must divide "
            f"segments={segments}"
        )
    if not 1 <= dk <= MAX_DK:
        raise ValueError(f"the kernel takes 1 <= dk <= {MAX_DK}, got {dk}")
    if max(q.numel(), k.numel()) >= 2**31:
        raise ValueError("tensors of 2**31 or more elements are not supported")


def _scalar_args(q, rate, seed):
    """dtype code, 1/√dk, the seed as int32, rate and 1/(1 − rate)."""
    return (DTYPES[q.dtype], 1.0 / math.sqrt(q.shape[2]),
            _int32(0 if seed is None else seed), rate, 1.0 / (1.0 - rate))


def _fwd_cuda(q, k, v, slot_valid, q_valid, segments, rate, seed):
    """Forward kernel → (out, row_max, row_scale)."""
    h, kn, dk = q.shape
    n, s = kn // segments, k.shape[1] // segments
    out = torch.empty((h, k.shape[1], dk), dtype=q.dtype, device=q.device)
    row_max = torch.empty((h * kn,), dtype=torch.float32, device=q.device)
    row_scale = torch.empty_like(row_max)
    launch(FWD, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            slot_valid.data_ptr(), q_valid.data_ptr(), out.data_ptr(),
            row_max.data_ptr(), row_scale.data_ptr(), h, segments, n, s, dk,
            *_scalar_args(q, rate, seed))
    return out, row_max, row_scale


def _bwd_cuda(q, k, v, slot_valid, row_max, row_scale, g, segments, rate,
              seed):
    """Backward kernel → (dq, dk, dv)."""
    h, kn, dk = q.shape
    n, s = kn // segments, k.shape[1] // segments
    dq, dkey, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(row_max)
    launch(BWD, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), slot_valid.data_ptr(), row_max.data_ptr(),
            row_scale.data_ptr(), dq.data_ptr(), dkey.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), h, segments, n, s, dk,
            *_scalar_args(q, rate, seed))
    return dq, dkey, dv


class SparseAttention(torch.autograd.Function):
    """out = σᵀv per segment, with its gradient for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, slot_valid, q_valid, segments, rate, seed):
        ctx.segments, ctx.rate, ctx.seed = segments, rate, seed
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, slot_valid, q_valid)
            return packed_inverted_sparse_attention(
                q, k, v, slot_valid, q_valid, segments,
                dropout_rate=rate, dropout_seed=seed)
        out, row_max, row_scale = _fwd_cuda(q, k, v, slot_valid, q_valid,
                                            segments, rate, seed)
        ctx.save_for_backward(q, k, v, slot_valid, row_max, row_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        segments, rate, seed = ctx.segments, ctx.rate, ctx.seed
        if g.device.type == "cpu":
            q, k, v, slot_valid, q_valid = ctx.saved_tensors
            grads = packed_inverted_sparse_attention_bwd(
                q, k, v, slot_valid, q_valid, g, segments,
                dropout_rate=rate, dropout_seed=seed)
        else:
            q, k, v, slot_valid, row_max, row_scale = ctx.saved_tensors
            if g.dtype != q.dtype or g.shape != k.shape:
                raise TypeError(
                    f"gradient {g.dtype} {tuple(g.shape)} does not match "
                    f"the output {q.dtype} {tuple(k.shape)}")
            # the gradient arriving from wo's matmul may be a transposed view
            grads = _bwd_cuda(q, k, v, slot_valid, row_max, row_scale,
                              g.contiguous(), segments, rate, seed)
        return (*grads, None, None, None, None, None)


def fused_packed_inverted_sparse_attention(
    q: torch.Tensor,           # (h, k·N, dk): k bags packed on the row axis
    k: torch.Tensor,           # (h, k·S, dk)
    v: torch.Tensor,           # (h, k·N, dk)
    slot_valid: torch.Tensor,  # (k·S,) bool
    q_valid: torch.Tensor,     # (k·N,) bool
    segments: int,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Segment-aware fused inverted sparse attention → (h, k·S, dk),
    differentiable in q, k and v."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if q.device.type == "cuda":
        _check_cuda_args(q, k, v, slot_valid, q_valid, segments)
    elif q.device.type != "cpu":
        raise ValueError(f"no sparse attention for device {q.device}")
    return SparseAttention.apply(q, k, v, slot_valid, q_valid, segments,
                                 float(dropout_rate), dropout_seed)


def fused_inverted_sparse_attention(
    q: torch.Tensor,           # (h, N, dk)
    k: torch.Tensor,           # (h, S, dk)
    v: torch.Tensor,           # (h, N, dk)
    slot_valid: torch.Tensor,  # (S,) bool
    q_valid: torch.Tensor,     # (N,) bool
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Fused inverted sparse attention for one bag → (h, S, dk)."""
    return fused_packed_inverted_sparse_attention(
        q, k, v, slot_valid, q_valid, 1,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
    )
