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

Each kernel has three bodies, picked per call by the same rule in both
files (`kernel_body` says which):
  f32, dk ≤ 128, dk % 4 == 0    tensor cores, every product as 3xTF32
                                (big + small tf32 parts, three mma.sync)
  bf16, dk ≤ 128, dk % 8 == 0   tensor cores, bf16 products, p, p̃ and ds
                                as hi + lo bf16 parts
  anything else (musk1's dk=83, dk > 128)    CUDA cores, f32 FMAs
The tensor-core bodies also need 16-byte aligned bases (every tensor of a
call: q, k, v and, backward, g and the outputs), which fresh and
contiguous tensors have; otherwise the CUDA-core body runs.

For CUDA tensors the wrappers launch the kernels or raise; for CPU
tensors the same Function runs the plain versions in `sparse_attention.py`,
which are the kernels' oracles.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# BODIES and kernel_body live in the registry (the dense kernel shares the
# rule); callers of this module name them from here too
from snuffy_tpu_torch.ops.kernels import (  # noqa: F401
    BODIES,
    BWD,
    DTYPES,
    FWD,
    MAX_DK,
    kernel_body,
    launch,
)
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


# The slot passes of both kernels (the forward's slot accumulate, the
# backward's slot grad) have the grid (⌈S/64⌉, h·segments, splits): N is
# split until the grid has at least this many blocks, about two waves of
# 132 SMs (8 splits at one bag of S=512, h=4; 1 at 8 bags).
SLOT_MIN_BLOCKS = 256


def slot_splits(n: int, s: int, folded_heads: int) -> int:
    """Splits of the N rows for the kernels' slot passes: the fewest that
    give SLOT_MIN_BLOCKS blocks, and no more than N's 64-row tiles."""
    blocks = math.ceil(s / 64) * folded_heads
    return max(1, min(math.ceil(n / 64), math.ceil(SLOT_MIN_BLOCKS / blocks)))


def launched_passes(kernel, n: int, s: int, folded_heads: int) -> tuple:
    """The device kernels (`kernel.passes`) that one launch of the forward
    or backward kernel runs: both passes, and the split reduce when N is
    split."""
    split = slot_splits(n, s, folded_heads) > 1
    return kernel.passes if split else kernel.passes[:2]


def _fwd_cuda(q, k, v, slot_valid, q_valid, segments, rate, seed):
    """Forward kernel → (out, row_max, row_scale). With several splits the
    kernel sums f32 partials (scratch here) in a fixed order: no atomics,
    the same bits every run."""
    h, kn, dk = q.shape
    n, s = kn // segments, k.shape[1] // segments
    splits = slot_splits(n, s, h * segments)
    out = torch.empty((h, k.shape[1], dk), dtype=q.dtype, device=q.device)
    row_max = torch.empty((h * kn,), dtype=torch.float32, device=q.device)
    row_scale = torch.empty_like(row_max)
    partial = torch.empty((splits if splits > 1 else 0, h, k.shape[1], dk),
                          dtype=torch.float32, device=q.device)
    dtype, scale, seed32, rate, inv_keep = _scalar_args(q, rate, seed)
    launch(FWD, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           slot_valid.data_ptr(), q_valid.data_ptr(), out.data_ptr(),
           row_max.data_ptr(), row_scale.data_ptr(), partial.data_ptr(), h,
           segments, n, s, dk, dtype, splits, scale, seed32, rate, inv_keep)
    return out, row_max, row_scale


def _bwd_cuda(q, k, v, slot_valid, row_max, row_scale, g, segments, rate,
              seed):
    """Backward kernel → (dq, dk, dv). Its slot pass splits N as the
    forward's does and sums the f32 partials (scratch here) in a fixed
    order: no atomics, the same bits every run."""
    h, kn, dk = q.shape
    n, s = kn // segments, k.shape[1] // segments
    splits = slot_splits(n, s, h * segments)
    dq, dkey, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(row_max)
    partial = torch.empty((splits if splits > 1 else 0, h, k.shape[1], dk),
                          dtype=torch.float32, device=q.device)
    dtype, scale, seed32, rate, inv_keep = _scalar_args(q, rate, seed)
    launch(BWD, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           g.data_ptr(), slot_valid.data_ptr(), row_max.data_ptr(),
           row_scale.data_ptr(), dq.data_ptr(), dkey.data_ptr(),
           dv.data_ptr(), delta.data_ptr(), partial.data_ptr(), h, segments,
           n, s, dk, dtype, splits, scale, seed32, rate, inv_keep)
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
