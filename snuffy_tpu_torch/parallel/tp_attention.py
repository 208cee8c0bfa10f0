"""Tensor-parallel sparse attention: K1/K2 on a rank's own heads.

The port of `snuffy_tpu/parallel/tp_attention.py`. Megatron's
column-parallel wq, wk and wv (`parallel/sharded_train.py` TP_RULES) give
each tp rank a contiguous block of output features, and splitting heads
maps block i onto heads [i·h/tp, (i+1)·h/tp): the rank's (h/tp, N, dk)
q, k and v are its heads already. Each head's softmax and sum touch only
that head, so the kernel runs on the local heads with no collective
inside; the (h/tp, S, dk) output is the row-parallel input that wo takes,
and wo's partial products are the one all-reduce.

Dropout stays bit for bit the one-rank kernel's: the kernel's hash keys
on seed + local_head·C3, so offsetting the shard's seed by
first_global_head·C3 (wrapping int32, as the kernel) makes every local
head hash as its global head. With sp > 1 as well the model takes the
sp op, whose seed convention is its own (`sp_attention.py`), as the JAX
model does.
"""

from __future__ import annotations

from typing import Optional

import torch

from snuffy_tpu_torch.ops.fused_attention import (
    fused_inverted_sparse_attention,
)

# the kernel hash's head multiplier 0xC2B2AE35 as a signed int32
C3 = -1028477387


def tp_size(mesh) -> int:
    return 1 if mesh is None else mesh.tp


def tp_dropout_seed(seed: int, first_head: int) -> int:
    """seed + first_head·C3 in wrapping int32."""
    return (int(seed) + first_head * C3 + 2**31) % 2**32 - 2**31


def tp_fused_inverted_sparse_attention(
    q: torch.Tensor,           # (h/tp, N, dk): this rank's heads
    k: torch.Tensor,           # (h/tp, S, dk)
    v: torch.Tensor,           # (h/tp, N, dk)
    slot_valid: torch.Tensor,  # (S,) bool
    q_valid: torch.Tensor,     # (N,) bool
    tp_index: int,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """→ (h/tp, S, dk): the one-rank op's output for heads
    [tp_index·h/tp, (tp_index + 1)·h/tp), dropout masks included."""
    seed = None
    if dropout_rate > 0.0 and dropout_seed is not None:
        seed = tp_dropout_seed(dropout_seed, tp_index * q.shape[0])
    return fused_inverted_sparse_attention(
        q, k, v, slot_valid, q_valid,
        dropout_rate=dropout_rate if seed is not None else 0.0,
        dropout_seed=seed)
