"""Sequence-parallel ops over the mesh's `sp` axis: the three places the
(N, d) residual stream would otherwise be gathered whole.

The port of `snuffy_tpu/parallel/sp_attention.py`. For bags too long for
one card, the N (row) axis of a bag is split over the sp ranks: each
holds N/sp rows, and everything elementwise over N (LayerNorm, FFN,
residual adds) runs on them alone. Three ops touch rows by global index:

  1. the selected-row gather   (`sp_gather_rows`)
  2. the inverted sparse attention (`sp_inverted_sparse_attention`)
  3. the selected-row scatter  (`sp_scatter_rows`)

The attention decomposes exactly: each row's softmax over the S slots is
its own, and out[j] = Σ_i p[i, j] v_i is a sum over rows, so K1 runs on
the rank's rows and the partial (h, S, dk) outputs are summed over sp.
Every collective moves (S, d)-sized tensors (S = Λ ≪ N): nothing
N-proportional crosses between ranks.

The selected rows, the keys and the attention output are whole on every
sp rank, and each rank's backward sees only its own rows' share of their
gradients: the keys enter K1 through `copy_to` (their gradient summed
over sp), the rows to scatter likewise, and the gathered rows and the
summed output leave through `reduce_from` (their gradient, whole, passed
through). The `*_local` functions are one rank's part without any
collective; the tests run every rank's part in one process and sum.
"""

from __future__ import annotations

from typing import Optional

import torch

from snuffy_tpu_torch.ops.fused_attention import (
    fused_inverted_sparse_attention,
)
from snuffy_tpu_torch.parallel.collectives import copy_to, reduce_from

# The JAX op's seed offsets (sp_attention.py:86-89), in wrapping int32.
SP_SEED_STRIDE = 7919
TP_SEED_STRIDE = 104729


def sp_size(mesh) -> int:
    """Sequence-parallel degree of a mesh (1 if absent)."""
    return 1 if mesh is None else mesh.sp


def _int32(x: int) -> int:
    return (int(x) + 2**31) % 2**32 - 2**31


def sp_dropout_seed(seed: int, sp_index: int,
                    tp_index: Optional[int] = None) -> int:
    """The shard's kernel seed: seed + sp_index·7919, plus
    tp_index·104729 where the heads shard over tp, in wrapping int32."""
    s = int(seed) + sp_index * SP_SEED_STRIDE
    if tp_index is not None:
        s += tp_index * TP_SEED_STRIDE
    return _int32(s)


def sp_attention_local(q, k, v, slot_valid, q_valid, *, sp_index: int,
                       tp_index: Optional[int] = None,
                       dropout_rate: float = 0.0,
                       dropout_seed: Optional[int] = None) -> torch.Tensor:
    """One rank's partial (h, S, dk): K1 on its rows q, v (h, N/sp, dk)
    against the whole k (h, S, dk)."""
    seed = None
    if dropout_rate > 0.0 and dropout_seed is not None:
        seed = sp_dropout_seed(dropout_seed, sp_index, tp_index)
    return fused_inverted_sparse_attention(
        q, k, v, slot_valid, q_valid,
        dropout_rate=dropout_rate if seed is not None else 0.0,
        dropout_seed=seed)


def sp_inverted_sparse_attention(
    q: torch.Tensor,           # (h_local, N/sp, dk): this rank's rows
    k: torch.Tensor,           # (h_local, S, dk), whole on every sp rank
    v: torch.Tensor,           # (h_local, N/sp, dk)
    slot_valid: torch.Tensor,  # (S,)
    q_valid: torch.Tensor,     # (N/sp,)
    mesh,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """→ (h_local, S, dk), whole on every sp rank: the one-rank op's
    output. With tp > 1 the heads are this rank's h/tp (the seed then
    also takes tp_index·104729, as the JAX op's does)."""
    part = sp_attention_local(
        q, copy_to(k, mesh, "sp", "attention keys"), v, slot_valid, q_valid,
        sp_index=mesh.sp_rank,
        tp_index=mesh.tp_rank if mesh.tp > 1 else None,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    return reduce_from(part, mesh, "sp", "attention partials").to(q.dtype)


def owned_rows(x: torch.Tensor, indices: torch.Tensor, sp_index: int
               ) -> torch.Tensor:
    """(S, d): the rows of global ids `indices` that this rank's block x
    (N/sp, d) holds, zero elsewhere."""
    n_loc = x.shape[0]
    li = indices - sp_index * n_loc
    owned = (li >= 0) & (li < n_loc)
    rows = x.index_select(0, li.clamp(0, n_loc - 1))
    return torch.where(owned[:, None], rows, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def sp_gather_rows(x: torch.Tensor, indices: torch.Tensor, mesh
                   ) -> torch.Tensor:
    """(S, d) rows of global ids `indices` from the row-split stream x
    (N/sp, d), whole on every sp rank: the owner contributes each row,
    summed."""
    return reduce_from(owned_rows(x, indices, mesh.sp_rank), mesh, "sp",
                       "gathered rows").to(x.dtype)


def scatter_owned_rows(x: torch.Tensor, indices: torch.Tensor,
                       slot_valid: torch.Tensor, rows: torch.Tensor,
                       sp_index: int) -> torch.Tensor:
    """x (N/sp, d) with the valid slots' rows that this rank owns set from
    `rows` (S, d); out of place (the gradient reaches x and rows)."""
    n_loc, d = x.shape
    li = indices - sp_index * n_loc
    keep = (li >= 0) & (li < n_loc) & slot_valid
    li = torch.where(keep, li, torch.full_like(li, n_loc))
    return torch.cat([x, x.new_zeros(1, d)]).index_copy(
        0, li, rows.to(x.dtype))[:n_loc]


def sp_scatter_rows(x: torch.Tensor, indices: torch.Tensor,
                    slot_valid: torch.Tensor, rows: torch.Tensor, mesh
                    ) -> torch.Tensor:
    """The row-split scatter of `rows` (S, d), whole on every sp rank, to
    global ids `indices`: each rank writes the rows it owns. No collective
    forward; the rows' gradient is summed over sp."""
    return scatter_owned_rows(
        x, indices, slot_valid, copy_to(rows, mesh, "sp", "scattered rows"),
        mesh.sp_rank)
