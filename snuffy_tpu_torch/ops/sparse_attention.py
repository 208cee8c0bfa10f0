"""The Snuffy "inverted" sparse attention, in plain PyTorch.

Port of `snuffy_tpu/ops/sparse_attention.py`. With queries q_i for all N
rows and keys k_j for the S selected slots,

    p[i, j] = softmax_j(q_i · k_j / √dk)     rows sum to 1 over the slots
    out[j]  = Σ_i p[i, j] · v_i              transpose product, (h, S, dk)

Dead slots score −1e30 (never −inf: an all-dead segment must softmax to a
finite uniform row), and dead rows contribute nothing. Products and sums
run in float32 whatever the input type; the output takes v's type.

Dropout uses the counter hash of the TPU kernel
(`snuffy_tpu/ops/pallas_attention.py::_keep_factor`) instead of a random
generator, so this module is the exact oracle of the CUDA kernels in
`fused_attention.py` and of the JAX kernel, dropout included, in both
directions: `packed_inverted_sparse_attention_bwd` is the backward.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

_C1 = 0x9E3779B9
_C2 = 0x85EBCA6B
_C3 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²): split in 16-bit halves so
    no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def keep_factor(seed, hh, row, col, rate: float) -> torch.Tensor:
    """keep/(1−rate) as float32, broadcast over (hh, row, col).

    Bit for bit the TPU kernel's `_keep_factor`: that hash multiplies in
    wrapping int32 and shifts right logically, so here the arithmetic runs
    in int64 masked to 32 bits. `hh` is head·segments + segment, `row` the
    row within the segment and `col` the slot within the segment; `seed`
    may be negative (it is taken mod 2³²).
    """
    def as_i64(x):
        return torch.as_tensor(x, dtype=torch.int64)

    row, col, hh = as_i64(row), as_i64(col), as_i64(hh)
    salt = (as_i64(seed) + _mul32(hh & _MASK32, _C3)) & _MASK32
    x = _mul32(row, _C1) ^ _mul32(col, _C2) ^ salt
    x = x ^ (x >> 16)
    x = _mul32(x, _C2)
    x = x ^ (x >> 13)
    x = _mul32(x, _C3)
    x = x ^ (x >> 16)
    u = (x & 0xFFFFFF).to(torch.float32) * (1.0 / 16777216.0)
    keep = (u >= torch.tensor(rate, dtype=torch.float32)).to(torch.float32)
    return keep * torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)


def _split_segments(q, k, segments):
    h, kn, dk = q.shape
    ks = k.shape[1]
    if kn % segments or ks % segments:
        raise ValueError(
            f"packed rows ({kn}) and slots ({ks}) must divide segments="
            f"{segments}"
        )
    return h, kn // segments, ks // segments, dk


def _softmax_and_factor(q, k, slot_valid, q_valid, segments, dropout_rate,
                        dropout_seed):
    """σ (h, k, N, S), the per-segment softmax over the slots, and the
    factor f = q_valid · keep/(1−rate) that scales it, both f32."""
    h, n, s, dk = _split_segments(q, k, segments)
    qb = q.reshape(h, segments, n, dk).float()
    kb = k.reshape(h, segments, s, dk).float()
    sv = slot_valid.reshape(segments, s).to(torch.bool)
    qv = q_valid.reshape(segments, n).to(q.device, torch.float32)

    scores = torch.einsum("hknd,hksd->hkns", qb, kb) * (1.0 / math.sqrt(dk))
    scores = scores.masked_fill(~sv[None, :, None, :], NEG_INF)
    sigma = torch.softmax(scores, dim=-1)
    factor = qv[None, :, :, None]
    if dropout_rate > 0.0:
        dev = q.device
        hh = (torch.arange(h, device=dev)[:, None] * segments
              + torch.arange(segments, device=dev)[None, :])
        factor = factor * keep_factor(
            0 if dropout_seed is None else int(dropout_seed),
            hh[:, :, None, None],
            torch.arange(n, device=dev)[:, None],
            torch.arange(s, device=dev),
            dropout_rate,
        ).to(dev)
    return sigma, factor


def packed_inverted_sparse_attention(
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
    """Per-segment inverted sparse attention → (h, k·S, dk): bag s's rows
    attend only to bag s's slots."""
    h, n, s, dk = _split_segments(q, k, segments)
    sigma, factor = _softmax_and_factor(q, k, slot_valid, q_valid, segments,
                                        dropout_rate, dropout_seed)
    vb = v.reshape(h, segments, n, dk).float()
    out = torch.einsum("hkns,hknd->hksd", sigma * factor, vb)
    return out.reshape(h, segments * s, dk).to(v.dtype)


def packed_inverted_sparse_attention_bwd(
    q: torch.Tensor,           # (h, k·N, dk)
    k: torch.Tensor,           # (h, k·S, dk)
    v: torch.Tensor,           # (h, k·N, dk)
    slot_valid: torch.Tensor,  # (k·S,) bool
    q_valid: torch.Tensor,     # (k·N,) bool
    g: torch.Tensor,           # (h, k·S, dk): gradient of the output
    segments: int,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `packed_inverted_sparse_attention`, in f32 and
    returned in the inputs' types: the formulas of the TPU backward
    (`snuffy_tpu/ops/pallas_attention.py::_bwd_kernel`). With p̃ = σ·f:

        dv = p̃ g          dσ = (v gᵀ)·f
        ds = σ (dσ − rowsum(σ·dσ)) · slot_valid
        dq = ds k / √dk    dk = dsᵀ q / √dk

    The slot mask on ds is the JAX einsum oracle's gradient, where a dead
    slot's constant score passes none back. It matters only in a segment
    with live rows and no live slot, whose σ is uniform: the TPU kernel
    leaves ds unmasked there and sends gradient into the dead slots.
    """
    h, n, s, dk = _split_segments(q, k, segments)
    sigma, factor = _softmax_and_factor(q, k, slot_valid, q_valid, segments,
                                        dropout_rate, dropout_seed)
    qb = q.reshape(h, segments, n, dk).float()
    kb = k.reshape(h, segments, s, dk).float()
    vb = v.reshape(h, segments, n, dk).float()
    gb = g.reshape(h, segments, s, dk).float()
    sv = slot_valid.reshape(segments, s).to(q.device, torch.float32)

    dv = torch.einsum("hkns,hksd->hknd", sigma * factor, gb)
    dsig = torch.einsum("hknd,hksd->hkns", vb, gb) * factor
    ds = sigma * (dsig - (sigma * dsig).sum(dim=-1, keepdim=True))
    ds = ds * sv[None, :, None, :] * (1.0 / math.sqrt(dk))
    dq = torch.einsum("hkns,hksd->hknd", ds, kb)
    dkey = torch.einsum("hkns,hknd->hksd", ds, qb)
    return (dq.reshape(q.shape).to(q.dtype),
            dkey.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype))


def inverted_sparse_attention(
    q: torch.Tensor,           # (h, N, dk)
    k: torch.Tensor,           # (h, S, dk)
    v: torch.Tensor,           # (h, N, dk)
    slot_valid: torch.Tensor,  # (S,) bool
    q_valid: torch.Tensor,     # (N,) bool
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """One bag: `packed_inverted_sparse_attention` with one segment."""
    return packed_inverted_sparse_attention(
        q, k, v, slot_valid, q_valid, 1,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
    )
