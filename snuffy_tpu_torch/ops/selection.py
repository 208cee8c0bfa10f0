"""Static-shape token selection for the Snuffy sparse attention pattern.

Port of `snuffy_tpu/ops/selection.py`. Binary: per encoder layer the Λ
slots are the top ⌈Λ·(1−ρ)⌉ rows by instance logit plus ⌊Λ·ρ⌋ rows drawn
uniformly without replacement from the rest. Multiclass (reference
snuffy_multiclass.py:130-160): the union r of each class's top k_top
rows, in ascending order, then ref_dim = max(min(r, n_valid − r), 0)
slots of it and ref_dim rows drawn from the valid rows outside the whole
union, in S = 2·min(k_top·C, N) slots. Every selection
returns a per-slot validity mask, so padded bags keep one static slot
count S. Ties in the top share go to the lowest index (a stable
descending sort, as `lax.top_k` does; `torch.topk` does not promise it).
The random share is Gumbel-top-k over the remainder, drawn from an
explicit `torch.Generator`: it is the same distribution as the JAX draw,
not the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class Selection(NamedTuple):
    """indices (…, S) int64 positions in the padded bag — invalid slots hold
    an arbitrary position and must be routed through `slot_valid` (…, S)."""

    indices: torch.Tensor
    slot_valid: torch.Tensor


class PreparedSelection(NamedTuple):
    """The layer-invariant part: the top share and the valid rows left
    after it (the instance logits do not change between layers)."""

    top: Selection
    remainder: torch.Tensor  # (…, N) bool: valid and not in the top share
    ref_dim: Optional[torch.Tensor] = None  # (…,) multiclass only


def _padded_top_k(guarded: torch.Tensor, k: int) -> Selection:
    """Top k along the last axis, lowest index first among ties; slots past
    the axis length come back invalid so S stays k."""
    k_eff = min(k, guarded.shape[-1])
    vals, idx = torch.sort(guarded, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k_eff], idx[..., :k_eff]
    valid = torch.isfinite(vals)
    if k_eff < k:
        pad = list(idx.shape[:-1]) + [k - k_eff]
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(pad)], dim=-1)
    return Selection(idx, valid)


def top_share_selection(
    scores: torch.Tensor, valid: torch.Tensor, k: int
) -> Selection:
    """Top-k positions by score among valid rows; scores (…, N), valid
    (…, N) bool."""
    guarded = torch.where(valid, scores.float(),
                          torch.tensor(float("-inf"), device=scores.device))
    return _padded_top_k(guarded, k)


def gumbel_without_replacement(
    generator: Optional[torch.Generator], allowed: torch.Tensor, k: int
) -> Selection:
    """k positions drawn uniformly without replacement from `allowed`
    (…, N) bool: Gumbel noise on equal logits, then the top k."""
    e = torch.empty(allowed.shape, dtype=torch.float32, device=allowed.device)
    e = e.exponential_(generator=generator)
    # An exponential draw of exactly 0 would give +inf noise and read as
    # an invalid slot.
    g = -torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))
    guarded = torch.where(allowed, g,
                          torch.tensor(float("-inf"), device=allowed.device))
    return _padded_top_k(guarded, k)


def binary_selection_prepare(
    instance_logits: torch.Tensor, valid: torch.Tensor, k_top: int
) -> PreparedSelection:
    """instance_logits (…, N), valid (…, N) bool. With a leading segment
    axis this is the packed prepare: one top share per bag."""
    top = top_share_selection(instance_logits, valid, k_top)
    # Invalid top slots index positions that are already False.
    remainder = valid.scatter(-1, top.indices, False)
    return PreparedSelection(top, remainder)


def binary_selection_draw(
    generator: Optional[torch.Generator], prep: PreparedSelection,
    k_rand: int,
) -> Selection:
    if k_rand == 0:
        return prep.top
    rand = gumbel_without_replacement(generator, prep.remainder, k_rand)
    return Selection(
        torch.cat([prep.top.indices, rand.indices], dim=-1),
        torch.cat([prep.top.slot_valid, rand.slot_valid], dim=-1),
    )


def binary_lambda_selection(
    generator: Optional[torch.Generator],
    instance_logits: torch.Tensor,  # (…, N) single-class logits
    valid: torch.Tensor,            # (…, N) bool
    k_top: int,
    k_rand: int,
) -> Selection:
    """The binary Λ pattern in one call (prepare, then draw): S = k_top +
    k_rand slots. Surplus top slots (n_valid < k_top) are invalid; the
    random share draws from the valid rows outside the top share, capped
    at their count by slot validity (reference snuffy.py:126-153)."""
    return binary_selection_draw(
        generator, binary_selection_prepare(instance_logits, valid, k_top),
        k_rand)


def _unique_ascending(flat_idx: torch.Tensor, flat_valid: torch.Tensor,
                      n: int):
    """The distinct valid values of `flat_idx` (…, L) (in [0, n)) in
    ascending order, moved to the front, → (compacted (…, L), count r
    (…,)). The entries past r hold n."""
    guarded = torch.where(flat_valid, flat_idx, torch.full_like(flat_idx, n))
    s = torch.sort(guarded, dim=-1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    is_unique = first & (s < n)
    order = torch.sort((~is_unique).to(torch.int32), dim=-1,
                       stable=True).indices
    return s.gather(-1, order), is_unique.sum(dim=-1)


def multiclass_selection_prepare(
    instance_logits: torch.Tensor, valid: torch.Tensor, k_top: int
) -> PreparedSelection:
    """instance_logits (…, N, C), valid (…, N) bool → the ascending union
    of the classes' top min(k_top, N) rows in min(k_top·C, N) slots, the
    first ref_dim of them valid, and the valid rows outside the union."""
    n, c = instance_logits.shape[-2:]
    s_half = min(k_top * c, n)
    sels = [top_share_selection(instance_logits[..., cl], valid,
                                min(k_top, n)) for cl in range(c)]
    flat_idx = torch.cat([sel.indices for sel in sels], dim=-1)
    flat_val = torch.cat([sel.slot_valid for sel in sels], dim=-1)
    uniq, r = _unique_ascending(flat_idx, flat_val, n)
    n_valid = valid.sum(dim=-1)
    ref_dim = torch.minimum(r, n_valid - r).clamp_min(0)
    slot_ids = torch.arange(s_half, device=valid.device)
    head = uniq[..., :s_half]
    # slots past r hold n; they are invalid, and any in-range row will do
    top = Selection(torch.where(head < n, head, torch.zeros_like(head)),
                    slot_ids < ref_dim[..., None])
    cleared = torch.where(flat_val, flat_idx, torch.full_like(flat_idx, n))
    remainder = torch.cat([valid, valid.new_zeros(valid.shape[:-1] + (1,))],
                          dim=-1).scatter(-1, cleared, False)[..., :n]
    return PreparedSelection(top, remainder, ref_dim)


def multiclass_selection_draw(
    generator: Optional[torch.Generator], prep: PreparedSelection
) -> Selection:
    """The top half, then as many slots drawn uniformly without
    replacement from the remainder, the first ref_dim of them valid."""
    s_half = prep.top.indices.shape[-1]
    rand = gumbel_without_replacement(generator, prep.remainder, s_half)
    slot_ids = torch.arange(s_half, device=rand.indices.device)
    rand_valid = (slot_ids < prep.ref_dim[..., None]) & rand.slot_valid
    return Selection(
        torch.cat([prep.top.indices, rand.indices], dim=-1),
        torch.cat([prep.top.slot_valid, rand_valid], dim=-1),
    )


def multiclass_lambda_selection(
    generator: Optional[torch.Generator],
    instance_logits: torch.Tensor,  # (…, N, C)
    valid: torch.Tensor,            # (…, N) bool
    k_top: int,
) -> Tuple[Selection, torch.Tensor]:
    """The multiclass Λ pattern in one call (reference
    snuffy_multiclass.py:130-160) → (Selection of S = 2·min(k_top·C, N)
    slots, ref_dim): the first ref_dim rows of the classes' ascending
    top-k union, then ref_dim rows drawn from the valid rows outside it."""
    prep = multiclass_selection_prepare(instance_logits, valid, k_top)
    return multiclass_selection_draw(generator, prep), prep.ref_dim


def packed_selection_prepare(
    instance_logits: torch.Tensor,  # (k, N), or (k, N, C) multiclass
    valid: torch.Tensor,            # (k, N) bool
    k_top: int,
    multiclass: bool = False,
) -> PreparedSelection:
    """Per-bag top share for k bags packed on the row axis; indices stay in
    per-bag coordinates until `packed_selection_draw`."""
    if multiclass:
        return multiclass_selection_prepare(instance_logits, valid, k_top)
    return binary_selection_prepare(instance_logits, valid, k_top)


def packed_selection_draw(
    generator: Optional[torch.Generator],
    prep: PreparedSelection,  # leading (k,) axis
    k_rand: int,
    seg_len: int,
    multiclass: bool = False,
) -> Selection:
    """Each bag's random share drawn independently; returns ONE flat
    selection in packed row coordinates: bag s's slots fill
    [s·S, (s+1)·S) and point into rows [s·seg_len, (s+1)·seg_len)."""
    if multiclass:
        sel = multiclass_selection_draw(generator, prep)
    else:
        sel = binary_selection_draw(generator, prep, k_rand)
    k = sel.indices.shape[0]
    offsets = (torch.arange(k, device=sel.indices.device) * seg_len)[:, None]
    return Selection(
        (sel.indices + offsets).reshape(-1), sel.slot_valid.reshape(-1)
    )
