"""MIL losses: weighted BCE-with-logits and the bag/instance mix.

Port of `snuffy_tpu/train/losses.py` (forward only): the loss is

    w · BCE(bag_logits, y) + (1 − w) · BCE(max_i ins_logits, y)

and the bag score is the matching sigmoid mixture. The instance max skips
padded rows with a −1e30 guard, not −inf, so an all-padded dummy bag stays
finite. `pos_weight` is None, a scalar or a (C,) tensor (multiclass: one
weight a class). Under a mesh of sp > 1 (one bag, its rows split over the
sp ranks) the instance max is over the global N: each rank's max is
gathered over sp and the first largest (the lowest global row among
ties) carries the gradient, to the rank that holds it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

PosWeight = Optional[Union[float, torch.Tensor]]


def bce_with_logits(logits, targets, pos_weight=None) -> torch.Tensor:
    """Mean of −[pw·y·log σ(x) + (1−y)·log(1−σ(x))]."""
    pw = 1.0 if pos_weight is None else pos_weight
    losses = -(pw * targets * F.logsigmoid(logits)
               + (1.0 - targets) * F.logsigmoid(-logits))
    return losses.mean(dim=-1)


def masked_instance_max(ins_logits: torch.Tensor, mask: torch.Tensor,
                        mesh=None) -> torch.Tensor:
    """max over valid rows: (…, N, C), (…, N) → (…, C); under sp, over
    every rank's rows."""
    guarded = torch.where(mask[..., None], ins_logits,
                          torch.tensor(-1e30, dtype=ins_logits.dtype,
                                       device=ins_logits.device))
    local = guarded.max(dim=-2).values
    if mesh is None or mesh.sp == 1:
        return local
    from snuffy_tpu_torch.parallel.collectives import reduce_from

    # (sp, …, C): row i holds rank i's max, summed over the ranks
    slots = torch.zeros((mesh.sp,) + tuple(local.shape), dtype=local.dtype,
                        device=local.device)
    slots = slots.index_copy(0, torch.tensor([mesh.sp_rank],
                                             device=local.device),
                             local[None])
    return reduce_from(slots, mesh, "sp", "instance maxima").max(
        dim=0).values


def mixed_mil_loss(
    ins_logits: torch.Tensor,   # (N, C)
    bag_logits: torch.Tensor,   # (C,)
    bag_label: torch.Tensor,    # (C,)
    mask: torch.Tensor,         # (N,) bool
    w,                          # scalar in [0, 1]
    pos_weight: PosWeight = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, bag_score (C,)); batched over any leading axes."""
    max_logits = masked_instance_max(ins_logits, mask, mesh)
    bag_loss = bce_with_logits(bag_logits, bag_label, pos_weight)
    max_loss = bce_with_logits(max_logits, bag_label, pos_weight)
    loss = w * bag_loss + (1.0 - w) * max_loss
    bag_score = ((1.0 - w) * torch.sigmoid(max_logits)
                 + w * torch.sigmoid(bag_logits))
    return loss, bag_score


def packed_mixed_mil_loss(
    ins_logits: torch.Tensor,   # (k·N, C): k bags packed on the row axis
    bag_logits: torch.Tensor,   # (k, C)
    bag_labels: torch.Tensor,   # (k, C)
    mask: torch.Tensor,         # (k·N,)
    w,
    pos_weight: PosWeight = None,
    *,
    segments: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bag `mixed_mil_loss` → (losses (k,), bag_scores (k, C))."""
    kn, c = ins_logits.shape
    return mixed_mil_loss(
        ins_logits.reshape(segments, kn // segments, c), bag_logits,
        bag_labels, mask.reshape(segments, kn // segments), w, pos_weight,
    )
