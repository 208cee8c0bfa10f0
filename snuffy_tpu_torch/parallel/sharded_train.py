"""Data-parallel MIL training: a batch of bags split over the ranks.

The dp half of `snuffy_tpu/parallel/sharded_train.py:88-312` (sp = tp = 1;
sequence and tensor parallelism are Slice 7b). A batch of B bags takes ONE
optimizer step, as `SnuffyTrainer.packed_train_step` takes it on one
device; over W ranks:

  * every rank holds the same batch (the Runner loads the same data
    everywhere) and `make_global_batch` keeps its contiguous block of B/W
    bags, which runs through the packed step (K1/K2 in segment mode,
    segments = B/W);
  * the loss is Σ(losses · bag_w) over the rank's bags divided by the
    GLOBAL Σ bag_w (`global_bag_weight`, all-reduced), and the gradients
    of the model and of w are SUMMED over the ranks
    (`sum_gradients`): so (losses · bag_w).sum() / max(Σ bag_w, 1) stays
    exact when a tail batch leaves the ranks unequal real bags
    (zero-weight dummies, `sharded_train.py:219-220`); the clip comes
    after the sum;
  * `fetch_batch_outputs` gathers the per-bag losses, scores and instance
    scores to every rank over the host group, in batch order.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from snuffy_tpu_torch.parallel import distributed
from snuffy_tpu_torch.parallel.mesh import Mesh
from snuffy_tpu_torch.parallel.ssl_sharding import allreduce_gradients


def make_global_batch(mesh: Mesh, feats_b, masks_b, labels_b, bag_w):
    """The batch every rank holds → this rank's block of B/W bags."""
    rows = distributed.process_batch_slice(feats_b.shape[0], mesh.rank)
    return tuple(a[rows] for a in (feats_b, masks_b, labels_b, bag_w))


def global_bag_weight(bag_w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ bag_w over every rank's bags (one all-reduce of a scalar)."""
    total = bag_w.sum()
    dist.all_reduce(total, group=mesh.group)
    return total


@torch.no_grad()
def sum_gradients(params: List[torch.Tensor], mesh: Mesh) -> None:
    """Each parameter's .grad summed over the ranks, in place (the same
    bits on every rank)."""
    params = [p for p in params if p.grad is not None]
    summed = allreduce_gradients([p.grad for p in params], mesh,
                                 average=False)
    for p, g in zip(params, summed):
        p.grad.copy_(g)


def fetch_batch_outputs(mesh: Mesh, *tensors: torch.Tensor):
    """Each rank's per-bag outputs (its block of the batch) → the whole
    batch's, on the CPU, on every rank."""
    return tuple(torch.cat(distributed.host_allgather_tensor(t))
                 for t in tensors)


def make_sharded_batch_train_step(trainer, mesh: Mesh):
    """(feats (B, N, D), masks (B, N), labels (B, C), bag_w (B,),
    generator, seed_generator) → (losses (B,), scores (B, C), ins_scores
    (B, N, C)) on the CPU: one optimizer step of `trainer` (its mesh is
    `mesh`) over the batch split across the ranks."""
    if trainer.mesh is not mesh:
        raise ValueError("the trainer steps over another mesh")

    def step(feats_b, masks_b, labels_b, bag_w, generator, seed_generator):
        local = make_global_batch(mesh, feats_b, masks_b, labels_b, bag_w)
        out = trainer.packed_train_step(*local, generator, seed_generator)
        return fetch_batch_outputs(mesh, *out)

    return step
