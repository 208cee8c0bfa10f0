"""Data parallelism for the SSL trainers (and the MIL step's gradients).

The port of `snuffy_tpu/parallel/ssl_sharding.py`. The JAX package puts
the image batch on the dp axis of a mesh and replicates the state; GSPMD
turns the gradient means into psums. With one process per GPU:

  * `shard_images` / `shard_crops`: a rank's rows of a batch that every
    rank holds (the crops drawn once, then split);
  * `replicate_state`: rank 0's tensors broadcast to every rank at start;
  * `allreduce_gradients`: a list of gradients all-reduced as a few flat
    buckets (sum, or mean over the ranks), in place of DDP: the SSL
    trainers take `torch.autograd.grad` on masked parameter lists
    (`ssl/dino.py`, `ssl/mae_trainer.py`), which DDP's hooks do not see.

The DINO centre's global mean (reference main_dino_adapter.py:666-668)
is `mesh_metric_mean` (`utils/metrics_sync.py`). `shard_batch_global`
has no counterpart: a rank's process-local rows are its shard already.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from snuffy_tpu_torch.parallel.distributed import process_batch_slice
from snuffy_tpu_torch.parallel.mesh import Mesh

# DDP's default bucket size.
BUCKET_BYTES = 25 * 2 ** 20


def shard_images(batch: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(B, ...) → this rank's (B/W, ...) block."""
    return batch[process_batch_slice(batch.shape[0], mesh.rank,
                                     mesh.size)]


def shard_crops(crops: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(V, B, ...) multi-crop stack → this rank's (V, B/W, ...) block."""
    return crops[:, process_batch_slice(crops.shape[1], mesh.rank,
                                         mesh.size)]


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _buckets(tensors: List[torch.Tensor], bucket_bytes: int):
    """Consecutive runs of one dtype and device, each up to `bucket_bytes`
    (a larger tensor takes a bucket of its own): lists of indices."""
    out: List[List[int]] = []
    size, key = 0, None
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        k = (t.dtype, t.device)
        if not out or k != key or size + nbytes > bucket_bytes:
            out.append([])
            size, key = 0, k
        out[-1].append(i)
        size += nbytes
    return out


@torch.no_grad()
def replicate_state(tree: Any, mesh: Optional[Mesh]) -> None:
    """Every tensor of `tree` (modules' state dicts, dicts, lists, tensors)
    set to rank 0's, in place, by flat broadcasts."""
    if mesh is None:
        return
    tensors = _tensors(tree)
    for idx in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.broadcast(flat, src=0, group=mesh.group)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            tensors[i].copy_(part.view_as(tensors[i]))


@torch.no_grad()
def allreduce_gradients(grads: List[torch.Tensor], mesh: Optional[Mesh],
                        average: bool = True,
                        stats: Optional[List[Dict[str, float]]] = None
                        ) -> List[torch.Tensor]:
    """`grads` summed over the ranks (divided by their count when
    `average`), as new tensors, by one all-reduce a bucket of
    BUCKET_BYTES. Every rank gets the same bits, so replicas that apply
    them stay equal. With a `stats` list, appends each bucket's bytes and
    all-reduce seconds (the device synchronised around it). No mesh (one
    process): `grads`."""
    if mesh is None:
        return list(grads)
    out = list(grads)
    for idx in _buckets(out, BUCKET_BYTES):
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        if stats is not None:
            _sync(flat.device)
            t0 = time.perf_counter()
        dist.all_reduce(flat, group=mesh.group)
        if stats is not None:
            _sync(flat.device)
            stats.append({"bytes": flat.numel() * flat.element_size(),
                          "s": time.perf_counter() - t0})
        if average:
            flat.div_(mesh.size)
        for i, part in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = part.view_as(out[i])
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
