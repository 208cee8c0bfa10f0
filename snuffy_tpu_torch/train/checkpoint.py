"""Sharded checkpoints on `torch.distributed.checkpoint` (DCP).

The port of `snuffy_tpu/train/checkpoint.py` (orbax there). The Runner's
`.pth` files hold the whole model, gathered to rank 0 (the reference's
artifact contract); this module is the mesh-aware path: every rank
writes its own shards in parallel and reads its own shards back, into
the layout of the state it restores into.

A state is a flat dict of tensors (parameters, optimizer moments,
counters). A key that splits over tp (by the MILNet's tp rules,
`parallel/sharded_train.tp_dim`, which match the moments by the
parameter name that ends their key) is handed to DCP as a
`DTensor` sharded over the mesh's tp group, so each tp rank writes its
own block; DCP keeps one copy of what several ranks hold equal (a plain
tensor under one name on two ranks is one tensor to DCP: two tp blocks
saved as plain tensors would lose one). Tensors are saved from the CPU,
and DCP exchanges its metadata over the host (gloo) group.

`ShardedCheckpointManager` keeps orbax's `CheckpointManager` contract as
the JAX package configures it: saves are atomic (a temporary directory
renamed by rank 0 once every rank wrote), `max_to_keep` checkpoints stay
(more only while there are no more than that), the best by the largest
`valid_auc` among those saved with metrics, and none saved without
metrics once there are more than `max_to_keep`; `latest_step`,
`best_step` and `all_steps` as orbax's.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import torch

from snuffy_tpu_torch.parallel import distributed
from snuffy_tpu_torch.parallel.sharded_train import tp_dim

METRICS_FILE = "metrics.json"
TMP_SUFFIX = ".tmp"
BEST_METRIC = "valid_auc"   # the larger the better


def _described(state: Dict[str, torch.Tensor], mesh
               ) -> Dict[str, torch.Tensor]:
    """`state` on the CPU, each tp block as a DTensor of its whole
    tensor."""
    out = {k: v.detach().cpu() for k, v in state.items()}
    if mesh is None or mesh.tp == 1:
        return out
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    tp_mesh = DeviceMesh.from_group(mesh.tp_group, "cpu")
    for k, v in out.items():
        dim = tp_dim(k)
        if dim is None:
            continue
        shape = list(v.shape)
        shape[dim] *= mesh.tp
        out[k] = DTensor.from_local(
            v.contiguous(), tp_mesh, [Shard(dim)], run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    return out


def _host_group():
    return distributed._session.host_group


def save_sharded(directory: str, step, state: Dict[str, torch.Tensor],
                 mesh=None) -> None:
    """Write `state` (this rank's tensors) under `directory/<step>`.
    Collective: every rank calls it."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(os.path.join(directory, str(step)))
    dcp.save(_described(state, mesh), checkpoint_id=path,
             process_group=_host_group())


def restore_sharded(directory: str, step: int,
                    state_like: Dict[str, torch.Tensor], mesh=None
                    ) -> Dict[str, torch.Tensor]:
    """The checkpoint at `directory/<step>` read into the layout of
    `state_like` (this rank's tensors: its tp blocks): new tensors on
    `state_like`'s devices. Collective: every rank calls it."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(os.path.join(directory, str(step)))
    target = _described({k: torch.empty_like(v)
                         for k, v in state_like.items()}, mesh)
    dcp.load(target, checkpoint_id=path, process_group=_host_group())
    out = {}
    for k, v in target.items():
        local = v.to_local() if hasattr(v, "to_local") else v
        out[k] = local.to(state_like[k].device)
    return out


class ShardedCheckpointManager:
    """Rolling sharded checkpoints with retention and best-step pinning,
    the mesh-aware counterpart of Runner.save_checkpoint/clean_up."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep, self.mesh = max_to_keep, mesh
        if distributed.is_primary():
            os.makedirs(self.directory, exist_ok=True)
        distributed.barrier("checkpoint directory")
        # step → metrics (None: saved without), in step order
        self._steps: Dict[int, Optional[dict]] = {}
        for name in sorted(os.listdir(self.directory),
                           key=lambda n: (len(n), n)):
            if name.isdigit():
                self._steps[int(name)] = self._read_metrics(int(name))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _read_metrics(self, step: int) -> Optional[dict]:
        path = os.path.join(self._path(step), METRICS_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def _ranked(self) -> List[int]:
        """The steps saved with metrics, the best last (ties: the later
        step last)."""
        return sorted((s for s in sorted(self._steps)
                       if self._steps[s] is not None),
                      key=lambda s: float(self._steps[s][BEST_METRIC]))

    def _kept(self) -> List[int]:
        """orbax's BestN."""
        steps = sorted(self._steps)
        n = self.max_to_keep
        if n is None or len(steps) <= n:
            return steps
        return sorted(self._ranked()[-n:]) if n else []

    def save(self, step: int, state: Dict[str, torch.Tensor],
             metrics: Optional[dict] = None) -> None:
        """Every rank writes its shards into a temporary directory; rank 0
        renames it to `<step>` and removes what the retention drops."""
        tmp = self._path(step) + TMP_SUFFIX
        if distributed.is_primary():
            shutil.rmtree(tmp, ignore_errors=True)
        distributed.barrier("checkpoint tmp clear")
        save_sharded(self.directory, f"{step}{TMP_SUFFIX}", state, self.mesh)
        distributed.barrier("checkpoint shards written")
        self._steps[step] = None if metrics is None else dict(metrics)
        if distributed.is_primary():
            if metrics is not None:
                with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                    json.dump(metrics, f)
            shutil.rmtree(self._path(step), ignore_errors=True)
            os.replace(tmp, self._path(step))
        keep = set(self._kept())
        for s in [s for s in self._steps if s not in keep]:
            del self._steps[s]
            if distributed.is_primary():
                shutil.rmtree(self._path(s), ignore_errors=True)
        distributed.barrier("checkpoint saved")

    def restore(self, step: int, state_like: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        return restore_sharded(self.directory, step, state_like, self.mesh)

    def latest_step(self) -> Optional[int]:
        return max(self._steps) if self._steps else None

    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    def all_steps(self) -> List[int]:
        return sorted(self._steps)
