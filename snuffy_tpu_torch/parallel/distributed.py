"""The torch.distributed bootstrap: one process per GPU, from torchrun's
environment.

The port of `snuffy_tpu/parallel/distributed.py`. The reference launches
its pretraining with torchrun and DDP (reference dino_adapter/utils.py:
473-513, mae_adapter/util/misc.py:217-249); the launch contract is
torchrun's environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT.

  * `initialize(backend=None, device=None)`: with WORLD_SIZE unset or 1
    and no backend named, nothing (one process, every path as without
    this module). Otherwise each rank owns a device, `cuda:LOCAL_RANK`
    unless the caller names one, and joins the default process group:
    NCCL for a CUDA device, gloo for the CPU, unless the caller names the
    backend. NCCL refuses two ranks on one device, and so does
    `initialize` (raising, naming both); gloo takes CUDA tensors for
    `all_reduce` and `broadcast`, so two ranks can share one card under
    gloo. A rank whose device is missing raises; nothing falls back.
  * the host group: a second group, always gloo, for the agreement on the
    host (step counts, epoch rows, per-bag outputs, barriers): NCCL takes
    only CUDA tensors, and gloo cannot all-gather CUDA ones. `barrier` and
    `host_allgather` run on it.
  * `is_primary` / `primary_only`: rank 0 alone writes checkpoints, logs
    and metrics (the reference's `save_on_master`).
  * `process_batch_slice`: the rows of a global batch that a rank owns
    (the DistributedSampler's role).
  * `shutdown` tears both groups down; `session` is `initialize` with the
    teardown on every exit path, and the CLIs run under it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import socket
from typing import Any, List, Optional, Union

import torch
import torch.distributed as dist

from snuffy_tpu_torch.parallel.mesh import MeshSpec, factor_devices

# The rank folds into seeds above this bit, so rank 0 (and one process)
# keeps the seeds it had without the bootstrap.
RANK_SEED_SHIFT = 32


class _Session:
    """What the bootstrap started in this process (torch.distributed's
    default group is process-wide too)."""

    host_group: Any = None
    device: Optional[torch.device] = None


_session = _Session()


def rank_device(device: Union[None, str, torch.device] = None
                ) -> torch.device:
    """The device a rank computes on: `device` (default "cuda") as given,
    except that an unindexed "cuda" names this rank's card: the
    bootstrap's device once it ran, else `cuda:LOCAL_RANK` where torchrun
    set LOCAL_RANK."""
    device = torch.device(device or "cuda")
    if device.type != "cuda" or device.index is not None:
        return device
    if _session.device is not None and _session.device.type == "cuda":
        return _session.device
    if os.environ.get("LOCAL_RANK"):
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def initialize(backend: Optional[str] = None,
               device: Union[None, str, torch.device] = None) -> bool:
    """Join the process group that torchrun's environment describes.

    Returns True when this call started the group (its caller then owns
    the teardown, `shutdown`), False when there is nothing to do: a group
    is already up, or WORLD_SIZE is unset or 1 and no `backend` is named.
    Naming a backend starts a group even of one rank."""
    if dist.is_initialized():
        return False
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world <= 1 and backend is None:
        return False
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
               if not os.environ.get(k)]
    if missing:
        raise RuntimeError(
            f"WORLD_SIZE={world} but {' and '.join(missing)} not set: "
            "torchrun sets the rendezvous address; a launch by hand sets "
            "MASTER_ADDR and MASTER_PORT (localhost and a free port on one "
            "host), RANK and LOCAL_RANK")
    rank = int(os.environ.get("RANK", "0") or 0)
    dev = rank_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", 0)
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {rank}: device {dev} but torch.cuda.is_available() "
                "is false")
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: device {dev} but this host has "
                f"{torch.cuda.device_count()} GPU(s)")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend nccl takes CUDA tensors only; rank {rank} "
                         f"computes on {dev}")
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        world_size=world, rank=rank)
    try:
        host = dist.new_group(backend="gloo")
        if backend == "nccl":
            where: List[Any] = [None] * world
            dist.all_gather_object(where, (socket.gethostname(), str(dev)),
                                   group=host)
            shared = [(r, w) for r, w in enumerate(where)
                      if where.count(w) > 1]
            if shared:
                raise ValueError(
                    f"backend nccl refuses two ranks on one device: ranks "
                    f"{[r for r, _ in shared]} share {shared[0][1][1]} on "
                    f"{shared[0][1][0]}; give each rank its own GPU, or name "
                    "backend gloo to share one")
    except BaseException:
        dist.destroy_process_group()
        raise
    _session.host_group, _session.device = host, dev
    return True


def shutdown() -> None:
    """Destroy the host group and the default group (every exit path of a
    run that `initialize` started)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _session.host_group, _session.device = None, None


@contextlib.contextmanager
def session(backend: Optional[str] = None,
            device: Union[None, str, torch.device] = None):
    """`initialize`, and `shutdown` on the way out when it started the
    group; a group started by the caller stays up."""
    started = initialize(backend, device)
    try:
        yield
    finally:
        if started:
            shutdown()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def default_group():
    """The default process group, or None without one."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank_seed(seed: int) -> int:
    """`seed` with this rank folded in: its own draws for each rank, the
    same seed on rank 0 and on one process."""
    return int(seed) + (rank() << RANK_SEED_SHIFT)


def is_primary() -> bool:
    """True on rank 0, the only process that writes checkpoints, metrics
    and logs (reference utils.is_main_process)."""
    return rank() == 0


def primary_only(fn):
    """Decorator: run `fn` on rank 0 only (reference save_on_master,
    dino_adapter/utils.py:466-471). Returns None elsewhere."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_primary():
            return fn(*args, **kwargs)
        return None

    return wrapper


def global_mesh_spec() -> MeshSpec:
    """Every rank's device in one (dcn=world, dp, sp, tp) factoring: one
    device a process, so dcn is the world and the rest 1."""
    return factor_devices(world_size(), world_size())


def process_batch_slice(global_batch: int,
                        process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> slice:
    """Rows [p·B/P, (p+1)·B/P) of a (global_batch, ...) array: block p of
    P (by default this rank's of the world; a mesh passes its batch-axis
    index and extent)."""
    p = rank() if process_index is None else process_index
    n = world_size() if process_count is None else process_count
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return slice(p * per, (p + 1) * per)


def barrier(name: str) -> None:
    """Wait on the host group until every rank reaches `name`; raises,
    naming the ranks that did not, at the group's timeout."""
    if world_size() < 2:
        return
    try:
        dist.monitored_barrier(group=_session.host_group,
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def host_allgather(obj: Any) -> list:
    """`obj` from every rank (picklable, on the host), in rank order."""
    if world_size() < 2:
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj, group=_session.host_group)
    return out


def host_allgather_tensor(t: torch.Tensor) -> List[torch.Tensor]:
    """A CPU copy of `t` from every rank, in rank order (the same shape on
    every rank), over the host group."""
    t = t.detach().cpu().contiguous()
    if world_size() < 2:
        return [t]
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t, group=_session.host_group)
    return out
