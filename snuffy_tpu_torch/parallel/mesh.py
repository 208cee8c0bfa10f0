"""The (dcn, dp, sp, tp) factoring of the devices, and the batch axes as
a process group.

The port's copy of `snuffy_tpu/parallel/mesh.py`: `MeshSpec`,
`factor_devices` and `validate_spec` are copies (held to the originals in
`tests/test_torch_copies.py`). `make_mesh` has no device array to lay out:
with one process per GPU, the batch axes ("dcn", "dp") are every rank,
and their collective is the default process group of
`parallel/distributed.py`; one process (no process group) has no mesh,
None, which every collective takes as the identity. Sequence (sp) and
tensor (tp) parallelism are Slice 7b: a spec with sp or tp above 1
raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class MeshSpec:
    """4-axis mesh factorization.

    dcn — outer data-parallel axis ACROSS hosts. Gradient all-reduces on
          this axis ride the data-center network; everything else must stay
          within a host's ICI domain, which is why dcn is outermost and
          device blocks are grouped by process in `make_mesh`.
    dp/sp/tp — within-host (ICI) axes, see module docstring.
    """

    dp: int = 1
    sp: int = 1
    tp: int = 1
    dcn: int = 1

    @property
    def n_devices(self) -> int:
        return self.dcn * self.dp * self.sp * self.tp


def factor_devices(n: int, num_processes: int = 1) -> MeshSpec:
    """Default factorization of n devices into (dcn=num_processes, dp, sp, tp).

    Preference order for the n/num_processes per-host devices: sequence
    parallel gets 2 (long bags), tensor parallel gets 2 when >=8 per host,
    and the remainder — any integer, not necessarily a power of two — goes
    to data parallel.
    """
    if n % num_processes:
        raise ValueError(
            f"{n} devices do not split evenly over {num_processes} processes"
        )
    local = n // num_processes
    if local <= 1:
        return MeshSpec(1, 1, 1, dcn=num_processes)
    sp = 2 if local % 2 == 0 else 1
    rem = local // sp
    tp = 2 if rem % 2 == 0 and rem > 2 else 1
    dp = local // (sp * tp)
    return MeshSpec(dp, sp, tp, dcn=num_processes)


def validate_spec(spec: MeshSpec, num_heads: Optional[int] = None,
                  mlp_hidden: Optional[int] = None) -> None:
    """Model-shape validation for tensor parallelism (Megatron rules shard
    heads over tp and the FFN hidden dim over tp)."""
    if num_heads is not None and num_heads % spec.tp:
        raise ValueError(f"tp={spec.tp} does not divide num_heads={num_heads}")
    if mlp_hidden is not None and mlp_hidden % spec.tp:
        raise ValueError(f"tp={spec.tp} does not divide FFN hidden={mlp_hidden}")


@dataclass(frozen=True)
class Mesh:
    """The batch axes of a dp mesh over `size` ranks: this process is
    `rank`, and `group` is their process group."""

    group: Any
    rank: int
    size: int


def make_mesh(spec: MeshSpec) -> Optional[Mesh]:
    """The mesh of `spec` over the ranks of the process group that
    `parallel.distributed.initialize` started; None in one process
    without a group. One process per device: spec.n_devices must be the
    world size."""
    from snuffy_tpu_torch.parallel import distributed

    if spec.sp > 1 or spec.tp > 1:
        raise NotImplementedError(
            f"{spec}: sequence (sp) and tensor (tp) parallelism are not "
            "ported yet (Slice 7b, ROADMAP.md Queue 1); the port's mesh is "
            "data-parallel, (dcn, dp) over the ranks")
    world = distributed.world_size()
    if spec.n_devices != world:
        raise ValueError(
            f"{spec} spans {spec.n_devices} devices; this run has {world} "
            "rank(s), one device each")
    group = distributed.default_group()
    if group is None:
        return None
    return Mesh(group, distributed.rank(), world)
