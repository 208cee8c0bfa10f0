"""The (dcn, dp, sp, tp) factoring of the devices, and its axes as
process groups.

The port's copy of `snuffy_tpu/parallel/mesh.py`: `MeshSpec`,
`factor_devices` and `validate_spec` are copies (held to the originals in
`tests/test_torch_copies.py`). With one process per GPU the mesh is a
layout of the ranks: `make_mesh` lays them out as the JAX package lays
its devices out, `reshape(dcn, dp, sp, tp)` row-major, so a rank's
coordinates are

    batch = rank // (sp·tp)     (the dcn and dp axes together)
    sp    = (rank // tp) % sp
    tp    = rank % tp

and gives each axis a process group (on the default group's backend).
The batch axes' group is `group`, this rank's batch index `rank` and their
extent `size`, the names the data-parallel code reads. A mesh of the
batch axes alone (sp = tp = 1) takes the default process group for them,
as it did before sp and tp were ported; one process (no process group)
has no mesh, None, which every collective takes as the identity.
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


AXIS_NAMES = ("batch", "sp", "tp")


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a mesh: `group` is the process group of the
    batch axes (dcn × dp), `rank` this rank's index along them and `size`
    their extent; `sp_group`/`sp_rank`/`sp` and `tp_group`/`tp_rank`/`tp`
    likewise for sequence and tensor parallelism."""

    group: Any
    rank: int
    size: int
    sp_group: Any = None
    sp_rank: int = 0
    sp: int = 1
    tp_group: Any = None
    tp_rank: int = 0
    tp: int = 1

    def axis(self, name: str):
        """(group, extent, this rank's index) of axis "batch", "sp" or
        "tp"."""
        if name == "batch":
            return self.group, self.size, self.rank
        if name == "sp":
            return self.sp_group, self.sp, self.sp_rank
        if name == "tp":
            return self.tp_group, self.tp, self.tp_rank
        raise ValueError(f"no mesh axis {name!r}; axes {AXIS_NAMES}")


def coordinates(rank: int, spec: MeshSpec):
    """(batch index, sp index, tp index) of `rank` in the row-major
    (dcn, dp, sp, tp) layout."""
    return rank // (spec.sp * spec.tp), (rank // spec.tp) % spec.sp, \
        rank % spec.tp


def make_mesh(spec: MeshSpec, num_heads: Optional[int] = None,
              mlp_hidden: Optional[int] = None) -> Optional[Mesh]:
    """The mesh of `spec` over the ranks of the process group that
    `parallel.distributed.initialize` started; None in one process
    without a group. One process per device: spec.n_devices must be the
    world size. Every rank must call it, in the same order (each axis's
    groups are made by `dist.new_group`, which every rank joins)."""
    import torch.distributed as dist

    from snuffy_tpu_torch.parallel import distributed

    validate_spec(spec, num_heads, mlp_hidden)
    world = distributed.world_size()
    if spec.n_devices != world:
        raise ValueError(
            f"{spec} spans {spec.n_devices} devices; this run has {world} "
            "rank(s), one device each")
    group = distributed.default_group()
    if group is None:
        return None
    rank = distributed.rank()
    if spec.sp == 1 and spec.tp == 1:
        return Mesh(group, rank, world)
    batch = spec.dcn * spec.dp
    backend = dist.get_backend()
    coords = [coordinates(r, spec) for r in range(world)]

    def groups_along(axis: int):
        """One group for each line of ranks along `axis` (0 batch, 1 sp,
        2 tp); → this rank's."""
        mine, lines = None, {}
        for r, c in enumerate(coords):
            lines.setdefault(c[:axis] + c[axis + 1:], []).append(r)
        for key in sorted(lines):
            g = dist.new_group(lines[key], backend=backend)
            if rank in lines[key]:
                mine = g
        return mine

    b, s, t = coords[rank]
    return Mesh(groups_along(0), b, batch, groups_along(1), s, spec.sp,
                groups_along(2), t, spec.tp)
