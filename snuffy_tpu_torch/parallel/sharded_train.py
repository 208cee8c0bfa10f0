"""MIL training over a mesh: a batch of bags split over the batch axes,
each bag's rows over sp and the encoder's weights over tp.

The port of `snuffy_tpu/parallel/sharded_train.py`. A batch of B bags
takes ONE optimizer step, as `SnuffyTrainer.packed_train_step` takes it
on one device.

Data parallel only (sp = tp = 1): every rank holds the same batch (the
Runner loads the same data everywhere) and `make_global_batch` keeps its
contiguous block of B/D bags (D = dcn·dp ranks), which runs through the
packed step (K1/K2 in segment mode, segments = B/D).

With sp or tp above 1 (`use_mesh=1`), each batch block's bags go through
the model one at a time (segments = 1), their gradients accumulated: the
JAX step vmaps here, and `bag_batch_impl='vmap'` is not ported, so a loop
is the port's form. `make_global_batch` also keeps the rank's N/sp rows
of each bag; the model holds the rank's blocks of the tp-sharded weights
(`TP_RULES`, `shard_module`).

Either way the loss is Σ(losses · bag_w) over the rank's bags divided by
the GLOBAL Σ bag_w (`global_bag_weight`), so a tail batch whose ranks hold
unequal real bags (zero-weight dummies, `sharded_train.py:219-220`) stays
exact; each gradient is summed over exactly the axes on which the rank's
share of it is partial (`partial_axes`): the batch axes always; sp for
what runs on the rank's rows (everything but wk, wo, the bag head and w,
which run on tensors every sp rank holds whole); tp for the whole biases
of wq, wk and wv, of which a rank uses its block. The clip comes after
the sums, over the whole gradient (`global_grad_norm`).
`fetch_batch_outputs` gathers the per-bag losses, scores and instance
scores to every rank over the host group, in batch order.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from snuffy_tpu_torch.parallel import distributed
from snuffy_tpu_torch.parallel.collectives import all_reduce_
from snuffy_tpu_torch.parallel.mesh import Mesh, MeshSpec, coordinates

# Megatron's column/row parallel rules for the Snuffy encoder (the JAX
# `_TP_RULES`, sharded_train.py:40-48), in torch's (out, in) layout: the
# dimension of each parameter that splits over tp. wq, wk, wv and ff.w1
# split by output feature (w1's bias too), wo and ff.w2 by input feature;
# everything else is whole on every rank.
TP_RULES = (
    ("self_attn.linears.0.weight", 0),
    ("self_attn.linears.1.weight", 0),
    ("self_attn.linears.2.weight", 0),
    ("self_attn.linears.3.weight", 1),
    ("feed_forward.w_1.weight", 0),
    ("feed_forward.w_1.bias", 0),
    ("feed_forward.w_2.weight", 1),
)
# Whole biases used in tp blocks: their gradient is partial over tp.
TP_PARTIAL = ("self_attn.linears.0.bias", "self_attn.linears.1.bias",
              "self_attn.linears.2.bias")
# Computed on tensors that every sp rank holds whole: their gradient is
# whole on every sp rank.
SP_WHOLE = ("self_attn.linears.1.", "self_attn.linears.3.",
            "b_classifier.linear.")


def tp_dim(name: str) -> Optional[int]:
    """The dimension of parameter `name` that splits over tp, or None."""
    for suffix, dim in TP_RULES:
        if name.endswith(suffix):
            return dim
    return None


def partial_axes(name: str, mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes over which this rank's gradient of `name` (a MILNet
    parameter, or "w") is a partial sum."""
    axes = ["batch"]
    if mesh.sp > 1 and name != "w" and not any(s in name for s in SP_WHOLE):
        axes.append("sp")
    if mesh.tp > 1 and name.endswith(TP_PARTIAL):
        axes.append("tp")
    return tuple(axes)


def _block(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    per = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.tp_rank * per, per)


def shard_state(state: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                ) -> Dict[str, torch.Tensor]:
    """A whole MILNet state dict → this rank's (its tp blocks)."""
    if mesh is None or mesh.tp == 1:
        return state
    out = {}
    for k, v in state.items():
        dim = tp_dim(k)
        out[k] = v if dim is None else _block(v, dim, mesh).clone()
    return out


@torch.no_grad()
def shard_module(model: torch.nn.Module, mesh: Mesh) -> None:
    """Each tp-split parameter of `model` replaced by this rank's block."""
    for name, p in list(model.named_parameters()):
        dim = tp_dim(name)
        if dim is None:
            continue
        mod = model.get_submodule(name.rsplit(".", 1)[0])
        setattr(mod, name.rsplit(".", 1)[1], torch.nn.Parameter(
            _block(p.data, dim, mesh).clone(), requires_grad=p.requires_grad))


@torch.no_grad()
def gather_state(state: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                 ) -> Dict[str, torch.Tensor]:
    """This rank's MILNet state dict (or gradients by the same names) →
    the whole one, on every rank: each tp block gathered over tp (the
    all-reduce of a zero-padded buffer). Every rank of a tp group calls
    it together."""
    if mesh is None or mesh.tp == 1:
        return dict(state)
    from snuffy_tpu_torch.parallel.collectives import gather

    return {k: v if tp_dim(k) is None else gather(
        v.detach(), mesh, "tp", "parameter", dim=tp_dim(k))
        for k, v in state.items()}


def make_global_batch(mesh: Mesh, feats_b, masks_b, labels_b, bag_w):
    """The batch every rank holds → this rank's block of B/D bags and,
    under sp, its N/sp rows of each."""
    bags = distributed.process_batch_slice(feats_b.shape[0], mesh.rank,
                                          mesh.size)
    feats_b, masks_b, labels_b, bag_w = (
        a[bags] for a in (feats_b, masks_b, labels_b, bag_w))
    if mesh.sp > 1:
        n = feats_b.shape[1]
        if n % mesh.sp:
            raise ValueError(f"bags of {n} rows do not split over "
                             f"sp={mesh.sp}")
        per = n // mesh.sp
        rows = slice(mesh.sp_rank * per, (mesh.sp_rank + 1) * per)
        feats_b, masks_b = feats_b[:, rows], masks_b[:, rows]
    return feats_b, masks_b, labels_b, bag_w


def global_bag_weight(bag_w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ bag_w over every rank's bags (one all-reduce of a scalar over
    the batch axes)."""
    return all_reduce_(bag_w.sum(), mesh, "batch", "bag weight")


@torch.no_grad()
def sum_gradients(params: List[torch.Tensor], names: List[str],
                  mesh: Mesh) -> None:
    """Each parameter's .grad summed, in place, over the axes on which it
    is partial (`partial_axes`; `names` name the parameters, the
    MILNet's and "w"): one flat all-reduce an axis for the parameters
    that share their axes, the same bits on every rank that holds them."""
    groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for name, p in zip(names, params):
        if p.grad is not None:
            groups.setdefault(partial_axes(name, mesh), []).append(p.grad)
    for axes in sorted(groups):
        grads = groups[axes]
        flat = torch.cat([g.reshape(-1) for g in grads])
        for axis in axes:
            all_reduce_(flat, mesh, axis, "gradients")
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def global_grad_norm(named: Iterable[Tuple[str, torch.Tensor]],
                     mesh: Optional[Mesh]) -> torch.Tensor:
    """‖g‖ over the whole model: a tp block's squares summed over tp, a
    whole parameter's counted once."""
    whole, split = [], []
    for name, g in named:
        if g is None:
            continue
        s = g.float().pow(2).sum()
        (split if mesh is not None and mesh.tp > 1
         and tp_dim(name) is not None else whole).append(s)
    total = torch.stack(whole).sum()
    if split:
        total = total + all_reduce_(torch.stack(split).sum(), mesh, "tp",
                                    "gradient norm")
    return total.sqrt()


def fetch_batch_outputs(mesh: Mesh, *tensors: torch.Tensor):
    """Each rank's per-bag outputs (its block of the batch; under sp the
    last, the instance scores, of its rows) → the whole batch's, on the
    CPU, on every rank: each batch block from the tp-rank-0 ranks of its
    sp line, the rows in sp order."""
    spec = MeshSpec(mesh.size, mesh.sp, mesh.tp)
    # ranks in batch, then sp order, each tp line's first
    firsts = sorted((coordinates(r, spec)[:2], r)
                    for r in range(spec.n_devices)
                    if coordinates(r, spec)[2] == 0)
    out = []
    for i, t in enumerate(tensors):
        parts = distributed.host_allgather_tensor(t)
        blocks = [[parts[r] for (b, _), r in firsts if b == block]
                  for block in range(mesh.size)]
        # per-bag outputs: one copy a block; instance scores: rows over sp
        out.append(torch.cat([torch.cat(rows, dim=1)
                              if i == len(tensors) - 1 else rows[0]
                              for rows in blocks]))
    return tuple(out)


def make_sharded_batch_train_step(trainer, mesh: Mesh):
    """(feats (B, N, D), masks (B, N), labels (B, C), bag_w (B,),
    generator, seed_generator) → (losses (B,), scores (B, C), ins_scores
    (B, N, C)) on the CPU: one optimizer step of `trainer` (its mesh is
    `mesh`) over the batch split across the ranks."""
    if trainer.mesh is not mesh:
        raise ValueError("the trainer steps over another mesh")
    step_fn = (trainer.packed_train_step if mesh.sp == 1 and mesh.tp == 1
               else trainer.bag_loop_train_step)

    def step(feats_b, masks_b, labels_b, bag_w, generator, seed_generator):
        local = make_global_batch(mesh, feats_b, masks_b, labels_b, bag_w)
        out = step_fn(*local, generator, seed_generator)
        return fetch_batch_outputs(mesh, *out)

    return step
