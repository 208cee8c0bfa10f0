"""The collectives of sequence (sp) and tensor (tp) parallelism, every one
an all-reduce, and the audit that counts what crosses them.

gloo takes CUDA tensors for `all_reduce` and `broadcast` only (two ranks
sharing one card run over gloo: NCCL refuses two ranks on one device), so
the sp/tp ops are all-reduces, as the JAX package's shard_map ops are
psums: an all-gather is the all-reduce of a zero-padded buffer. The same
code then runs over gloo and over NCCL.

Megatron's conjugate pair carries the gradients across an axis:

  * `copy_to` (identity forward, all-reduce backward): where a tensor
    that every rank of the axis holds whole enters rank-local work (the
    rank's rows under sp, its heads or FFN columns under tp), each rank's
    backward sees only its own work's share of the gradient;
  * `reduce_from` (all-reduce forward, identity backward): where the
    ranks' partials become one tensor that each of them holds whole, the
    work after it is the same on every rank, and so is its gradient.

A bf16 or f16 tensor is summed in f32 (gloo's low-precision sums are not
guaranteed, and one rounding is kept to the end).

`audit()` records each all-reduce made inside it: the axis, what it
carried, the shape and element count, and (timed) the seconds with the
device synchronised around it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

_records: Optional[List[Dict]] = None
_timed = False


@contextlib.contextmanager
def audit(timed: bool = False):
    """Inside it, every all-reduce of this module appends {"axis", "what",
    "shape", "numel", "bytes"} (and "s" when `timed`) to the yielded
    list."""
    global _records, _timed
    before = (_records, _timed)
    _records, _timed = [], timed
    try:
        yield _records
    finally:
        _records, _timed = before


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def all_reduce_(t: torch.Tensor, mesh, axis: str, what: str) -> torch.Tensor:
    """`t` summed in place over `axis` of `mesh` ("batch", "sp", "tp");
    nothing over an axis of one rank."""
    group, size, _ = mesh.axis(axis)
    if size <= 1:
        return t
    rec = None
    if _records is not None:
        rec = {"axis": axis, "what": what, "shape": list(t.shape),
               "numel": t.numel(), "bytes": t.numel() * t.element_size()}
        _records.append(rec)
        if _timed:
            _sync(t)
            t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    if rec is not None and _timed:
        _sync(t)
        rec["s"] = time.perf_counter() - t0
    return t


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` to sum: f32 for bf16 and f16."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t.clone()


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, what):
        ctx.dtype = x.dtype
        return all_reduce_(_wide(x), mesh, axis, what)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, what):
        ctx.mesh, ctx.axis, ctx.what = mesh, axis, what
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = all_reduce_(_wide(g), ctx.mesh, ctx.axis,
                          ctx.what + " grad").to(g.dtype)
        return out, None, None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, what):
        ctx.mesh, ctx.axis, ctx.what = mesh, axis, what
        return all_reduce_(x.clone(), mesh, axis, what)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce_(g.clone(), ctx.mesh, ctx.axis,
                            ctx.what + " grad"), None, None, None)


def sum_over(x: torch.Tensor, mesh, axis: str, what: str) -> torch.Tensor:
    """The sum over `axis` of the ranks' `x`, its gradient summed too:
    where every rank's own loss reads the sum (a BatchNorm's statistics
    over the ranks' rows), each rank's gradient of it is a partial."""
    if mesh is None or mesh.axis(axis)[1] <= 1:
        return x
    return _SumOver.apply(x, mesh, axis, what)


def reduce_from(x: torch.Tensor, mesh, axis: str, what: str
                ) -> torch.Tensor:
    """The sum over `axis` of the ranks' partial `x` (f32 where x is bf16
    or f16), its gradient passed through whole."""
    if mesh is None or mesh.axis(axis)[1] <= 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis, what)


def copy_to(x: torch.Tensor, mesh, axis: str, what: str) -> torch.Tensor:
    """`x` as it is, its gradient summed over `axis`."""
    if mesh is None or mesh.axis(axis)[1] <= 1:
        return x
    return _CopyTo.apply(x, mesh, axis, what)


@torch.no_grad()
def gather(x: torch.Tensor, mesh, axis: str, what: str, dim: int = 0
           ) -> torch.Tensor:
    """The ranks' `x` (one shape on every rank of `axis`) concatenated
    along `dim` in axis order: the all-reduce of a zero-padded buffer. No
    gradient."""
    if mesh is None:
        return x
    _, size, index = mesh.axis(axis)
    if size <= 1:
        return x
    wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    if wide.dtype == torch.bool:
        wide = wide.to(torch.uint8)
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * size
    buf = wide.new_zeros(shape)
    buf.narrow(dim, index * n, n).copy_(wide)
    return all_reduce_(buf, mesh, axis, what).to(x.dtype)
