"""The collectives the layers, kernels and steps call under a mesh
(port-only: in the JAX package GSPMD inserts them).

Every collective is an `all_reduce` (SUM): gloo takes only `all_reduce`
and `broadcast` for CUDA tensors, so two ranks on one card run the data-
parallel path over gloo, and the same code runs over NCCL and on the
CPU. A gather is the sum of a zeroed [n, ...] buffer into which each rank
wrote its slot, which is exact (x + 0 = x): every rank gets every rank's
bits.

- `gather(t, mesh, axis)` -> [n, ...], rank order;
- `combine(t, mesh, axis)`: the fixed-order combine, the gather summed in
  rank order, so a statistic does not depend on the backend's reduction
  order and every rank gets the same bits;
- `all_max(t, mesh, axis)`: the gather's max;
- `data_sum(t)`: autograd-aware `combine` over the data group (backward:
  the gradient combined the same way), BatchNorm's global sums;
- `copy_to_model(x)` / `gather_from_model(y, dim)`: the column-parallel
  pair over the model group: identity forward with the input gradient
  summed over the group backward, and the pieces joined along `dim`
  forward with this rank's slice backward;
- `allreduce_grads_(model, mesh)`: every gradient averaged over the data
  group, one all_reduce a dtype.

Outside a mesh (or over a group of one rank) each is the identity.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from maavss_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    current,
)


def _wire_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32 for bfloat16 and float16 (an exact upcast: gloo's reductions
    do not take every half type), else t's own dtype."""
    return torch.float32 if t.dtype in (torch.bfloat16,
                                        torch.float16) else t.dtype


def _reduce(buf: torch.Tensor, mesh: Mesh, axis: str) -> None:
    group = mesh.group(axis)
    if group is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)


def gather(t: torch.Tensor, mesh: Optional[Mesh] = None,
           axis: str = DATA_AXIS) -> torch.Tensor:
    """[n, *t.shape]: slot i holds the tensor of the group's rank i (its
    index on `axis`), the same on every rank; t's dtype."""
    mesh = mesh if mesh is not None else current()
    if mesh is None or (mesh.size(axis) == 1
                        and mesh.group(axis) is None):
        return t.unsqueeze(0)
    n = mesh.size(axis)
    buf = torch.zeros((n,) + tuple(t.shape), dtype=_wire_dtype(t),
                      device=t.device)
    buf[mesh.index(axis)].copy_(t)
    _reduce(buf, mesh, axis)
    return buf.to(t.dtype)


def combine(t: torch.Tensor, mesh: Optional[Mesh] = None,
            axis: str = DATA_AXIS) -> torch.Tensor:
    """The group's tensors summed in rank order: ((t0 + t1) + t2) + ..."""
    parts = gather(t, mesh, axis)
    out = parts[0]
    for i in range(1, parts.shape[0]):
        out = out + parts[i]
    return out


def all_max(t: torch.Tensor, mesh: Optional[Mesh] = None,
            axis: str = DATA_AXIS) -> torch.Tensor:
    """The elementwise max over the group."""
    parts = gather(t, mesh, axis)
    return parts[0] if parts.shape[0] == 1 else parts.amax(dim=0)


def all_sum_(t: torch.Tensor, mesh: Optional[Mesh] = None,
             axis: str = DATA_AXIS) -> torch.Tensor:
    """In-place all_reduce SUM over the group (the backend's order)."""
    mesh = mesh if mesh is not None else current()
    if mesh is not None:
        _reduce(t, mesh, axis)
    return t


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return combine(t, axis=DATA_AXIS)

    @staticmethod
    def backward(ctx, g):
        return combine(g.contiguous(), axis=DATA_AXIS)


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """Differentiable fixed-order sum over the data group: the gradient of
    a shared sum is every rank's gradient of it, summed the same way."""
    return _DataSum.apply(t)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return combine(g.contiguous(), axis=MODEL_AXIS)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim):
        ctx.dim = dim
        mesh = current()
        ctx.m, ctx.size = mesh.m, y.shape[dim]
        parts = gather(y.contiguous(), mesh, MODEL_AXIS)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.m * ctx.size, ctx.size), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: identity forward; backward,
    the input gradient summed over the model group."""
    if current() is None or current().model == 1:
        return x
    return _CopyToModel.apply(x)


def gather_from_model(y: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's pieces of `y` joined along `dim` in rank order;
    backward, this rank's slice of the gradient (every rank of the group
    holds the same downstream gradient)."""
    if current() is None or current().model == 1:
        return y
    return _GatherFromModel.apply(y, dim)


@torch.no_grad()
def allreduce_grads_(params, mesh: Optional[Mesh] = None) -> None:
    """Every `.grad` of `params` averaged over the data group, in place:
    one all_reduce of a flat buffer a dtype, then / data. A gradient that
    is None stays None (a leaf the step never reaches has a zero gradient
    on every rank)."""
    mesh = mesh if mesh is not None else current()
    if mesh is None or mesh.data_group is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        wire = flat if flat.dtype == _wire_dtype(flat) else flat.float()
        _reduce(wire, mesh, DATA_AXIS)
        if mesh.data > 1:
            wire.div_(mesh.data)
        off = 0
        for g in grads:
            n = g.numel()
            g.copy_(wire[off:off + n].view_as(g))
            off += n


def mean_over_data(t: torch.Tensor) -> torch.Tensor:
    """A per-rank mean (a loss over the rank's rows) -> the global mean:
    the data group's values combined in rank order, / data."""
    mesh = current()
    if mesh is None or mesh.data == 1:
        return t
    return combine(t, mesh, DATA_AXIS) / mesh.data
