"""The (data, model) layout of a job's ranks, the tensor-parallel shape rule,
and state and batch sharding (counterpart of maavss_tpu/parallel/mesh.py).

One process per rank; world = data x model. Rank r sits at (d, m) =
(r // model, r % model), the order of the JAX package's
`make_mesh`'s `reshape(data, model)`: a model group is `model` contiguous
ranks, which see the same batch rows; a data group is the ranks of one
model index m, which hold the same shards. The semantics are GSPMD's:
the global batch computes what one process would (global-batch BatchNorm
statistics, one phasegram max over the whole batch, a global mean loss,
gradients averaged over the data group), each split leaf lives on its
model group in `model` contiguous pieces, and every other leaf is
replicated.

`make_mesh` makes the mesh the current one (`current()`), which the
layers, kernels and steps read; a process without a process group has no
mesh and runs as it always did. The shape rule, `model_shard_dim`, is the
JAX package's `_leaf_model_sharding` on the port's layouts: a 2-D leaf
whose flax last axis divides by `model` and is at least 128 is split on
that axis, which is dim 0 of an `nn.Linear.weight` ([out, in], flax's
kernel transposed) and dim 1 of the recurrent cells' `w_i` and `w_h`
(kept in flax's [D, 4H] and [H, 4H]). Adam's moments mirror their leaf.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the rule's smallest split axis (maavss_tpu/parallel/mesh.py:84)
MIN_SPLIT = 128
# the leaves kept in flax's layout: the split axis is torch's dim 1
_FLAX_LAYOUT = ("w_i", "w_h")

_CURRENT = [None]


class Mesh:
    """The ranks as a (data, model) grid and this rank's two groups.

    `data_group` / `model_group`: the process groups of this rank's data
    and model groups (None where the group has one rank), and this rank's
    index in each (`d`, `m`)."""

    def __init__(self, data: int, model: int, rank: int, groups):
        self.data, self.model, self.rank = data, model, rank
        self.d, self.m = rank // model, rank % model
        self.data_group, self.model_group = groups
        self.backend = dist.get_backend() if dist.is_initialized() else None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def group(self, axis: str):
        return self.data_group if axis == DATA_AXIS else self.model_group

    def size(self, axis: str) -> int:
        return self.data if axis == DATA_AXIS else self.model

    def index(self, axis: str) -> int:
        return self.d if axis == DATA_AXIS else self.m

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank="
                f"{self.rank}, backend={self.backend})")


def current() -> Optional[Mesh]:
    """The mesh `make_mesh` made current, or None (one process, no
    group)."""
    return _CURRENT[0]


def data_size() -> int:
    """The current mesh's data ranks (1 without a mesh)."""
    mesh = current()
    return 1 if mesh is None else mesh.data


def model_size() -> int:
    """The current mesh's model ranks (1 without a mesh)."""
    mesh = current()
    return 1 if mesh is None else mesh.model


def data_slot():
    """(the current mesh, its data ranks, this rank's data index): the
    slots of a gathered partial-sum buffer and the one this rank fills
    ((None, 1, 0) without a mesh)."""
    mesh = current()
    if mesh is None:
        return None, 1, 0
    return mesh, mesh.data, mesh.d


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """`mesh` current inside, the previous one restored after."""
    before = _CURRENT[0]
    _CURRENT[0] = mesh
    try:
        yield mesh
    finally:
        _CURRENT[0] = before


def resolve_shape(data: int, model: int, world: int) -> Tuple[int, int]:
    """(data, model) for a world of `world` ranks: data -1 takes every rank
    over `model`; a product other than the world raises."""
    if model < 1:
        raise ValueError(f"--mesh_model must be >= 1, got {model}")
    if data == -1:
        if world % model:
            raise ValueError(
                f"--mesh_model {model} does not divide the world: the world "
                f"has {world} ranks; start one process a rank (torchrun "
                f"--nproc_per_node N) or change --mesh_data / --mesh_model")
        data = world // model
    if data < 1 or data * model != world:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} ranks, the world has "
            f"{world}: start one process a rank (torchrun --nproc_per_node "
            f"{data * model}) or change --mesh_data / --mesh_model")
    return data, model


def make_mesh(data: int = -1, model: int = 1,
              set_current: bool = True) -> Optional[Mesh]:
    """The (data, model) mesh over the job's world, made current. Without a
    process group the world is this one process: (1, 1) gives None (no
    mesh: the process runs as it always did) and anything else raises.
    Every rank must call it: the groups are created collectively, in one
    order (the data groups, then the model groups)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    data, model = resolve_shape(data, model, world)
    if not dist.is_initialized():
        mesh = None
    else:
        rank = dist.get_rank()
        d, m = rank // model, rank % model
        groups = [None, None]
        for m_ in range(model):
            ranks = [d_ * model + m_ for d_ in range(data)]
            g = dist.new_group(ranks) if data > 1 else None
            if m_ == m:
                groups[0] = g
        for d_ in range(data):
            ranks = [d_ * model + m_ for m_ in range(model)]
            g = dist.new_group(ranks) if model > 1 else None
            if d_ == d:
                groups[1] = g
        if world == 1:
            # a world of one: the collectives still run, over the world
            groups = [dist.group.WORLD, None]
        mesh = Mesh(data, model, rank, tuple(groups))
    if set_current:
        _CURRENT[0] = mesh
    return mesh


# --------------------------------------------------------------- the rule


def model_shard_dim(name: str, shape: Sequence[int],
                    model: int) -> Optional[int]:
    """The torch dim along which the leaf `name` of `shape` is split over
    `model` ranks, or None (replicated): the JAX package's
    `_leaf_model_sharding` (a 2-D leaf whose flax last axis divides by
    `model` and is at least MIN_SPLIT), on the port's layouts."""
    if model <= 1 or len(shape) != 2:
        return None
    dim = 1 if name.rsplit(".", 1)[-1] in _FLAX_LAYOUT else 0
    size = shape[dim]
    return dim if size % model == 0 and size >= MIN_SPLIT else None


def split_leaves(model: torch.nn.Module, n_model: int) -> Dict[str, int]:
    """{parameter name: split dim} of every leaf the rule splits over
    `n_model` ranks, from the full (unsharded) module."""
    out = {}
    for name, p in model.named_parameters():
        dim = model_shard_dim(name, tuple(p.shape), n_model)
        if dim is not None:
            out[name] = dim
    return out


def shard_of(full: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous piece of `full` along `dim` (a copy)."""
    return full.chunk(mesh.model, dim=dim)[mesh.m].contiguous().clone()


def _owner(model: torch.nn.Module, name: str):
    path, leaf = name.rsplit(".", 1)
    return model.get_submodule(path), leaf


def tp_dim(module: torch.nn.Module, leaf: str) -> Optional[int]:
    """The split dim of `module.<leaf>` when it holds this rank's shard,
    else None."""
    return getattr(module, "_tp_dims", {}).get(leaf)


@torch.no_grad()
def shard_model(mesh: Optional[Mesh], model: torch.nn.Module
                ) -> Dict[str, int]:
    """Replace every split leaf of `model` by this rank's shard, in place
    (before the optimizer is made, so its moments take the shards'
    shapes), and mark its module (`tp_dim`). Returns {name: dim}. No mesh,
    or one model rank: nothing changes."""
    if mesh is None or mesh.model == 1:
        return {}
    split = split_leaves(model, mesh.model)
    for name, dim in split.items():
        owner, leaf = _owner(model, name)
        p = getattr(owner, leaf)
        p.data = shard_of(p.data, dim, mesh)
        dims = dict(getattr(owner, "_tp_dims", {}))
        dims[leaf] = dim
        owner._tp_dims = dims
    model._tp_split = dict(split)
    return split


def model_split(model: torch.nn.Module) -> Dict[str, int]:
    """{name: dim} of the leaves `shard_model` split (empty if none)."""
    return dict(getattr(model, "_tp_split", {}))


def shard_state(mesh: Optional[Mesh], state):
    """A train state made from the full leaves -> this rank's shards, in
    place: the split parameters and their Adam moments (full -> shards).
    The optimizer must not have stepped yet on the card (K3's leaf table
    holds the old addresses). Returns (state, {name: dim})."""
    if mesh is None or mesh.model == 1:
        return state, {}
    tx = state.tx
    if getattr(tx, "_table", None) is not None:
        raise RuntimeError("shard_state: the optimizer has already built its "
                           "kernel table; shard before the first step")
    names = [n for n, _ in state.model.named_parameters()]
    split = split_leaves(state.model, mesh.model)
    for col in (tx.m, tx.v):
        for i, name in enumerate(names):
            if name in split and col[i] is not None:
                col[i] = shard_of(col[i], split[name], mesh)
    shard_model(mesh, state.model)
    return state, split


def gather_leaf(mesh: Mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The full leaf from this rank's shard `t`: the model group's pieces
    joined along `dim` in rank order."""
    from maavss_tpu_torch.parallel.collectives import gather

    parts = gather(t.detach(), mesh, MODEL_AXIS)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def gather_named(mesh: Optional[Mesh], model: torch.nn.Module,
                 tensors: Mapping[str, Optional[torch.Tensor]]
                 ) -> Dict[str, Optional[torch.Tensor]]:
    """{name: tensor} with every split leaf's shard (a parameter or its
    moment) replaced by the full leaf. Every rank of the model group must
    call it."""
    split = model_split(model)
    if mesh is None or not split:
        return dict(tensors)
    return {k: (gather_leaf(mesh, t, split[k])
                if t is not None and k in split else t)
            for k, t in tensors.items()}


# --------------------------------------------------------------- batches


def row_runs(batch: int, data: int, d: int, microbatch: int = 1):
    """The global rows of data index d among `data`, as slices: its
    contiguous share of each of the `microbatch` global chunks
    [c*B/mb, (c+1)*B/mb), chunk after chunk, so that the step's local
    chunking (contiguous B/(data*mb) rows) gives rank d its share of the
    JAX step's global chunk c (maavss_tpu/train/steps.py:364-397)."""
    mb = max(1, int(microbatch))
    if batch % (data * mb):
        raise ValueError(f"batch {batch} is not divisible by data "
                         f"{data} x microbatch {mb}")
    per = batch // (data * mb)
    return [slice(c * data * per + d * per, c * data * per + (d + 1) * per)
            for c in range(mb)]


def rank_rows(batch: int, data: int, d: int, microbatch: int = 1):
    """`row_runs` as one index array."""
    return np.concatenate([np.arange(r.start, r.stop)
                           for r in row_runs(batch, data, d, microbatch)])


def shard_batch(batch: Mapping, stacked: bool = False, microbatch: int = 1,
                mesh: Optional[Mesh] = None) -> Dict:
    """This rank's rows of a global batch (numpy arrays or tensors; the
    counterpart of the JAX `shard_batch`'s device_put): the batch axis,
    axis 1 when `stacked` ([K, B, ...], --steps_per_dispatch), is cut by
    `rank_rows`; a leaf whose batch axis does not divide stays whole
    (replicated), as in the JAX package. No mesh: the batch as it is."""
    mesh = mesh if mesh is not None else current()
    if mesh is None or mesh.data == 1:
        return dict(batch)
    axis = 1 if stacked else 0
    out = {}
    for key, x in batch.items():
        if x.ndim <= axis or x.shape[axis] % (mesh.data
                                              * max(1, microbatch)):
            out[key] = x
            continue
        rows = rank_rows(x.shape[axis], mesh.data, mesh.d, microbatch)
        if isinstance(x, torch.Tensor):
            out[key] = x.index_select(axis, torch.as_tensor(
                rows, device=x.device)).contiguous()
        else:
            out[key] = np.ascontiguousarray(np.take(np.asarray(x), rows,
                                                    axis=axis))
    return out


def global_rows(local_batch: int, microbatch: int = 1):
    """(global batch, this rank's rows of it as a list of slices, the runs
    of `rank_rows`) for a local batch of `local_batch` rows under the
    current mesh, or None without one (or with one data rank): what a
    per-row draw over the global batch (the step's noise) takes its rows
    by. Slices, not an index tensor: taking them copies nothing from the
    host, so a CUDA graph can capture it."""
    mesh = current()
    if mesh is None or mesh.data == 1:
        return None
    b = local_batch * mesh.data
    return b, row_runs(b, mesh.data, mesh.d, microbatch)
