"""Joining a multi-process job (counterpart of
maavss_tpu/parallel/distributed.py).

One process per rank, as `torchrun --nproc_per_node N` starts them:
`initialize()` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and joins the process group, NCCL
for a card and gloo for the CPU; without WORLD_SIZE it does nothing and
the process runs alone, as it always did. Each rank's device is
`cuda:LOCAL_RANK` unless the caller asks for the CPU. On a card, rank 0
builds the kernels (ops/_build.py) while the others wait at a barrier,
then they load that build: no two ranks run nvcc at once.

`process_batch_slice` and `host_local_to_global` are the JAX functions'
counterparts: the rows of the global batch this rank's data index reads
(`mesh.rank_rows`, the one rule that cuts rows, interleaved under
--microbatch), and the global batch assembled from every rank's local
rows.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from maavss_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, current, rank_rows


def rank_device(device: Optional[str] = None) -> torch.device:
    """This rank's device: `device` when given ('cpu', or a card such as
    'cuda:0'), else cuda:LOCAL_RANK (cuda:0 outside a job)."""
    if device is not None and device not in ("cuda", "auto"):
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def initialize(device: Optional[str] = None,
               backend: Optional[str] = None) -> Optional[torch.device]:
    """Join torchrun's process group; returns this rank's device, or None
    (and does nothing) without WORLD_SIZE in the environment. The backend
    is NCCL for a card and gloo for the CPU unless `backend` says
    otherwise. An initialised group is left as it is."""
    if "WORLD_SIZE" not in os.environ:
        return None
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", "29500")
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}:{port}",
            world_size=int(os.environ["WORLD_SIZE"]),
            rank=int(os.environ["RANK"]))
    if dev.type == "cuda":
        rank_zero_first(_build_kernels)
    return dev


def _build_kernels() -> None:
    from maavss_tpu_torch.ops import _build

    _build.build()


def rank_zero_first(fn):
    """fn() on rank 0, a barrier, then fn() on the other ranks (what rank 0
    made on disk, they then find: the kernels' build, a synthetic store).
    Returns fn()'s result on every rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return fn()
    out = fn() if dist.get_rank() == 0 else None
    dist.barrier()
    return out if dist.get_rank() == 0 else fn()


def is_main() -> bool:
    """Rank 0, or a process without a group: the one that writes metrics,
    checkpoints and saved models."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Every rank waits for the others (nothing without a group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def process_batch_slice(global_batch: int, microbatch: int = 1,
                        mesh: Optional[Mesh] = None) -> np.ndarray:
    """The global rows this rank's data index reads, in order: the rows
    `mesh.shard_batch` gives it (`rank_rows`: under --microbatch its share
    of each global chunk). No mesh: every row."""
    mesh = mesh if mesh is not None else current()
    if mesh is None:
        return np.arange(global_batch)
    return rank_rows(global_batch, mesh.data, mesh.d, microbatch)


def host_local_to_global(batch: Mapping[str, Any],
                         mesh: Optional[Mesh] = None) -> dict:
    """The global batch from every rank's local rows (numpy or tensors,
    axis 0): the data group's rows joined in data-index order, on every
    rank, as tensors on the leaves' devices."""
    from maavss_tpu_torch.parallel.collectives import gather

    mesh = mesh if mesh is not None else current()
    out = {}
    for key, x in batch.items():
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        if mesh is None or mesh.data == 1:
            out[key] = t
            continue
        parts = gather(t.contiguous(), mesh, DATA_AXIS)
        out[key] = torch.cat(list(parts.unbind(0)), dim=0)
    return out
