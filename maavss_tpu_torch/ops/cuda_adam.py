"""Fused Adam update: the hand-written CUDA kernel (`csrc/adam.cu`) and its
plain PyTorch version.

Counterpart of maavss_tpu/ops/pallas_adam.py:adam_leaf_update. The formula,
in this order, fp32:

    m' = b1 * m + (1 - b1) * g
    v' = b2 * v + (1 - b2) * g^2
    p' = p - lr * (m' / c1) / (sqrt(v' / c2) + eps)

with the bias corrections c1 = 1 - b1^count, c2 = 1 - b2^count taken by the
caller after the count increment. Both versions update m, v and p in place.

The optimizer keeps count and the step's [c1, c2, lr] as fp32 tensors on
the leaves' device and advances them with torch ops that a CUDA graph
captures (`device_bias_corrections`, and a schedule's rate from the count,
train/state.py), so a replayed step reads its own step's corrections and
rate; `bias_corrections` is the same formula on the host, for the tests.

`adam_multi_tensor` runs every leaf in ONE launch on CUDA tensors, from an
`AdamTable` (device tables of the leaves' pointers, sizes and block map,
built once: the parameters and moments never move); the kernel reads
[c1, c2, lr] from device memory, so no value that changes from step to
step is an argument of the launch. A leaf whose gradient is None is
updated with g = 0, as optax does. On CPU tensors it runs the plain
version leaf by leaf. There is no fallback from the kernel on the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

# a bias correction or a rate: a Python float, or a 0-d fp32 tensor on the
# leaves' device (an element of the optimizer's [c1, c2, lr])
Scalar = Union[float, torch.Tensor]

# elements per block of the kernel; a multiple of 4 keeps every block's
# start 16-byte aligned inside a leaf
_CHUNK = 8192


def adam_update_plain(g: Optional[torch.Tensor], m: torch.Tensor,
                      v: torch.Tensor, p: torch.Tensor, c1: Scalar,
                      c2: Scalar, lr: Scalar, b1: float, b2: float,
                      eps: float) -> None:
    """One leaf, in place: the fallback formula of
    maavss_tpu/ops/pallas_adam.py:82-89. g None is g = 0. With c1 and c2
    as device tensors both divisions are true divisions on the card (a
    Python float divisor there becomes a multiply by its reciprocal), as
    the kernel's are. lr a Python float (a constant rate) or a 0-d fp32
    tensor (a schedule's, `FusedAdam.bc[2]`): the same fp32 product."""
    if g is None:
        g = torch.zeros_like(p)
    gd = g.to(m.dtype)
    m.copy_(b1 * m + (1.0 - b1) * gd)
    v.copy_(b2 * v + (1.0 - b2) * (gd * gd))
    u = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
    p.sub_(u.to(p.dtype))


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype`: a weak-typed Python scalar meeting an array of
    that dtype in JAX."""
    return float(torch.tensor(x, dtype=dtype))


def adam_update_low(gs: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                    vs: Sequence[torch.Tensor], ps: Sequence[torch.Tensor],
                    c1: Scalar, c2: Scalar, lr: Scalar, b1: float, b2: float,
                    eps: float) -> None:
    """The formula of `adam_update_plain` over leaves of one dtype below
    float32 (the LSTM leaves under --dtype bfloat16 or float16, with
    moments of that dtype), in place, as maavss_tpu/ops/pallas_adam.py:82-89
    computes it there: every constant takes the moments' dtype first (b1,
    1 - b1, b2, 1 - b2, lr and eps as JAX's weak-typed scalars, c1 and c2
    by `astype`) and each operation rounds to it. One multi-tensor call an
    operation over all the leaves. c1, c2 and lr may be 0-d device tensors,
    rounded there (a schedule's rate: optax's `scale_by_schedule` casts the
    step size to the update's dtype). In float16 eps rounds to 0 and the
    second moment of a small gradient underflows to 0, so the update
    divides by 0 and the leaves go non-finite at the first step, as the
    reference's do (ROADMAP queue 3); nothing here guards against it."""
    dtype = ms[0].dtype
    b1r, k1, b2r, k2, eps = (
        _in_dtype(x, dtype) for x in (b1, 1.0 - b1, b2, 1.0 - b2, eps))
    c1, c2, lr = (c.to(dtype) if isinstance(c, torch.Tensor) else
                  _in_dtype(c, dtype) for c in (c1, c2, lr))
    gd = [g.to(dtype) for g in gs]
    torch._foreach_mul_(ms, b1r)
    torch._foreach_add_(ms, torch._foreach_mul(gd, k1))
    sq = torch._foreach_mul(gd, gd)
    torch._foreach_mul_(sq, k2)
    torch._foreach_mul_(vs, b2r)
    torch._foreach_add_(vs, sq)
    u = torch._foreach_div(ms, c1)
    torch._foreach_mul_(u, lr)
    den = torch._foreach_div(vs, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(u, den)
    torch._foreach_sub_(ps, u)


class AdamTable:
    """Device tables of the kernel for a fixed list of (m, v, p) leaves:
    pointers [3, n] (rows m, v, p), sizes [n], and the block map (leaf,
    first element) of every block. The gradient pointers are a separate
    [n] table, re-sent when they change, until `freeze()`: a CUDA graph
    that captured the launch reads that table, so from then on a moved
    gradient raises."""

    def __init__(self, ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                 ps: Sequence[torch.Tensor]):
        device = ps[0].device
        for t in list(ms) + list(vs) + list(ps):
            if t.dtype != torch.float32:
                raise TypeError(f"the adam kernel takes float32 leaves only, "
                                f"got {t.dtype}")
            if t.device != device or not t.is_contiguous():
                raise ValueError("the adam kernel needs contiguous leaves on "
                                 "one CUDA device")
        for m, v, p in zip(ms, vs, ps):
            if not m.shape == v.shape == p.shape:
                raise ValueError("adam kernel: m, v, p shapes differ")
        self.device = device
        self.leaves = [(m, v, p) for m, v, p in zip(ms, vs, ps)]
        self.n = len(ps)
        sizes = [p.numel() for p in ps]
        leaf_of, start_of = [], []
        for i, size in enumerate(sizes):
            for start in range(0, max(size, 1), _CHUNK):
                leaf_of.append(i)
                start_of.append(start)
        self.n_blocks = len(leaf_of)
        i64 = torch.int64
        self.ptrs = torch.tensor([[t.data_ptr() for t in col] for col in
                                  (ms, vs, ps)], dtype=i64, device=device)
        self.sizes = torch.tensor(sizes, dtype=i64, device=device)
        self.block_leaf = torch.tensor(leaf_of, dtype=torch.int32,
                                       device=device)
        self.block_start = torch.tensor(start_of, dtype=i64, device=device)
        self._gkey = None
        self.gptrs = None
        self.frozen = False

    def freeze(self) -> None:
        """Keep the current gradient table for good (see the class)."""
        if self.gptrs is None:
            raise RuntimeError("adam kernel: no gradient table to freeze "
                               "yet; take one step first")
        self.frozen = True

    def grad_table(self, grads: Sequence[Optional[torch.Tensor]]
                   ) -> torch.Tensor:
        for g, (_, _, p) in zip(grads, self.leaves):
            if g is not None and (g.dtype != torch.float32 or g.shape != p.shape
                                  or g.device != self.device
                                  or not g.is_contiguous()):
                raise ValueError("adam kernel: every gradient must be a "
                                 "contiguous float32 tensor of its leaf's "
                                 "shape on the leaves' device")
        key = tuple(0 if g is None else g.data_ptr() for g in grads)
        if key != self._gkey:
            if self.frozen:
                raise RuntimeError(
                    "adam kernel: a gradient moved after a CUDA graph "
                    "captured the optimizer; zero gradients in place "
                    "(FusedAdam.zero_grad), never set them to None")
            self.gptrs = torch.tensor(key, dtype=torch.int64,
                                      device=self.device)
            self._gkey = key
        return self.gptrs


def adam_multi_tensor(grads: Sequence[Optional[torch.Tensor]],
                      ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                      ps: Sequence[torch.Tensor], bc: torch.Tensor,
                      b1: float, b2: float, eps: float,
                      table: Optional[AdamTable] = None,
                      backend: str = "auto") -> None:
    """Every leaf, in place, with `bc` = [c1, c2, lr], the step's bias
    corrections and learning rate, a float32 tensor of 3 on the leaves'
    device (the kernel reads it there; `FusedAdam.bc`). backend 'auto':
    the kernel for CUDA leaves (one launch, through `table`, built here
    when None), the plain version for CPU leaves. 'kernel': the kernel, and
    a CPU leaf raises."""
    if backend not in ("auto", "kernel"):
        raise ValueError(f"unknown adam backend {backend!r} (auto|kernel)")
    if not ps[0].is_cuda:
        if backend == "kernel":
            raise RuntimeError("the CUDA adam kernel needs CUDA tensors")
        for g, m, v, p in zip(grads, ms, vs, ps):
            adam_update_plain(g, m, v, p, bc[0], bc[1], bc[2], b1, b2, eps)
        return
    if table is None:
        table = AdamTable(ms, vs, ps)
    if (bc.dtype != torch.float32 or bc.shape != (3,)
            or bc.device != table.device or not bc.is_contiguous()):
        raise ValueError("adam kernel: [c1, c2, lr] must be a contiguous "
                         "float32 tensor of 3 on the leaves' device")
    gptrs = table.grad_table(grads)
    from maavss_tpu_torch.ops import _build

    # (1 - b) in double, then rounded to fp32, as the TPU kernel's constants
    _build.launch("maavss_adam", table.device, (
        table.ptrs.data_ptr(), gptrs.data_ptr(), table.sizes.data_ptr(),
        table.block_leaf.data_ptr(), table.block_start.data_ptr(),
        bc.data_ptr(), table.n, table.n_blocks, _CHUNK, b1, 1.0 - b1,
        b2, 1.0 - b2, eps))
    adam_multi_tensor.launches += 1


adam_multi_tensor.launches = 0


def bias_corrections(count: int, b1: float, b2: float) -> List[float]:
    """c1 = 1 - b1^count, c2 = 1 - b2^count in fp32, as
    maavss_tpu/train/fused_adam.py:52-54 computes them, on the host."""
    c = torch.tensor(float(count), dtype=torch.float32)
    return [float(1.0 - torch.tensor(b, dtype=torch.float32) ** c)
            for b in (b1, b2)]


def device_bias_corrections(count: torch.Tensor, betas: torch.Tensor
                            ) -> torch.Tensor:
    """[c1, c2] = 1 - [b1, b2]^count as one fp32 tensor on their device:
    `bias_corrections`' ops on tensors (`count` a 0-d fp32 tensor, `betas`
    the fp32 [b1, b2]), no host value read, so a CUDA graph captures it."""
    return 1.0 - torch.pow(betas, count)
