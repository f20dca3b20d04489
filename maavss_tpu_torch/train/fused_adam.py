"""Adam with optax's semantics over a module's parameters (counterpart of
maavss_tpu/train/fused_adam.py:pallas_adam and of optax.adam, which share
one formula).

The optimizer keeps `count` and, per parameter, the moments `m` and `v`;
`step()` takes the learning rate, increments count, takes the bias
corrections in fp32 and updates every parameter and its moments in place.
The count and the step's [c1, c2, lr] (`bc`, one fp32 buffer of 3) live on
the parameters' device, advanced in place by torch ops
(`device_bias_corrections`; a schedule's rate from the count before the
increment, as optax's `scale_by_schedule` reads it: step n takes
`schedule(n - 1)`), so the same step runs eagerly or captured in a CUDA
graph with the same bits, and no step reads a host value the graph would
freeze; `count` the attribute is the host's copy, a Python int. A constant
rate stays the Python float it was given on the plain formula's leaves (a
weak-typed scalar, as in JAX); under a schedule those leaves read `bc[2]`,
the fp32 leaves as it is and the leaves below fp32 rounded to their dtype,
as optax's `scale_by_schedule` casts the step size to each update's dtype:

- kernel 'pallas' (the JAX flag's name): ONE launch of the fused CUDA kernel
  over all float32 leaves (ops/cuda_adam.py); a CPU parameter raises. The
  leaves below float32 (the LSTM's w_i and w_h under --dtype bfloat16, with
  their bf16 moments) take the plain formula, in multi-tensor calls
  (`adam_update_low`), as the JAX kernel's own gate sends them to its jnp
  formula
  (maavss_tpu/ops/pallas_adam.py:62-64,80-89): the reference's split, not
  a fallback;
- kernel 'xla': the plain formula leaf by leaf for the float32 leaves, an
  explicit choice, and the same multi-tensor calls as 'pallas' for the
  leaves below float32;
- kernel 'auto': the kernel for CUDA parameters, the plain formula for CPU
  ones.

A parameter whose `.grad` is None (the decoders, which the fusion forward
never reaches) is updated with g = 0, as optax does with its zero gradient;
`torch.optim.Adam` would skip it, and the two diverge once m != 0.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Union

import torch

from maavss_tpu_torch.ops.cuda_adam import (
    AdamTable,
    adam_multi_tensor,
    adam_update_low,
    adam_update_plain,
    device_bias_corrections,
)


def resolve_opt_kernel(kernel: str, device) -> str:
    """'auto' -> 'pallas' (the kernel) for a CUDA device, 'xla' (the plain
    formula) elsewhere; 'xla' and 'pallas' stand."""
    if kernel == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    if kernel not in ("xla", "pallas"):
        raise ValueError(f"unknown opt_kernel {kernel!r} (auto|xla|pallas)")
    return kernel


class FusedAdam:
    """Adam over `params` (a list of tensors, updated in place);
    `learning_rate` a float or a schedule (train/state.py:resolve_lr)."""

    def __init__(self, params: Iterable[torch.Tensor],
                 learning_rate: Union[float, Callable], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, kernel: str = "auto"):
        self.params: List[torch.Tensor] = list(params)
        if not self.params:
            raise ValueError("FusedAdam needs at least one parameter")
        self.schedule = learning_rate if callable(learning_rate) else None
        self.lr = (None if self.schedule is not None
                   else float(learning_rate))
        self.b1, self.b2, self.eps = b1, b2, eps
        device = self.params[0].device
        self.kernel = resolve_opt_kernel(kernel, device)
        self._count = torch.zeros((), dtype=torch.float32, device=device)
        self._betas = torch.tensor([b1, b2], dtype=torch.float32).to(device)
        # [c1, c2, lr] of the last step, rewritten in place every step
        self.bc = torch.zeros(3, dtype=torch.float32, device=device)
        if self.schedule is None:
            self.bc[2].fill_(self.lr)
        self._host_count = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        # the kernel's leaves (float32) and the plain formula's (below it)
        self._f32 = [i for i, p in enumerate(self.params)
                     if p.dtype == torch.float32]
        self._low = [i for i, p in enumerate(self.params)
                     if p.dtype != torch.float32]
        self._table = None

    @property
    def count(self) -> int:
        """Steps taken (the host's copy of the device count)."""
        return self._host_count

    @count.setter
    def count(self, n: int) -> None:
        self._host_count = int(n)
        self._count.fill_(float(n))

    @property
    def count_tensor(self) -> torch.Tensor:
        """The count as the steps read it: a 0-d fp32 tensor on the
        parameters' device."""
        return self._count

    def note_steps(self, n: int) -> None:
        """Add n to the host's count alone: steps that a CUDA-graph replay
        took on the device (n < 0 takes back a capture's, which ran
        nothing)."""
        self._host_count += n

    def freeze_grad_table(self) -> None:
        """Pin the kernel's gradient table (`AdamTable.freeze`) once a CUDA
        graph is to capture the update; nothing to pin on the plain
        formula."""
        if self._table is not None:
            self._table.freeze()

    @torch.no_grad()
    def step(self) -> None:
        self._host_count += 1
        if self.schedule is not None:
            self.bc[2].copy_(self.schedule(self._count))
        self._count.add_(1.0)
        self.bc[:2].copy_(device_bias_corrections(self._count, self._betas))
        hyper = (self.bc[2] if self.schedule is not None else self.lr,
                 self.b1, self.b2, self.eps)
        if self.kernel != "pallas":
            for i in self._f32:
                p = self.params[i]
                adam_update_plain(p.grad, self.m[i], self.v[i], p,
                                  self.bc[0], self.bc[1], *hyper)
        elif self._f32:
            ms, vs, ps = ([col[i] for i in self._f32]
                          for col in (self.m, self.v, self.params))
            if self._table is None and ps[0].is_cuda:
                self._table = AdamTable(ms, vs, ps)
            adam_multi_tensor([p.grad for p in ps], ms, vs, ps, self.bc,
                              *hyper[1:], table=self._table,
                              backend="kernel")
        for dtype in {self.params[i].dtype for i in self._low}:
            idx = [i for i in self._low if self.params[i].dtype == dtype]
            ps = [self.params[i] for i in idx]
            adam_update_low([p.grad if p.grad is not None else
                             torch.zeros_like(p) for p in ps],
                            [self.m[i] for i in idx],
                            [self.v[i] for i in idx], ps, self.bc[0],
                            self.bc[1], *hyper)

    def zero_grad(self) -> None:
        """Zero every existing gradient in place (the kernel's gradient
        table then keeps its pointers), one multi-tensor call per dtype;
        None stays None."""
        by_dtype = {}
        for p in self.params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            torch._foreach_zero_(grads)
