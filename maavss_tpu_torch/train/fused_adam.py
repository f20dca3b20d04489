"""Adam with optax's semantics over a module's parameters (counterpart of
maavss_tpu/train/fused_adam.py:pallas_adam and of optax.adam, which share
one formula).

The optimizer keeps `count` and, per parameter, the moments `m` and `v`;
`step()` increments count, takes the bias corrections in fp32 and updates
every parameter and its moments in place:

- kernel 'pallas' (the JAX flag's name): ONE launch of the fused CUDA kernel
  over all leaves (ops/cuda_adam.py); a CPU parameter raises;
- kernel 'xla': the plain formula leaf by leaf, an explicit choice;
- kernel 'auto': the kernel for CUDA parameters, the plain formula for CPU
  ones.

A parameter whose `.grad` is None (the decoders, which the fusion forward
never reaches) is updated with g = 0, as optax does with its zero gradient;
`torch.optim.Adam` would skip it, and the two diverge once m != 0.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

from maavss_tpu_torch.ops.cuda_adam import (
    AdamTable,
    adam_multi_tensor,
    adam_update_plain,
    bias_corrections,
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
    """Adam over `params` (a list of tensors, updated in place)."""

    def __init__(self, params: Iterable[torch.Tensor], learning_rate: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 kernel: str = "auto"):
        self.params: List[torch.Tensor] = list(params)
        if not self.params:
            raise ValueError("FusedAdam needs at least one parameter")
        self.lr, self.b1, self.b2, self.eps = (float(learning_rate), b1, b2,
                                               eps)
        self.kernel = resolve_opt_kernel(kernel, self.params[0].device)
        self.count = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self._table = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        c1, c2 = bias_corrections(self.count, self.b1, self.b2)
        grads = [p.grad for p in self.params]
        if self.kernel == "pallas":
            if self._table is None and self.params[0].is_cuda:
                self._table = AdamTable(self.m, self.v, self.params)
            adam_multi_tensor(grads, self.m, self.v, self.params, c1, c2,
                              self.lr, self.b1, self.b2, self.eps,
                              table=self._table, backend="kernel")
        else:
            for g, m, v, p in zip(grads, self.m, self.v, self.params):
                adam_update_plain(g, m, v, p, c1, c2, self.lr, self.b1,
                                  self.b2, self.eps)

    def zero_grad(self) -> None:
        """Zero every existing gradient in place (the kernel's gradient
        table then keeps its pointers); None stays None."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if grads:
            torch._foreach_zero_(grads)
