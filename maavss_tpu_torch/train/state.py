"""Train state and optimizer construction (counterpart of
maavss_tpu/train/state.py).

`TrainState` holds the module (its parameters and BatchNorm buffers), the
optimizer (Adam's count and moments) and the step count. JAX's state is an
immutable pytree replaced every step; here it is updated in place: the
backward writes `.grad`, `apply_gradients()` updates the parameters and the
moments where they lie, and the step functions return the same object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.train.fused_adam import FusedAdam


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    tx: FusedAdam
    step: int = 0

    def zero_grad(self) -> None:
        self.tx.zero_grad()

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the accumulated `.grad`, in place."""
        self.tx.step()
        self.step += 1
        return self


def resolve_lr(cfg: RunConfig) -> float:
    """The learning rate of --lr_schedule constant; the schedules are not
    ported yet."""
    if cfg.lr_schedule != "constant":
        raise NotImplementedError(
            f"--lr_schedule {cfg.lr_schedule} is not ported to "
            "maavss_tpu_torch yet (ROADMAP M3-rest: LR schedules)")
    return float(cfg.learning_rate)


def make_optimizer(params: Sequence[torch.Tensor], learning_rate: float,
                   name: str = "adam",
                   trainable: Optional[Sequence[str]] = None,
                   flat: bool = False, kernel: str = "auto") -> FusedAdam:
    """Adam (the reference default, train.py:55) with the optimizer-kernel
    gate of maavss_tpu/train/setup.py:191-213: 'auto' is the fused kernel
    for CUDA parameters and the plain formula for CPU ones, 'xla' the plain
    formula, 'pallas' the kernel (a CPU parameter then raises at the first
    step)."""
    if callable(learning_rate):
        raise NotImplementedError("LR schedules are not ported to "
                                  "maavss_tpu_torch yet (ROADMAP M3-rest)")
    if name != "adam":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to maavss_tpu_torch yet "
            "(ROADMAP M3-rest: sgd/adamw)")
    if trainable is not None:
        raise NotImplementedError(
            "staged trainable-prefix training is not ported to "
            "maavss_tpu_torch yet (ROADMAP M3-rest: the staged freeze)")
    if flat:
        raise NotImplementedError(
            "--fused_opt is a TPU flat-buffer variant of the same Adam and "
            "is not carried (ROADMAP queue 1, 'Not carried')")
    return FusedAdam(params, learning_rate, kernel=kernel)


def create_train_state(model: torch.nn.Module, cfg: RunConfig,
                       device="cuda", optimizer: str = "adam") -> TrainState:
    """Move `model` to `device`, put it in train mode and give it Adam with
    cfg's learning rate and --opt_kernel gate."""
    model.to(device).train()
    tx = make_optimizer(list(model.parameters()), resolve_lr(cfg), optimizer,
                        flat=cfg.fused_opt, kernel=cfg.opt_kernel)
    return TrainState(model=model, tx=tx)
