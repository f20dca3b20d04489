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
import math
from typing import Callable, Optional, Sequence, Union

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


# a learning rate: a Python float (constant) or a schedule, count -> rate
# on 0-d fp32 tensors (`cosine_decay_schedule`)
LearningRate = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax.cosine_decay_schedule (exponent 1) as torch ops: count (a 0-d
    fp32 tensor, on any device) -> the rate, a 0-d fp32 tensor there, in
    optax's order of operations."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")
    d = float(decay_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count, max=d)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * c / d))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule (exponent 1) as torch ops: a
    linear ramp init -> peak over warmup_steps (optax's linear_schedule),
    then the cosine decay to end_value over decay_steps - warmup_steps,
    joined at warmup_steps as optax.join_schedules joins them."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                   alpha)
    w = float(warmup_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        frac = 1.0 - torch.clamp(count, 0.0, w) / w
        ramp = (init_value - peak_value) * frac + peak_value
        return torch.where(count < w, ramp, cosine(count - w))

    return schedule


def resolve_lr(cfg: RunConfig) -> LearningRate:
    """--lr_schedule: a float (constant, reference parity, train.py:55) or
    a schedule over the run's total optimizer steps, as
    maavss_tpu/train/setup.py:resolve_lr builds optax's: cosine to
    lr * lr_final_scale, or warmup_cosine from 0 over warmup_steps (default
    total // 20, at least 1). The optimizer evaluates it on the card, from
    its device count (train/fused_adam.py)."""
    if cfg.lr_schedule == "constant":
        return float(cfg.learning_rate)
    total = cfg.epochs * cfg.steps_per_epoch
    if cfg.lr_schedule == "cosine":
        return cosine_decay_schedule(cfg.learning_rate, max(total, 1),
                                     alpha=cfg.lr_final_scale)
    if cfg.lr_schedule == "warmup_cosine":
        warm = cfg.warmup_steps or max(total // 20, 1)
        return warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, warm, max(total, warm + 1),
            end_value=cfg.learning_rate * cfg.lr_final_scale)
    raise SystemExit(f"unknown --lr_schedule {cfg.lr_schedule}")


def make_optimizer(params: Sequence[torch.Tensor],
                   learning_rate: LearningRate,
                   name: str = "adam",
                   trainable: Optional[Sequence[str]] = None,
                   flat: bool = False, kernel: str = "auto") -> FusedAdam:
    """Adam (the reference default, train.py:55) with the optimizer-kernel
    gate of maavss_tpu/train/setup.py:191-213: 'auto' is the fused kernel
    for CUDA parameters and the plain formula for CPU ones, 'xla' the plain
    formula, 'pallas' the kernel (a CPU parameter then raises at the first
    step). A schedule runs with every kernel choice: the JAX package
    refuses one with its Pallas Adam, which bakes a scalar learning rate
    (maavss_tpu/train/state.py:78-82), but K3 reads the rate from the card
    (`FusedAdam`), so that reason does not hold here."""
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
