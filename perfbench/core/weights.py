"""Seeded weights, made on the device in one draw.

`make_weights(model, seed, device, low_leaves, low_dtype)` gives every
parameter and buffer of the reference model `model` (whose names are the
port's) a value from one normal draw of a `torch.Generator` on `device`:

- conv and dense kernels: N(0, 1/fan_in) (fan_in the input channels times
  the kernel's taps);
- the LSTM's w_i and w_h: N(0, 1/(3H)), the variance of the published
  U(-1/sqrt(H), 1/sqrt(H));
- biases: N(0, 0.01^2);
- BatchNorm: scale 1 + N(0, 0.1^2), shift N(0, 0.1^2), running mean
  N(0, 0.1^2), running variance exp(N(0, 0.3^2)).

Leaves for which `low_leaves(name)` holds are rounded to `low_dtype` and
kept in float32: the configuration states them in that dtype (flax keeps
an RNN cell's parameters in the compute dtype), so both the program and
the reference start from the rounded values.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn


def _scale(name: str, shape) -> tuple:
    """(std, mean) of a leaf by its name and shape."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("running_mean",) or (".BatchNorm_0." in f".{name}"
                                     and leaf == "bias"):
        return 0.1, 0.0
    if ".BatchNorm_0." in f".{name}" and leaf == "weight":
        return 0.1, 1.0
    if leaf == "running_var":
        return 0.3, None  # lognormal
    if leaf == "bias":
        return 0.01, 0.0
    if leaf in ("w_i", "w_h"):
        return 1.0 / math.sqrt(3 * shape[1] // 4), 0.0
    fan_in = math.prod(shape[1:])
    return 1.0 / math.sqrt(max(fan_in, 1)), 0.0


def make_weights(model: nn.Module, seed: int, device,
                 low_leaves: Optional[Callable[[str], bool]] = None,
                 low_dtype: torch.dtype = torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    leaves = list(model.state_dict().items())
    total = sum(t.numel() for _, t in leaves)
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, t in leaves:
        w = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
        std, mean = _scale(name, t.shape)
        if mean is None:
            w = torch.exp(w * std)
        else:
            w = w * std + mean
        if low_leaves is not None and low_leaves(name):
            w = w.to(low_dtype).to(torch.float32)
        out[name] = w
    return out
