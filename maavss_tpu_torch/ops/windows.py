"""Window functions with torch parity (counterpart of maavss_tpu/ops/windows.py).

`torch.hamming_window(n)` is periodic: w[n] = 0.54 - 0.46 cos(2*pi*n / N).
The formula is written out so the port computes the same float32 values as
the JAX package's window.
"""

from __future__ import annotations

import math

import torch


def hamming_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    k = torch.arange(n, dtype=dtype, device=device)
    return (0.54 - 0.46 * torch.cos(2.0 * math.pi * k / n)).to(dtype)
