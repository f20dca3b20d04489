"""Phasegram: compact spectral-phase motion representation (counterpart of
maavss_tpu/ops/phasegram.py).

Per attention frame: 2D FFT -> fftshift -> phase angle -> flatten spatial ->
cumulative-sum normalize, then per window: temporal difference -> global
max-abs normalize, emitting `[B, 1, T, p_size*p_size]`.

Two documented deviations from the reference, kept as in the JAX package:
the fftshift rolls only the spatial axes (the reference's dim-less fftshift
also rolls batch and time), and the max-norm is eps-guarded so constant
frames give zeros rather than NaN.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from maavss_tpu_torch.ops.image import resize_bilinear


def phasegram_cumsum(frames: torch.Tensor,
                     resize: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Per-frame half of the phasegram: frames `[B, T, H, W]` ->
    cumsum-normalized phase rows `[B, T, H*W]`."""
    if frames.ndim == 5:
        frames = frames.squeeze(1)
    if resize is not None:
        frames = resize_bilinear(frames, resize)
    fft = torch.fft.fftshift(torch.fft.fft2(frames), dim=(-2, -1))
    p_flat = torch.cumsum(torch.angle(fft).flatten(-2), dim=-1)
    return p_flat / (2.0 * math.pi * p_flat.shape[-1])


def phasegram_window(p_flat: torch.Tensor) -> torch.Tensor:
    """Finish a phasegram from cumsum rows `[B, T, S]` -> `[B, 1, T, S]`:
    temporal diff (zero-padded first frame) + global max-abs normalization
    (one max over the whole batch, as in the JAX package)."""
    p_diff = torch.diff(p_flat, dim=-2)
    pg = torch.cat([torch.zeros_like(p_diff[..., 0:1, :]), p_diff], dim=-2)
    pg = pg.unsqueeze(-3)
    return pg * (1.0 / torch.clamp(torch.max(torch.abs(pg)), min=1e-12))
