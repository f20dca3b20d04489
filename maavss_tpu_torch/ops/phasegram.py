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
from maavss_tpu_torch.parallel.collectives import all_max
from maavss_tpu_torch.parallel.mesh import data_size


def _phase_rows(frames: torch.Tensor, resize: Optional[Tuple[int, int]],
                cumulative: bool) -> torch.Tensor:
    """frames [B, T, H, W] (or [B, 1, T, H, W]) -> per-frame phase rows
    [B, T, H*W]: resize, fft2, spatial fftshift, angle, flatten, then the
    cumsum / (2 pi N) or, without `cumulative`, the affine (p + pi) / 2 pi."""
    if frames.ndim == 5:
        frames = frames.squeeze(1)
    if resize is not None:
        frames = resize_bilinear(frames, resize)
    fft = torch.fft.fftshift(torch.fft.fft2(frames), dim=(-2, -1))
    p_flat = torch.angle(fft).flatten(-2)
    if cumulative:
        p_flat = torch.cumsum(p_flat, dim=-1)
        return p_flat / (2.0 * math.pi * p_flat.shape[-1])
    return (p_flat + math.pi) / (2.0 * math.pi)


def phasegram_cumsum(frames: torch.Tensor,
                     resize: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """Per-frame half of the phasegram: frames `[B, T, H, W]` ->
    cumsum-normalized phase rows `[B, T, H*W]`."""
    return _phase_rows(frames, resize, cumulative=True)


def phasegram_window(p_flat: torch.Tensor, diff: bool = True,
                     normalize: bool = True) -> torch.Tensor:
    """Finish a phasegram from cumsum rows `[B, T, S]` -> `[B, 1, T, S]`:
    temporal diff (zero-padded first frame) + global max-abs normalization
    (one max over the whole batch, as in the JAX package; under a mesh
    with more than one data rank, over the global batch: the max of the
    data group's maxima)."""
    if diff:
        p_diff = torch.diff(p_flat, dim=-2)
        pg = torch.cat([torch.zeros_like(p_diff[..., 0:1, :]), p_diff],
                       dim=-2)
    else:
        pg = p_flat
    pg = pg.unsqueeze(-3)
    if normalize:
        peak = torch.max(torch.abs(pg))
        if data_size() > 1:
            peak = all_max(peak)
        pg = pg * (1.0 / torch.clamp(peak, min=1e-12))
    return pg


def video_phasegram(frames: torch.Tensor,
                    resize: Optional[Tuple[int, int]] = None,
                    diff: bool = True, cumulative: bool = True,
                    normalize: bool = True) -> torch.Tensor:
    """frames `[B, 1, T, H, W]` (or `[B, T, H, W]`) -> `[B, 1, T, H*W]`
    (maavss_tpu/ops/phasegram.py:video_phasegram): the whole phasegram of a
    clip. With the default flags it is
    `phasegram_window(phasegram_cumsum(frames))` op for op; `cumulative`
    picks the per-frame rows and `diff`, `normalize` go to
    `phasegram_window`."""
    return phasegram_window(_phase_rows(frames, resize, cumulative), diff,
                            normalize)
