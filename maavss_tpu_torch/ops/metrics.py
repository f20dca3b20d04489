"""Separation-quality metrics (counterpart of maavss_tpu/ops/metrics.py)."""

from __future__ import annotations

import torch


def si_sdr(estimate: torch.Tensor, target: torch.Tensor,
           eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SDR in dB over the last axis (Le Roux et al. 2019)."""
    target = target - target.mean(dim=-1, keepdim=True)
    estimate = estimate - estimate.mean(dim=-1, keepdim=True)
    alpha = (estimate * target).sum(dim=-1, keepdim=True) / (
        (target ** 2).sum(dim=-1, keepdim=True) + eps)
    projection = alpha * target
    noise = estimate - projection
    ratio = (projection ** 2).sum(dim=-1) / ((noise ** 2).sum(dim=-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


def sdr(estimate: torch.Tensor, target: torch.Tensor,
        eps: float = 1e-8) -> torch.Tensor:
    """Plain SDR in dB over the last axis."""
    num = (target ** 2).sum(dim=-1)
    den = ((estimate - target) ** 2).sum(dim=-1) + eps
    return 10.0 * torch.log10(num / den + eps)
