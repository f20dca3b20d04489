"""Bilinear resize (counterpart of maavss_tpu/ops/image.py:resize_bilinear).

Plain bilinear with half-pixel centers, edge-clamped and without
antialiasing: what torch `interpolate(mode='bilinear', align_corners=False)`
computes. The gather form is written out as in the JAX package so the two
round alike.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _bilinear_gather(x: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    h_in, w_in = x.shape[-2], x.shape[-1]
    y0 = torch.clamp(torch.floor(ys), 0, h_in - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w_in - 1)
    y1 = torch.clamp(y0 + 1, 0, h_in - 1)
    x1 = torch.clamp(x0 + 1, 0, w_in - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0).to(x.dtype)
    wx = torch.clamp(xs - x0, 0.0, 1.0).to(x.dtype)
    y0i, y1i, x0i, x1i = (v.long() for v in (y0, y1, x0, x1))

    def gather(yi, xi):
        return x[..., yi, :][..., :, xi]

    top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x1i) * wx
    bot = gather(y1i, x0i) * (1 - wx) + gather(y1i, x1i) * wx
    return top * (1 - wy[:, None]) + bot * wy[:, None]


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the trailing two spatial dims."""
    h_out, w_out = size
    h_in, w_in = x.shape[-2], x.shape[-1]
    ys = (torch.arange(h_out, device=x.device) + 0.5) * (h_in / h_out) - 0.5
    xs = (torch.arange(w_out, device=x.device) + 0.5) * (w_in / w_out) - 0.5
    return _bilinear_gather(x, ys, xs)
