"""Dense Lucas-Kanade optical flow (counterpart of maavss_tpu/ops/flow.py).

Scharr/32 spatial gradients and the temporal difference feed per-pixel
2x2 normal equations summed over a box window, all as depthwise 'same'
convolutions (`F.conv2d` after a zero pad that puts the extra row and
column of an even window at the end, as XLA's SAME does).
`flow_magnitude` is the motion-energy alternative to DINO attention
frames.

The box sums feed `det = sxx * syy - sxy^2`, which cancels in flat
regions: on the card, TF32 must be off (the caller's flags; the tools
turn it off).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SCHARR_X = ((-3.0, 0.0, 3.0), (-10.0, 0.0, 10.0), (-3.0, 0.0, 3.0))


def _conv2d_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' 2-D cross-correlation of [..., H, W] with [kh, kw]."""
    h, w = x.shape[-2:]
    kh, kw = k.shape
    xx = F.pad(x.reshape(-1, 1, h, w),
               ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    return F.conv2d(xx, k[None, None].to(x.dtype)).reshape(x.shape)


def lucas_kanade_dense(prev: torch.Tensor, nxt: torch.Tensor,
                       window: int = 15, eps: float = 1e-4) -> torch.Tensor:
    """prev, nxt [..., H, W] grayscale in [0, 1] -> flow [..., 2, H, W]
    (dy, dx): the windowed least squares [Ixx Ixy; Ixy Iyy] u = -[Ixt; Iyt]
    per pixel, with Tikhonov damping `eps`."""
    sx = torch.tensor(SCHARR_X, device=prev.device) / 32.0
    ix = _conv2d_same(prev, sx)
    iy = _conv2d_same(prev, sx.T)
    it = nxt - prev
    box = torch.full((window, window), 1.0 / (window * window),
                     device=prev.device)
    sxx = _conv2d_same(ix * ix, box) + eps
    syy = _conv2d_same(iy * iy, box) + eps
    sxy = _conv2d_same(ix * iy, box)
    sxt = _conv2d_same(ix * it, box)
    syt = _conv2d_same(iy * it, box)
    det = sxx * syy - sxy * sxy
    u = (-syy * sxt + sxy * syt) / det  # dx
    v = (sxy * sxt - sxx * syt) / det  # dy
    return torch.stack([v, u], dim=-3)


def clip_flow(frames: torch.Tensor, window: int = 15) -> torch.Tensor:
    """frames [..., T, H, W] -> [..., T, 2, H, W], the first frame's flow
    zero (like the phasegram's zero-padded temporal difference)."""
    flow = lucas_kanade_dense(frames[..., :-1, :, :], frames[..., 1:, :, :],
                              window=window)
    return torch.cat([torch.zeros_like(flow[..., :1, :, :, :]), flow],
                     dim=-4)


def flow_magnitude(frames: torch.Tensor, window: int = 15,
                   normalize: bool = True) -> torch.Tensor:
    """Motion-energy frames [..., T, H, W]: |flow| per pixel, max-normalized
    per clip unless `normalize` is False."""
    fl = clip_flow(frames, window=window)
    mag = torch.sqrt((fl * fl).sum(dim=-3) + 1e-12)
    if normalize:
        m = mag.amax(dim=(-3, -2, -1), keepdim=True)
        mag = mag / torch.clamp(m, min=1e-8)
    return mag
