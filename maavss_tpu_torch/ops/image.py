"""Batched image transforms (counterpart of maavss_tpu/ops/image.py):
the bilinear and nearest resizes, ImageNet normalisation, grayscale,
autocontrast and the resized crop of RandomResizedCrop.

The bilinear resize is plain bilinear with half-pixel centers,
edge-clamped and without antialiasing: what torch `interpolate(
mode='bilinear', align_corners=False)` computes. The gather form is written
out as in the JAX package so the two round alike. `jax.image.resize(
method="nearest")` is `F.interpolate(mode="nearest-exact")`, not
"nearest". The crop's rectangle is drawn from a `torch.Generator`
(`sample_resized_crop`; JAX's key cannot be matched), and the crop of a
given rectangle is `resized_crop`, which holds to the JAX function's.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# ITU-R 601 luma weights, torchvision rgb_to_grayscale's
GRAY_WEIGHTS = (0.2989, 0.587, 0.114)


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


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the trailing two spatial dims (source index
    floor((i + 0.5) * in / out), jax.image.resize's "nearest")."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + x.shape[-2:]), size=tuple(size),
                      mode="nearest-exact")
    return y.reshape(lead + tuple(size))


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """Channel-wise ImageNet normalisation; channels on axis -3."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)


def grayscale(x: torch.Tensor) -> torch.Tensor:
    """RGB [..., 3, H, W] -> [..., 1, H, W] (torchvision Grayscale)."""
    w = torch.tensor(GRAY_WEIGHTS, dtype=x.dtype, device=x.device)
    return torch.tensordot(x.movedim(-3, -1), w, dims=1)[..., None, :, :]


def autocontrast(x: torch.Tensor) -> torch.Tensor:
    """Per-channel min/max remap to the full [0, 1] range (torchvision's
    autocontrast); a flat channel stays as it is."""
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    flat = hi > lo
    scale = torch.where(flat, 1.0 / (hi - lo), torch.ones_like(hi))
    return torch.where(flat, (x - lo) * scale, x)


def sample_resized_crop(generator: torch.Generator, in_hw: Tuple[int, int],
                        scale: Tuple[float, float] = (0.6, 1.0),
                        ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
                        ) -> Tuple[int, int, int, int]:
    """(top, left, h, w) as the JAX function draws them: one area and one
    log-aspect draw, h and w rounded half to even and clamped to the image,
    then the corner uniform over the positions that fit."""
    h_in, w_in = in_hw
    u = torch.rand(2, generator=generator, dtype=torch.float64).tolist()
    target_area = h_in * w_in * (scale[0] + (scale[1] - scale[0]) * u[0])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = math.exp(lo + (hi - lo) * u[1])
    w = int(min(max(round(math.sqrt(target_area * aspect)), 1), w_in))
    h = int(min(max(round(math.sqrt(target_area / aspect)), 1), h_in))
    top = int(torch.randint(0, h_in + 1 - h, (), generator=generator))
    left = int(torch.randint(0, w_in + 1 - w, (), generator=generator))
    return top, left, h, w


def resized_crop(clip: torch.Tensor, top: int, left: int, h: int, w: int,
                 size: int) -> torch.Tensor:
    """Clip [..., H, W] -> [..., size, size]: the rectangle (top, left, h,
    w) resized bilinearly with half-pixel centers, the samples clamped to
    the image (not to the rectangle), as the JAX function samples its
    coordinate grid."""
    ar = torch.arange(size, dtype=torch.float32, device=clip.device) + 0.5
    ys = ar * (h / size) - 0.5 + top
    xs = ar * (w / size) - 0.5 + left
    return _bilinear_gather(clip, ys, xs)


def random_resized_crop(generator: torch.Generator, clip: torch.Tensor,
                        size: int, scale: Tuple[float, float] = (0.6, 1.0)
                        ) -> torch.Tensor:
    """Clip [..., H, W] -> [..., size, size], one crop for the whole clip
    (RandomResizedCrop(size, scale) on a [T, C, H, W] tensor)."""
    rect = sample_resized_crop(generator, clip.shape[-2:], scale)
    return resized_crop(clip, *rect, size)
