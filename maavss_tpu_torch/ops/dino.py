"""The DINO ViT motion-attention extractor (counterpart of
maavss_tpu/ops/dino.py): a frozen DINO ViT-S/8 whose last-block CLS->patch
self-attention maps become the visual motion feature, a clip's frames
through one batched forward.

Modules carry the official DINO names (`patch_embed.proj`,
`blocks.{i}.attn.qkv`, `blocks.{i}.mlp.fc1`, `norm`, ...), so the official
`dino_deitsmall8_pretrain.pth`, with its `module.` and `backbone.` prefixes
stripped, loads with a strict `load_state_dict` (`load_torch_weights`).
LayerNorm's epsilon is 1e-6 and GELU the exact one, as in DINO.

The position embedding at a grid other than the pretrain grid is resized
with `_torch_bicubic_matrix` (a copy of the JAX package's): DINO's
interpolate_pos_encoding calls F.interpolate(mode="bicubic",
scale_factor=(hp + 0.1) / grid), a = -0.75, replicate-clamped taps; here it
is a static [hp, grid] matrix applied as two matmuls.

The products and the softmax are plain torch ops (cuBLAS on the card), as
they are plain jnp in the JAX package. TF32 is the caller's to turn off
(tools/save_attn_videos_torch.py does).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VIT_CONFIGS = {
    "vit_tiny": dict(embed_dim=192, depth=12, num_heads=3),
    "vit_small": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_base": dict(embed_dim=768, depth=12, num_heads=12),
}
LN_EPS = 1e-6


def _torch_bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] matrix reproducing torch F.interpolate(mode='bicubic',
    align_corners=False, scale_factor=(n_out+0.1)/n_in): DINO's
    interpolate_pos_encoding call, its +0.1 fudge included (the source
    coordinate scale is n_in/(n_out+0.1), not n_in/n_out). Cubic
    convolution kernel a=-0.75, taps replicate-clamped at the border."""

    def cubic(x: float, a: float = -0.75) -> float:
        x = abs(x)
        if x <= 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
        if x < 2.0:
            return (((x - 5.0) * x + 8.0) * x - 4.0) * a
        return 0.0

    scale = n_in / (n_out + 0.1)
    m = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        for k, wgt in enumerate((cubic(t + 1.0), cubic(t), cubic(1.0 - t),
                                 cubic(2.0 - t))):
            m[i, min(max(i0 - 1 + k, 0), n_in - 1)] += wgt
    return m.astype(np.float32)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, return_attn: bool = False
                ) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = ((q @ k.transpose(-2, -1)) * (d // h) ** -0.5).softmax(dim=-1)
        if return_attn:
            return attn  # [B, h, N, N]
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, return_attn: bool = False
                ) -> torch.Tensor:
        if return_attn:
            return self.attn(self.norm1(x), return_attn=True)
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)


class VisionTransformer(nn.Module):
    """DINO's ViT backbone. `forward` returns the CLS feature [B, D];
    `get_last_selfattention` the last block's softmax attention [B, h,
    1+N, 1+N]. Input [B, 3, H, W]; the patch grid floors H and W."""

    def __init__(self, patch_size: int = 8, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, pos_grid: int = 28):
        super().__init__()
        self.patch_size, self.embed_dim, self.pos_grid = (
            patch_size, embed_dim, pos_grid)
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + pos_grid * pos_grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def _pos_embed_for(self, hp: int, wp: int) -> torch.Tensor:
        cls_pe = self.pos_embed[:, :1]
        patch_pe = self.pos_embed[:, 1:].reshape(
            1, self.pos_grid, self.pos_grid, self.embed_dim)
        if (hp, wp) != (self.pos_grid, self.pos_grid):
            dev = patch_pe.device
            mh = torch.from_numpy(_torch_bicubic_matrix(self.pos_grid, hp))
            mw = torch.from_numpy(_torch_bicubic_matrix(self.pos_grid, wp))
            patch_pe = torch.einsum("oh,bhwd->bowd", mh.to(dev), patch_pe)
            patch_pe = torch.einsum("ow,bhwd->bhod", mw.to(dev), patch_pe)
        return torch.cat([cls_pe, patch_pe.reshape(1, hp * wp, -1)], dim=1)

    def _prepare(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed.proj(x)  # [B, D, hp, wp]
        hp, wp = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self._pos_embed_for(hp, wp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._prepare(x)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 0]

    def get_last_selfattention(self, x: torch.Tensor) -> torch.Tensor:
        x = self._prepare(x)
        for blk in self.blocks[:-1]:
            x = blk(x)
        return self.blocks[-1](x, return_attn=True)


def _upsample(a: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Nearest upsampling of the two trailing axes by `patch_size`."""
    return a.repeat_interleave(patch_size, dim=-2).repeat_interleave(
        patch_size, dim=-1)


def cls_attention_maps(attn: torch.Tensor, hp: int, wp: int,
                       patch_size: int) -> torch.Tensor:
    """[B, h, 1+N, 1+N] -> head-summed, max-normalized CLS->patch maps
    [B, hp*ps, wp*ps] (the reference's attention frames)."""
    a = attn[:, :, 0, 1:].reshape(attn.shape[0], attn.shape[1], hp, wp)
    out = _upsample(a, patch_size).sum(dim=1)
    return out / out.amax(dim=(-2, -1), keepdim=True)


def threshold_masks(attn: torch.Tensor, hp: int, wp: int, patch_size: int,
                    threshold: float = 0.6) -> torch.Tensor:
    """Top-`threshold` attention-mass masks [B, h, hp*ps, wp*ps]. Sorts are
    stable, as jnp.sort and jnp.argsort are: ties are common."""
    a = attn[:, :, 0, 1:]
    val = torch.sort(a, dim=-1, stable=True).values
    val = val / val.sum(dim=-1, keepdim=True)
    th_sorted = val.cumsum(dim=-1) > (1 - threshold)
    order = torch.argsort(a, dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1, stable=True)
    th = torch.gather(th_sorted, -1, inv).to(a.dtype)
    return _upsample(th.reshape(a.shape[0], a.shape[1], hp, wp), patch_size)


def seeded_state_dict(seed: int, embed_dim: int = 384, depth: int = 12,
                      patch_size: int = 8, pos_grid: int = 28,
                      scale: float = 0.02) -> Dict[str, torch.Tensor]:
    """A state_dict in the official format, every tensor but the norms'
    drawn N(0, scale^2) from `np.random.default_rng(seed)` in key order
    (norms 1 and 0): the same bytes on any host. At seed 20260819 and the
    defaults (ViT-S/8) it is the ViT of tests/fixtures/dino_golden.npz."""
    dim = embed_dim
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * scale)

    sd = {
        "cls_token": t(1, 1, dim),
        "pos_embed": t(1, 1 + pos_grid * pos_grid, dim),
        "patch_embed.proj.weight": t(dim, 3, patch_size, patch_size),
        "patch_embed.proj.bias": t(dim),
        "norm.weight": torch.ones(dim), "norm.bias": torch.zeros(dim),
    }
    for i in range(depth):
        p = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            sd[p + norm + ".weight"] = torch.ones(dim)
            sd[p + norm + ".bias"] = torch.zeros(dim)
        for name, (n_out, n_in) in (("attn.qkv", (3 * dim, dim)),
                                    ("attn.proj", (dim, dim)),
                                    ("mlp.fc1", (4 * dim, dim)),
                                    ("mlp.fc2", (dim, 4 * dim))):
            sd[p + name + ".weight"] = t(n_out, n_in)
            sd[p + name + ".bias"] = t(n_out)
    return sd


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """The official `dino_deitsmall8_pretrain.pth`-style checkpoint as a
    state_dict for `VisionTransformer`: the "teacher" entry where there is
    one, `module.` and `backbone.` stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "teacher" in ckpt:
        ckpt = ckpt["teacher"]
    return {k.replace("module.", "").replace("backbone.", ""): v
            for k, v in ckpt.items()}


def _init_random(model: VisionTransformer, generator: torch.Generator
                 ) -> None:
    """flax's initialisers, drawn from `generator`: tokens N(0, 0.02^2),
    then the kernels as `train/setup.init_flax_like` draws them (biases 0,
    norms 1 and 0)."""
    from maavss_tpu_torch.train.setup import init_flax_like

    with torch.no_grad():
        for p in (model.cls_token, model.pos_embed):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
    init_flax_like(model, generator)


class VideoAttention:
    """Frames [T, 3, H, W] -> attention frames [T, 1, H', W'], H' and W'
    cropped down to a multiple of the patch; one batched forward a call.
    `state_dict` None: a random frozen ViT from `seed` (the weights file
    is not bundled)."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 patch_size: int = 8, architecture: str = "vit_small",
                 seed: int = 0, device="cuda"):
        cfg = VIT_CONFIGS[architecture]
        self.patch_size = patch_size
        grid = 28
        if state_dict is not None:
            grid = math.isqrt(state_dict["pos_embed"].shape[1] - 1)
        self.model = VisionTransformer(patch_size=patch_size, pos_grid=grid,
                                       **cfg)
        if state_dict is None:
            _init_random(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        ps = self.patch_size
        h = frames.shape[-2] - frames.shape[-2] % ps
        w = frames.shape[-1] - frames.shape[-1] % ps
        attn = self.model.get_last_selfattention(frames[..., :h, :w])
        return cls_attention_maps(attn, h // ps, w // ps, ps)[:, None]
