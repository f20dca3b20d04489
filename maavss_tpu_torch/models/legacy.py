"""The legacy model family (counterpart of maavss_tpu/models/legacy.py):
`AVSEModel`, main.py's raw-FFT model (conv1d audio and conv3d visual
encoders, FC fusion), and `AVModelSTFT`, the shape-adaptive STFT conv2d
autoencoder with a conv3d visual autoencoder and a 1x3-conv fusion.

Modules carry flax's names (`Conv_0`, `Dense_1`, `audio_enc_convs_2`,
`video_up1.ConvTranspose_0`, ...), so `convert.from_flax` of a JAX tree
loads with a strict `load_state_dict`. What differs from torch's defaults:

- flax's `ConvTranspose(padding="VALID")` is `i*s + max(k - s, 0)` long
  along each axis, one more than torch's transposed conv when the stride
  exceeds the kernel (`video_up1`/`video_up2`: k 3, stride 4); the extra
  row holds the bias alone. `output_padding = max(s - k, 0)` gives lax's
  size, then the JAX module's crop of `padding` and zero pad up to the
  requested size follow. flax does not flip the kernel; the converter
  does.
- LayerNorm's epsilon is flax's 1e-6; LeakyReLU's slope 0.3; the average
  pools floor (VALID).

The models run in float32 (main.py's and train_autoencoder.py's dtype).
Guarded deviation, as in the JAX module: the visual sizing loop of
`AVModelSTFT` stops once the spatial size can no longer halve.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maavss_tpu_torch.models.layers import TorchBatchNorm

LN_EPS = 1e-6  # flax nn.LayerNorm's default
LEAKY_SLOPE = 0.3


class _ConvTransposeTorch(nn.Module):
    """A flax `ConvTranspose(padding="VALID")` cut to an explicit output
    size: crop `padding` at the start of each spatial axis, then zero-pad
    the far side up to `out_size` (torch's `output_size=` semantics, what
    the reference's layers ask for)."""

    _conv = None  # nn.ConvTranspose2d or nn.ConvTranspose3d

    def __init__(self, in_features: int, features: int,
                 kernel: Sequence[int], stride: Sequence[int],
                 padding: Sequence[int]):
        super().__init__()
        self.padding = tuple(padding)
        self.ConvTranspose_0 = self._conv(
            in_features, features, tuple(kernel), tuple(stride),
            output_padding=tuple(max(s - k, 0)
                                 for k, s in zip(kernel, stride)))

    def forward(self, x: torch.Tensor, out_size: Sequence[int]
                ) -> torch.Tensor:
        y = self.ConvTranspose_0(x)
        crop = [slice(None), slice(None)]
        for ax, (p, t) in enumerate(zip(self.padding, out_size)):
            crop.append(slice(p, min(y.shape[2 + ax], p + t)))
        y = y[tuple(crop)]
        pad: List[int] = []
        for ax in reversed(range(len(out_size))):
            pad += [0, out_size[ax] - y.shape[2 + ax]]
        return F.pad(y, pad)


class ConvTranspose2dTorch(_ConvTransposeTorch):
    """NCHW; `forward(x, out_hw)`."""

    _conv = nn.ConvTranspose2d


class ConvTranspose3dTorch(_ConvTransposeTorch):
    """NCDHW; `forward(x, out_dhw)`."""

    _conv = nn.ConvTranspose3d


def _named(module: nn.Module, prefix: str, layers: Sequence[nn.Module]
           ) -> List[nn.Module]:
    """Register `layers` as `<prefix>_0`, `<prefix>_1`, ... (flax's names
    for a list attribute of `setup`) and return them as a list."""
    for i, layer in enumerate(layers):
        setattr(module, f"{prefix}_{i}", layer)
    return list(layers)


def _valid(n: int, k: int, s: int = 1) -> int:
    return (n - k) // s + 1


class AVSEModel(nn.Module):
    """Hou-et-al-style conv1d/conv3d encoder + FC fusion (main.py's model).

    a_shape: [B, 2, L] raw-FFT channels; v_shape: [B, 1, T, H, W]. Returns
    (a_out [B, 2, L], v_out [B, 1, T, H, W])."""

    def __init__(self, a_shape: Sequence[int], v_shape: Sequence[int]):
        super().__init__()
        self.a_shape, self.v_shape = tuple(a_shape), tuple(v_shape)
        # audio encoder: conv3 tanh, pool, conv5 relu, pool, conv5 relu, pool
        self.Conv_0 = nn.Conv1d(a_shape[1], 10, 3)
        self.Conv_1 = nn.Conv1d(10, 4, 5)
        self.Conv_2 = nn.Conv1d(4, 2, 5)
        la = ((_valid(a_shape[2], 3) // 2 - 4) // 2 - 4) // 2
        # visual encoder: three strided VALID conv3d, relu
        self.Conv_3 = nn.Conv3d(v_shape[1], 12, (3, 3, 3), (1, 2, 2))
        self.Conv_4 = nn.Conv3d(12, 6, (1, 3, 3), (1, 2, 2))
        self.Conv_5 = nn.Conv3d(6, 2, (1, 3, 3), (2, 2, 2))
        d, h, w = v_shape[2] - 2, _valid(v_shape[3], 3, 2), _valid(v_shape[4], 3, 2)
        h, w = _valid(h, 3, 2), _valid(w, 3, 2)
        d, h, w = _valid(d, 1, 2), _valid(h, 3, 2), _valid(w, 3, 2)
        self.Dense_0 = nn.Linear(2 * la + 2 * d * h * w, 512, bias=False)
        self.LayerNorm_0 = nn.LayerNorm(512, eps=LN_EPS)
        self.Dense_1 = nn.Linear(512, a_shape[1] * a_shape[2])
        self.Dense_2 = nn.Linear(512, math.prod(v_shape[1:]))

    def forward(self, x_a: torch.Tensor, x_v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        a = F.avg_pool1d(torch.tanh(self.Conv_0(x_a)), 2)
        a = F.avg_pool1d(F.relu(self.Conv_1(a)), 2)
        a = F.avg_pool1d(F.relu(self.Conv_2(a)), 2)
        v = F.relu(self.Conv_3(x_v))
        v = F.relu(self.Conv_4(v))
        v = F.relu(self.Conv_5(v))
        av = torch.cat([a.flatten(1), v.flatten(1)], dim=-1)
        av = F.leaky_relu(self.LayerNorm_0(self.Dense_0(av)), LEAKY_SLOPE)
        a_out = torch.tanh(self.Dense_1(av)).reshape((-1,) + self.a_shape[1:])
        v_out = F.leaky_relu(self.Dense_2(av), LEAKY_SLOPE)
        return a_out, v_out.reshape((-1,) + self.v_shape[1:])


def _plan_legacy_audio(stft_shape, v_frames, alpha):
    """(per-layer (in_ch, out_ch, stride), final (ch, t, s)) for the
    alpha-layer asymmetric-pad audio encoder (a copy of the JAX
    function)."""
    time_dim = float(stft_shape[2])
    n_div = 0
    while time_dim > v_frames:
        time_dim /= 2
        n_div += 1
    layers = []
    in_ch = stft_shape[1]
    t, s = stft_shape[2], stft_shape[3]
    for i in range(alpha):
        out_ch = in_ch * 2
        stride = (2, 2) if i < n_div else (1, 2)
        t = (t + 4 - 5) // stride[0] + 1
        s = (s + 4 - 5) // stride[1] + 1
        layers.append((in_ch, out_ch, stride))
        in_ch = out_ch
    return layers, (in_ch, t, s)


class AVModelSTFT(nn.Module):
    """Shape-adaptive STFT conv2d AE + conv3d visual AE + 1x3-conv fusion
    (train_autoencoder.py's model; `audio_ae_forward` is its objective).

    stft_shape: [B, 2, T, F]; v_shape: [B, 1, T_frames, H, W]. BatchNorm
    runs in train mode when the module does (`.train()`)."""

    def __init__(self, stft_shape: Sequence[int], v_shape: Sequence[int],
                 alpha: int = 8):
        super().__init__()
        self.stft_shape, self.v_shape = tuple(stft_shape), tuple(v_shape)
        audio_plan, (a_ch, a_t, a_s) = _plan_legacy_audio(
            stft_shape, v_shape[2], alpha)
        self.audio_enc_convs = _named(self, "audio_enc_convs", [
            nn.Conv2d(i, o, (5, 5), stride) for i, o, stride in audio_plan])
        self.audio_enc_bns = _named(self, "audio_enc_bns", [
            TorchBatchNorm(o) for _, o, _ in audio_plan])

        # visual encoder: conv3d(k3, p1) + BN + relu + maxpool(1, 2, 2),
        # doubling channels while spatial > max(a_s // 2, 1) (guarded)
        vis = []
        in_ch, spatial = 1, v_shape[3]
        while spatial > max(a_s // 2, 1) and spatial >= 2:
            vis.append((in_ch, in_ch * 2))
            in_ch *= 2
            spatial //= 2
        self.visual_enc_convs = _named(self, "visual_enc_convs", [
            nn.Conv3d(i, o, (3, 3, 3), padding=1) for i, o in vis])
        self.visual_enc_bns = _named(self, "visual_enc_bns", [
            TorchBatchNorm(o) for _, o in vis])

        v_flat_full = spatial * spatial
        self.pool_v = v_flat_full > a_s
        if self.pool_v:
            self.pool_div = max(int(v_flat_full / a_s), 1)
        else:
            self.pool_div = max(int(a_s / max(v_flat_full, 1)), 1)

        # featureNet: 1x3 convs halving the channels down to 1
        feat, c = [], a_ch + in_ch
        while c // 2 >= 1:
            feat.append((c, c // 2))
            c //= 2
            if c == 1:
                break
        self.feature_convs = _named(self, "feature_convs", [
            nn.Conv2d(i, o, (1, 3)) for i, o in feat])
        cat_s = (a_s // self.pool_div
                 if not self.pool_v and self.pool_div > 1 else a_s)
        self.fc = nn.Linear(c * a_t * cat_s, 512, bias=False)
        self.fc_ln = nn.LayerNorm(512, eps=LN_EPS)
        self.a_fc_out = nn.Linear(512, a_ch * a_t * a_s)
        self.v_fc_out = nn.Linear(512, in_ch * v_shape[2] * v_flat_full)

        # audio decoder
        a1, a2, a3 = (max(a_ch // d, 1) for d in (2, 4, 8))
        self.audio_up1 = ConvTranspose2dTorch(a_ch, a1, (5, 5), (2, 2), (2, 2))
        self.audio_up2 = ConvTranspose2dTorch(a1, a2, (5, 5), (2, 2), (2, 2))
        self.audio_up3 = ConvTranspose2dTorch(a2, a3, (5, 5), (1, 2), (2, 2))
        self.audio_up4 = ConvTranspose2dTorch(a3, 2, (3, 3), (1, 2), (1, 1))
        self.audio_dec_bns = _named(self, "audio_dec_bns", [
            TorchBatchNorm(c) for c in (a1, a2, a3)])

        # video decoder
        v1, v2, v3 = (max(in_ch // d, 1) for d in (2, 4, 8))
        k = (3, 3, 3)
        self.video_up1 = ConvTranspose3dTorch(in_ch, v1, k, (1, 4, 4), (1, 1, 1))
        self.video_up2 = ConvTranspose3dTorch(v1, v2, k, (1, 4, 4), (1, 1, 1))
        self.video_up3 = ConvTranspose3dTorch(v2, v3, k, (1, 2, 2), (1, 1, 1))
        self.video_up4 = ConvTranspose3dTorch(v3, 1, k, (1, 2, 2), (1, 1, 1))
        self.video_dec_bns = _named(self, "video_dec_bns", [
            TorchBatchNorm(c) for c in (v1, v2, v3)])

    # ---- encoders ----
    def audio_encode(self, x_a: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.audio_enc_convs, self.audio_enc_bns):
            # ZeroPad2d((2, 2, 3, 1)): W left/right 2, H top 3 / bottom 1
            x_a = torch.tanh(bn(conv(F.pad(x_a, (2, 2, 3, 1)))))
        return x_a

    def visual_encode(self, x_v: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.visual_enc_convs, self.visual_enc_bns):
            x_v = F.max_pool3d(F.relu(bn(conv(x_v))), (1, 2, 2))
        return x_v

    # ---- decoders ----
    def audio_decode(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        bns = self.audio_dec_bns
        x = torch.tanh(bns[0](self.audio_up1(x, (h * 2, w * 2))))
        x = torch.tanh(bns[1](self.audio_up2(x, (h * 4, w * 4))))
        x = torch.tanh(bns[2](self.audio_up3(x, (h * 4, w * 8))))
        return self.audio_up4(x, (h * 4, w * 16))

    def visual_decode(self, x: torch.Tensor) -> torch.Tensor:
        t, h, w = x.shape[2], x.shape[3], x.shape[4]
        bns = self.video_dec_bns
        x = F.relu(bns[0](self.video_up1(x, (t, h * 4, w * 4))))
        x = F.relu(bns[1](self.video_up2(x, (t, h * 16, w * 16))))
        x = F.relu(bns[2](self.video_up3(x, (t, h * 32, w * 32))))
        return torch.sigmoid(self.video_up4(x, (t, h * 64, w * 64)))

    def audio_ae_forward(self, x_a: torch.Tensor) -> torch.Tensor:
        """The STFT autoencoder path: train_autoencoder.py's objective."""
        return self.audio_decode(self.audio_encode(x_a))

    def visual_ae_forward(self, x_v: torch.Tensor) -> torch.Tensor:
        return self.visual_decode(self.visual_encode(x_v))

    def forward(self, x_a: torch.Tensor, x_v: torch.Tensor,
                train_ae: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        a_enc = self.audio_encode(x_a)
        v_enc = self.visual_encode(x_v)
        if train_ae:
            return self.audio_decode(a_enc), self.visual_decode(v_enc)
        v_flat = v_enc.flatten(3)
        a_cat = a_enc
        window = (1, self.pool_div)
        if self.pool_v and self.pool_div > 1:
            v_flat = F.max_pool2d(v_flat, window)
        elif not self.pool_v and self.pool_div > 1:
            a_cat = F.max_pool2d(a_cat, window)
        x = torch.cat([a_cat, v_flat], dim=1)
        for conv in self.feature_convs:
            x = F.relu(conv(F.pad(x, (1, 1))))
        av = F.relu(self.fc_ln(self.fc(x.flatten(1))))
        a_head = F.relu(self.a_fc_out(av)).reshape(a_enc.shape)
        v_head = F.relu(self.v_fc_out(av)).reshape(v_enc.shape)
        return self.audio_decode(a_head), self.visual_decode(v_head)
