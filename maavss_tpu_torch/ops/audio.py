"""Waveform-domain ops: mono mix, peak normalisation, resampling and the
SoX contrast of --compress_audio (counterpart of maavss_tpu/ops/audio.py).

Torch ops on the input's device throughout. The resampler is the JAX
package's windowed-sinc polyphase filter (torchaudio's sinc_interp_hann
design), run as one strided `conv1d`; its filter bank is built on the host
in float64 and cast to float32, as the JAX package builds it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def mono_mix(audio: torch.Tensor) -> torch.Tensor:
    """Multi-channel [C, N] -> mono [N] by the mean over channels; 1-D
    audio is returned as it is."""
    if audio.ndim > 1:
        return audio.mean(dim=0)
    return audio


def peak_normalize(audio: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Divide by the peak absolute value (the intended op of the
    reference's normalize branch, as the JAX package implements it)."""
    return audio / (audio.abs().max() + eps)


def contrast(audio: torch.Tensor,
             enhancement_amount: float = 75.0) -> torch.Tensor:
    """The SoX contrast effect (torchaudio.functional.contrast), applied to
    the clean audio under --compress_audio."""
    c = enhancement_amount / 750.0
    return torch.sin(audio * (math.pi / 2.0)
                     + c * torch.sin(audio * 4.0 * math.pi))


def _resample_kernel(orig_freq: int, new_freq: int,
                     lowpass_filter_width: int = 6, rolloff: float = 0.99):
    """(filter bank [new, width] float32, width, orig, new) of the
    windowed-sinc polyphase resampler, on the host (a copy of
    maavss_tpu/ops/audio.py:_resample_kernel)."""
    gcd = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * (base_freq / orig)
    return kernel.astype(np.float32), width, orig, new


def resample(audio: torch.Tensor, orig_freq: int,
             new_freq: int) -> torch.Tensor:
    """Polyphase resample [..., N] -> [..., ceil(N * new / orig)]: the input
    padded by (width, width + orig), one conv1d of stride orig with the
    [new, 1, W] filter bank, the new phases interleaved."""
    if orig_freq == new_freq:
        return audio
    kernel, width, orig, new = _resample_kernel(orig_freq, new_freq)
    batch_shape = audio.shape[:-1]
    n = audio.shape[-1]
    x = F.pad(audio.reshape(-1, 1, n), (width, width + orig))
    k = torch.from_numpy(kernel).to(device=audio.device,
                                    dtype=audio.dtype)[:, None, :]
    y = F.conv1d(x, k, stride=orig)  # [B, new, frames]
    y = y.transpose(-2, -1).reshape(x.shape[0], -1)
    target_len = int(math.ceil(new * n / orig))
    return y[..., :target_len].reshape(batch_shape + (target_len,))


def audio_transforms(audio: torch.Tensor, sr: int, target_sr: int,
                     normalize: bool = False,
                     compress: bool = False) -> torch.Tensor:
    """Mono mix -> optional peak normalise -> resample -> optional
    compression (the reference's pipeline order, av_dataset.py:203-215)."""
    audio = mono_mix(audio)
    if normalize:
        audio = peak_normalize(audio)
    if sr != target_sr:
        audio = resample(audio, sr, target_sr)
    if compress:
        audio = contrast(audio)
    return audio
