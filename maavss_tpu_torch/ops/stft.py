"""STFT / iSTFT frontend (counterpart of maavss_tpu/ops/stft.py).

Same conventions as the JAX package: hamming window, `n_fft = fft_len`,
center=True with reflect padding, onesided, "window" normalization (the
spectrum divided by sqrt(sum(window^2))), features `[..., 2, T, F]` with the
last time frame always dropped and the Nyquist bin dropped under `trim_end`.
`istft` is the exact inverse of `stft` (overlap-add with division by the
summed squared-window envelope), not torch.istft's normalization.

Polar features (`polar=True`, --use_polar) are (magnitude, phase) from the
magphase kernel, and go back through the polar kernel (ops/cuda_complex.py),
which writes the complex spectrum the inverse reads, Nyquist bin included.

Only the gather + rfft form of the forward is carried: the JAX package's
conv-STFT is a TPU matrix-unit execution of the same math.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from maavss_tpu_torch.ops.cuda_complex import magphase, polar_to_spectrum
from maavss_tpu_torch.ops.windows import hamming_window


def frame_signal(audio: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Slice `audio[..., samples]` into overlapping frames
    `[..., 1 + samples // hop, frame_len]`, centered: the signal is
    reflect-padded by frame_len//2 on both sides (torch.stft's default)."""
    pad = frame_len // 2
    lead = audio.shape[:-1]
    audio = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad),
                  mode="reflect").reshape(lead + (-1,))
    return audio.unfold(-1, frame_len, hop)


def _window_norm(window: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(window.to(torch.float32) ** 2))


def stft(audio: torch.Tensor, fft_len: int, hop: int,
         normalized: bool = True) -> torch.Tensor:
    """Complex STFT `[..., T, F]` with F = fft_len//2 + 1 (time-major)."""
    window = hamming_window(fft_len, dtype=audio.dtype, device=audio.device)
    frames = frame_signal(audio, fft_len, hop) * window
    spec = torch.fft.rfft(frames, n=fft_len, dim=-1)
    if normalized:
        spec = spec / _window_norm(window)
    return spec


def istft(spec: torch.Tensor, fft_len: int, hop: int,
          normalized: bool = True, length: Optional[int] = None
          ) -> torch.Tensor:
    """Exact inverse of `stft`: `[..., T, F]` complex -> `[..., samples]`.

    Overlap-add (`F.fold`) with division by the summed squared-window
    envelope, eps-guarded where it vanishes. Default output length is T*hop.
    """
    window = hamming_window(fft_len, dtype=torch.float32, device=spec.device)
    n_frames = spec.shape[-2]
    if normalized:
        spec = spec * _window_norm(window)
    frames = torch.fft.irfft(spec, n=fft_len, dim=-1) * window  # [..., T, L]

    out_len = (n_frames - 1) * hop + fft_len
    lead = frames.shape[:-2]

    def overlap_add(fr: torch.Tensor) -> torch.Tensor:  # [N, T, L] -> [N, out]
        cols = fr.transpose(1, 2)  # [N, L, T]: fold's (C*kh*kw, blocks) layout
        return F.fold(cols, (1, out_len), (1, fft_len),
                      stride=(1, hop)).reshape(fr.shape[0], out_len)

    sig = overlap_add(frames.reshape((-1, n_frames, fft_len)))
    w2 = (window.to(torch.float32) ** 2).expand(1, n_frames, fft_len)
    env = overlap_add(w2.contiguous())[0]
    sig = (sig / torch.clamp(env, min=1e-11)).reshape(lead + (out_len,))

    pad = fft_len // 2  # the forward's centering
    sig = sig[..., pad:out_len - pad]
    if length is None:
        length = n_frames * hop
    if sig.shape[-1] < length:
        sig = F.pad(sig, (0, length - sig.shape[-1]))
    return sig[..., :length]


def stft_features(audio: torch.Tensor, fft_len: int, hop: int,
                  normalized: bool = True, trim_end: bool = True,
                  polar: bool = False) -> torch.Tensor:
    """Audio `[..., samples]` -> features `[..., 2, T, F]` of (real, imag),
    or (magnitude, phase) through the magphase kernel when `polar`.

    The last time frame is always dropped; the Nyquist bin is dropped when
    `trim_end` (av_dataset.py:171-174 in the reference)."""
    spec = stft(audio, fft_len, hop, normalized=normalized)[..., :-1, :]
    if trim_end:
        spec = spec[..., :, :-1]
    feats = torch.stack([spec.real, spec.imag], dim=-3)
    return magphase(feats) if polar else feats


def istft_features(feats: torch.Tensor, fft_len: int, hop: int,
                   normalized: bool = True, trim_end: bool = True,
                   polar: bool = False, length: Optional[int] = None
                   ) -> torch.Tensor:
    """Features `[..., 2, T, F]` -> audio `[..., samples]`. (magnitude,
    phase) features become the complex spectrum in one launch of the polar
    kernel when `polar`. Re-pads the trimmed Nyquist bin with zeros."""
    if polar:
        spec = polar_to_spectrum(feats, 1 if trim_end else 0)
    else:
        spec = torch.complex(feats[..., 0, :, :].contiguous(),
                             feats[..., 1, :, :].contiguous())
        if trim_end:
            spec = F.pad(spec, (0, 1))
    return istft(spec, fft_len, hop, normalized=normalized, length=length)
