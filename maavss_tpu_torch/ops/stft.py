"""STFT / iSTFT frontend (counterpart of maavss_tpu/ops/stft.py).

Same conventions as the JAX package: hamming window, `n_fft = fft_len`,
center=True with reflect padding, onesided, "window" normalization (the
spectrum divided by sqrt(sum(window^2))), features `[..., 2, T, F]` with the
last time frame always dropped and the Nyquist bin dropped under `trim_end`.
`istft` is the exact inverse of `stft` (overlap-add with division by the
summed squared-window envelope), not torch.istft's normalization.

`stft_features` on CUDA tensors takes one of two routes, picked by the
geometry alone (`stft_route`, as `lstm_backend` picks K1's):
- "kernel": one launch of the hand-written kernel of `csrc/stft_feat.cu`
  (window, reflect padding, a shared-memory FFT, the norm and, for polar
  features (--use_polar), magnitude and phase in its epilogue;
  power-of-two `fft_len` from 16 to 2048, forward only), through the
  registered op `maavss_tpu_torch::stft_feat` (ops/registry.py, its body
  `stft_feat_launch`), counted in `stft_features.launches`;
- "fft": every other `fft_len` (`stft_features_fft`): the plain framing and
  `torch.fft.rfft` (cuFFT; the JAX package leaves its FFT to XLA too), then
  for polar features K4's standalone magphase kernel (ops/cuda_complex.py).
On CPU tensors it runs `stft_features_plain`, the gather + rfft form with
K4's plain magphase.
Polar features go back through the polar kernel (ops/cuda_complex.py),
which writes the complex spectrum the inverse reads, Nyquist bin included.

Only the gather + rfft form of the plain forward is carried: the JAX
package's conv-STFT is a TPU matrix-unit execution of the same math.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from maavss_tpu_torch.ops.cuda_complex import (
    magphase,
    magphase_fwd_plain,
    polar_to_spectrum,
)
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


def stft_features_plain(audio: torch.Tensor, fft_len: int, hop: int,
                        normalized: bool = True, trim_end: bool = True,
                        polar: bool = False) -> torch.Tensor:
    """`stft_features` in plain PyTorch, on any device, any fft_len, under
    autograd: framing, rfft, norm, trim, stack, and K4's plain magphase."""
    spec = stft(audio, fft_len, hop, normalized=normalized)[..., :-1, :]
    if trim_end:
        spec = spec[..., :, :-1]
    feats = torch.stack([spec.real, spec.imag], dim=-3)
    return magphase_fwd_plain(feats) if polar else feats


STFT_KERNEL_FFT_LENS = (16, 2048)  # the power-of-two fft_len the kernel takes


def stft_kernel_refusal(fft_len: int, hop: int, samples: int
                        ) -> Optional[str]:
    """Why the STFT kernel cannot take this geometry, or None if it can."""
    lo, hi = STFT_KERNEL_FFT_LENS
    if not lo <= fft_len <= hi or fft_len & (fft_len - 1):
        return (f"the STFT kernel takes a power-of-two fft_len from {lo} to "
                f"{hi}, got {fft_len}")
    if hop < 1:
        return f"the STFT kernel needs hop >= 1, got {hop}"
    if samples <= fft_len // 2:
        return (f"reflect padding by fft_len // 2 = {fft_len // 2} needs "
                f"more than that many samples, got {samples}")
    return None


@functools.lru_cache(maxsize=None)
def _stft_tables(fft_len: int, device: torch.device):
    """(window [N] fp32, twiddles exp(-2 pi i k / N) [N / 2, 2] fp32, the
    window's norm as a host float) on `device`: the window and its norm by
    the plain path's own code on the same device, so the same fp32 values;
    the twiddles rounded from fp64. Read inside the STFT op at its first
    launch for (fft_len, device), and cached: a trace never reads a value
    from a device tensor."""
    window = hamming_window(fft_len, dtype=torch.float32, device=device)
    k = torch.arange(fft_len // 2, dtype=torch.float64)
    ang = -2.0 * math.pi * k / fft_len
    tw = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1).float()
    return window, tw.to(device), float(_window_norm(window).item())


def stft_route(fft_len: int, hop: int, samples: int) -> str:
    """"kernel" where the STFT kernel takes the geometry, else "fft"."""
    return "kernel" if stft_kernel_refusal(fft_len, hop, samples) is None \
        else "fft"


def stft_features_fft(audio: torch.Tensor, fft_len: int, hop: int,
                      normalized: bool = True, trim_end: bool = True,
                      polar: bool = False) -> torch.Tensor:
    """The "fft" route: the plain framing and rfft (cuFFT on the card), and
    under `polar` the magphase kernel (its plain version on the CPU)."""
    feats = stft_features_plain(audio, fft_len, hop, normalized, trim_end)
    return magphase(feats) if polar else feats


def stft_features(audio: torch.Tensor, fft_len: int, hop: int,
                  normalized: bool = True, trim_end: bool = True,
                  polar: bool = False) -> torch.Tensor:
    """Audio `[..., samples]` -> features `[..., 2, T, F]` of (real, imag),
    or (magnitude, phase) when `polar`; T = samples // hop.

    The last time frame is always dropped; the Nyquist bin is dropped when
    `trim_end` (av_dataset.py:171-174 in the reference). On CUDA it takes
    fp32 audio with no gradient and raises on anything else; by
    `stft_route`, one launch of the STFT kernel (whose audio's leading axes
    must collapse into one stride) or `stft_features_fft`. On the CPU the
    plain version."""
    if not audio.is_cuda:
        return stft_features_plain(audio, fft_len, hop, normalized,
                                   trim_end, polar)
    if audio.dtype != torch.float32:
        raise TypeError(f"stft_features: the STFT kernel takes float32 "
                        f"audio, got {audio.dtype}")
    if audio.requires_grad:
        raise ValueError("stft_features: the STFT kernel is forward only; "
                         "audio that needs a gradient takes "
                         "stft_features_plain")
    samples = audio.shape[-1]
    if stft_route(fft_len, hop, samples) == "fft":
        return stft_features_fft(audio, fft_len, hop, normalized, trim_end,
                                 polar)
    if _rows(audio) is None:
        raise ValueError(f"stft_features: the STFT kernel needs a contiguous "
                         f"last axis and leading axes of one stride, got "
                         f"strides {audio.stride()}")
    from maavss_tpu_torch.ops import registry

    return registry.call["stft_feat"](audio, fft_len, hop, normalized,
                                      trim_end, polar)


def _rows(audio: torch.Tensor) -> Optional[torch.Tensor]:
    """audio as [rows, samples] without a copy, or None where its leading
    axes do not collapse into one stride over a contiguous last axis."""
    samples = audio.shape[-1]
    try:
        rows = audio.view(-1, samples)
    except RuntimeError:
        return None
    return None if samples > 1 and rows.stride(1) != 1 else rows


def stft_feat_launch(audio: torch.Tensor, fft_len: int, hop: int,
                     normalized: bool, trim_end: bool, polar: bool
                     ) -> torch.Tensor:
    """The registered op `stft_feat` on CUDA (ops/registry.py): one launch
    of the STFT kernel on checked audio -> features [..., 2, T, F]."""
    from maavss_tpu_torch.ops import _build

    samples = audio.shape[-1]
    rows = _rows(audio)
    t_len = samples // hop
    f_len = fft_len // 2 if trim_end else fft_len // 2 + 1
    out = torch.empty(audio.shape[:-1] + (2, t_len, f_len),
                      dtype=torch.float32, device=audio.device)
    if out.numel() == 0:
        return out
    window, tw, norm = _stft_tables(fft_len, audio.device)
    _build.launch("maavss_stft_feat", audio.device, (
        rows.data_ptr(), rows.stride(0), rows.shape[0], samples, fft_len,
        hop, t_len, f_len, window.data_ptr(), tw.data_ptr(),
        norm if normalized else 0.0, int(polar), out.data_ptr()))
    stft_features.launches += 1
    return out


stft_features.launches = 0


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


def add_noise(x: torch.Tensor, noise_std,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Denoising objective input: x + N(0, 1) * noise_std
    (maavss_tpu/ops/stft.py:add_noise, av_dataset.py:217-220 in the
    reference), the normal draw from `generator` (the default generator of
    x's device when None) in x's dtype and shape; `noise_std` a Python
    float or a 0-d tensor on x's device."""
    noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                        device=x.device)
    return x + noise * noise_std
