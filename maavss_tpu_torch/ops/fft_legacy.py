"""The legacy full-clip FFT frontend (counterpart of
maavss_tpu/ops/fft_legacy.py, the DataGenerator path of main.py).

A plain (not short-time) FFT over a whole audio window with the mirrored
half dropped, real/imag or (mag, phase) channels, and the "center_fft" bin
interleave (even bins flipped into the left half, odd bins on the right).
`torch.fft.fft` with norm="forward" (1/N) is cuFFT on the card.

Every function works on `[..., N]` audio or `[..., 2, N]` features.
"""

from __future__ import annotations

import torch


def _norm(normalize: bool) -> str:
    return "forward" if normalize else "backward"


def fft_half(audio: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """audio [..., N] -> complex [..., N//2]: the full FFT, mirrored half
    dropped."""
    f = torch.fft.fft(audio, dim=-1, norm=_norm(normalize))
    return f[..., : f.shape[-1] // 2]


def ifft_half(fft: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Inverse of `fft_half`: the mirror half comes back as zeros, not as
    the conjugate mirror (the reference's resynthesis, kept)."""
    full = torch.cat([fft, torch.zeros_like(fft)], dim=-1)
    return torch.fft.ifft(full, dim=-1, norm=_norm(normalize)).real


def complex_to_ri(fft: torch.Tensor) -> torch.Tensor:
    """complex [..., N] -> [..., 2, N] real/imag channels."""
    return torch.stack([fft.real, fft.imag], dim=-2)


def ri_to_complex(ri: torch.Tensor) -> torch.Tensor:
    """[..., 2, N] -> complex [..., N]."""
    return torch.complex(ri[..., 0, :], ri[..., 1, :])


def cartesian_to_polar(fft: torch.Tensor) -> torch.Tensor:
    """complex [..., N] -> [..., 2, N] (mag, phase) channels."""
    return torch.stack([fft.abs(), fft.angle()], dim=-2)


def polar_to_cartesian(polar: torch.Tensor) -> torch.Tensor:
    """[..., 2, N] (mag, phase) -> [..., 2, N] (real, imag)."""
    c = torch.polar(polar[..., 0, :], polar[..., 1, :])
    return torch.stack([c.real, c.imag], dim=-2)


def center_fft_bins(ri: torch.Tensor) -> torch.Tensor:
    """Even bins flipped into the left half, odd bins on the right, which
    puts the low frequencies at the center."""
    left = torch.flip(ri[..., ::2], dims=(-1,))
    return torch.cat([left, ri[..., 1::2]], dim=-1)


def decenter_fft_bins(ri: torch.Tensor) -> torch.Tensor:
    """Inverse of `center_fft_bins`."""
    n = ri.shape[-1]
    out = torch.zeros_like(ri)
    out[..., ::2] = torch.flip(ri[..., : n // 2], dims=(-1,))
    out[..., 1::2] = ri[..., n // 2:]
    return out


def process_fft(audio: torch.Tensor, normalize: bool = True,
                polar: bool = False, center: bool = False) -> torch.Tensor:
    """audio [..., N] -> features [..., 2, N//2]."""
    f = fft_half(audio, normalize)
    ri = cartesian_to_polar(f) if polar else complex_to_ri(f)
    return center_fft_bins(ri) if center else ri


def inference_to_audio(ri: torch.Tensor, normalize: bool = True,
                       polar: bool = False, center: bool = False
                       ) -> torch.Tensor:
    """features [..., 2, N//2] -> audio [..., N]."""
    if polar:
        ri = polar_to_cartesian(ri)
    if center:
        ri = decenter_fft_bins(ri)
    return ifft_half(ri_to_complex(ri), normalize)
