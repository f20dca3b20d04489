"""Inputs made from a seed on the device, in bulk.

Audio clips are harmonic tones (a fundamental of 80-800 Hz and its first
five overtones at 1/h amplitude, random phases) over white noise 20 dB
down, each clip at a gain drawn log-uniformly over the traffic's range,
so that clips differ in loudness as recordings do. Attention frames are a
Gaussian blob moving on a straight line across the clip, over uniform
noise of a tenth of its height (broadband, so that every FFT bin of a
frame has a defined phase), in [0, 1]. Phasegram rows are the cumulative
phase rows of such frames (`reference.layers.phase_rows`), stored in
float16 as an ingest step stores them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from perfbench.reference.layers import geometry, phase_rows


def mix(seed: int, stream: int) -> int:
    """A seed of its own for each use (stream) of one run's seed."""
    return (int(seed) * 1_000_003 + 7919 * int(stream)) % (2 ** 62)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, stream))


def audio(n: int, samples: int, samplerate: int, gain_db: Sequence[float],
          g: torch.Generator, device) -> torch.Tensor:
    """[n, samples] float32 clips."""
    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    t = torch.arange(samples, device=device, dtype=torch.float32) / samplerate
    f0 = 80.0 * 10.0 ** u(n, 1)  # 80-800 Hz, log-uniform
    out = torch.zeros(n, samples, device=device)
    for h in range(1, 7):
        phase = 2.0 * math.pi * u(n, 1)
        out += torch.sin(2.0 * math.pi * h * f0 * t + phase) / h
    out += 0.1 * torch.randn(n, samples, generator=g, device=device)
    lo, hi = gain_db
    gain = 10.0 ** ((lo + (hi - lo) * u(n, 1)) / 20.0)
    return out * (gain / 2.5)


def frames(n: int, t_len: int, size: int, g: torch.Generator, device
           ) -> torch.Tensor:
    """[n, t_len, size, size] float32 in [0, 1]."""
    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    start, end = u(n, 2), u(n, 2)
    sigma = (0.05 + 0.15 * u(n, 1, 1, 1)) * size
    grid = (torch.arange(size, device=device, dtype=torch.float32) + 0.5)
    frac = torch.linspace(0.0, 1.0, t_len, device=device)
    centre = (start[:, None] + (end - start)[:, None] * frac[None, :, None])
    centre = centre * size  # [n, t, 2]
    dy = (grid[None, None, :] - centre[..., 0:1]) ** 2  # [n, t, size]
    dx = (grid[None, None, :] - centre[..., 1:2]) ** 2
    blob = torch.exp(-(dy[..., :, None] + dx[..., None, :])
                     / (2.0 * sigma ** 2))
    noise = u(n, t_len, size, size)
    return (0.9 * blob + 0.1 * noise).clamp_(0.0, 1.0)


def frames_uint8(n: int, t_len: int, size: int, g: torch.Generator, device
                 ) -> torch.Tensor:
    return (frames(n, t_len, size, g, device) * 255.0).round_().to(
        torch.uint8)


def train_batches(cfg: Dict, traffic: Dict, seed: int, device
                  ) -> List[Dict[str, torch.Tensor]]:
    """The traffic's `distinct_batches` batches of `batch_size` clips: audio
    and, by `visual`, phasegram rows ('pgram_rows') or uint8 frames at the
    configuration's framesize ('frames_uint8')."""
    _, samples, _, t_len = geometry(cfg)
    b, n = traffic["batch_size"], traffic["distinct_batches"]
    g = generator(seed, 1, device)
    out = []
    for _ in range(n):
        batch = {"audio": audio(b, samples, cfg["samplerate"],
                                traffic["gain_db"], g, device)}
        if traffic["visual"] == "pgram_rows":
            fr = frames(b, t_len, cfg["p_size"], g, device)
            batch["pgram"] = phase_rows(fr).to(torch.float16)
        elif traffic["visual"] == "frames_uint8":
            batch["frames"] = frames_uint8(b, t_len, cfg["framesize"], g,
                                           device)
        else:
            raise ValueError(f"unknown visual input {traffic['visual']!r}")
        out.append(batch)
    return out
