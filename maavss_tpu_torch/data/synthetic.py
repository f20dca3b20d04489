"""Synthetic audio-visual batches and the on-disk synthetic store (a copy of
the numpy generators and `build_synthetic_store` of
maavss_tpu/data/synthetic.py:22-115, pinned to the original by
tests/test_torch_package.py and tests/test_torch_data.py).

Harmonic sine-sweep audio paired with a moving Gaussian blob whose position
follows the audio envelope, so audio and visual streams are correlated.
Host-side numpy, deterministic per seed. `build_synthetic_store` writes the
same streams as an ingested tree (frame shards, wavs, audio memmap) for
`--data_path synthetic`; `with_pgram_rows` turns a batch's frames into
--pgram_cache phasegram rows.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.ops.phasegram import phasegram_cumsum


def sine_sweep_audio(seed: int, batch: int, num_samples: int, sr: int = 16000) -> np.ndarray:
    """[B, num_samples] float32: per-item random fundamental with 3 harmonics,
    slow vibrato, and an LFO amplitude envelope."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_samples, dtype=np.float32) / sr
    out = np.zeros((batch, num_samples), np.float32)
    for b in range(batch):
        f0 = rng.uniform(110.0, 880.0)
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * rng.uniform(3.0, 7.0) * t)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t + rng.uniform(0, 2 * np.pi))
        sig = np.zeros_like(t)
        for k, amp in enumerate((1.0, 0.5, 0.25)):
            sig += amp * np.sin(2 * np.pi * f0 * (k + 1) * vib * t)
        out[b] = (0.3 * env * sig).astype(np.float32)
    return out


def moving_blob_frames(
    seed: int, batch: int, num_frames: int, size: int, envelope: np.ndarray = None
) -> np.ndarray:
    """[B, T, size, size] float32 in [0,1]: a Gaussian blob whose vertical
    position tracks `envelope` [B, T] (or a random walk)."""
    rng = np.random.default_rng(seed + 1)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    out = np.zeros((batch, num_frames, size, size), np.float32)
    sigma = max(size / 10.0, 1.5)
    for b in range(batch):
        cx = rng.uniform(0.3, 0.7) * size
        if envelope is None:
            pos = np.cumsum(rng.normal(0, 0.03, num_frames))
            pos = 0.5 + 0.3 * np.tanh(pos)
        else:
            e = envelope[b]
            e = (e - e.min()) / (np.ptp(e) + 1e-9)
            pos = 0.2 + 0.6 * e
        for ti in range(num_frames):
            cy = pos[ti] * size
            out[b, ti] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2))
    return out


def build_synthetic_store(out_dir: str, cfg: RunConfig, n_videos: int = 3,
                          seconds: float = 2.0, frame_size: int = None,
                          seed: int = 0):
    """Write a complete synthetic on-disk dataset (frame shards + wavs +
    audio memmap) and return (FrameShardStore, AudioMemmap).

    This is the CI stand-in for an ingested MUSICES tree: same storage
    contract the ingest tool produces, no video files needed (SURVEY.md §4).
    """
    import os

    from maavss_tpu_torch.data.audio_memmap import build_audio_memmap, AudioMemmap
    from maavss_tpu_torch.data.frame_shards import FrameShardStore, write_frame_shard
    from maavss_tpu_torch.data.wavio import write_wav

    fs = frame_size or cfg.p_size
    fps = cfg.framerate
    n_frames = int(seconds * fps)
    n_samples = int(seconds * cfg.samplerate)
    frames_dir = os.path.join(out_dir, "frames")
    audio_dir = os.path.join(out_dir, "audio")
    os.makedirs(audio_dir, exist_ok=True)
    wavs = []
    for v in range(n_videos):
        audio = sine_sweep_audio(seed + v, 1, n_samples, cfg.samplerate)[0]
        env = audio[: (n_samples // n_frames) * n_frames]
        env = np.sqrt((env.reshape(n_frames, -1) ** 2).mean(-1))[None]
        frames = moving_blob_frames(seed + v, 1, n_frames, fs, envelope=env)[0]
        write_frame_shard(frames_dir, f"vid{v:03d}",
                          (frames * 255).astype(np.uint8), fps, source="synthetic")
        wav = os.path.join(audio_dir, f"vid{v:03d}.wav")
        write_wav(wav, audio, cfg.samplerate)
        wavs.append(wav)
    build_audio_memmap(wavs, audio_dir, samplerate=cfg.samplerate)
    return FrameShardStore(frames_dir), AudioMemmap(audio_dir)


def synthetic_av_batch(cfg: RunConfig, batch: int, seed: int = 0,
                       frame_size: int = None) -> Dict[str, np.ndarray]:
    """One training batch for the windowed regimes:

    - 'audio':  [B, S_total] spanning num_frames + num_seq video frames,
    - 'frames': [B, T_total, fs, fs] blob frames whose motion follows the
      per-frame audio RMS envelope (fs defaults to cfg.p_size).
    """
    t_total = cfg.num_frames + cfg.num_seq + 2 * getattr(cfg, "frames_halo", 0)
    s_total = cfg.hop * cfg.hops_per_frame * t_total
    audio = sine_sweep_audio(seed, batch, s_total, cfg.samplerate)
    frame_env = audio.reshape(batch, t_total, -1)
    frame_env = np.sqrt((frame_env**2).mean(-1))  # per-video-frame RMS
    fs = frame_size or cfg.p_size
    frames = moving_blob_frames(seed, batch, t_total, fs, envelope=frame_env)
    return {"audio": audio, "frames": frames}


def with_pgram_rows(batch: Dict[str, np.ndarray], device="cpu"
                    ) -> Dict[str, np.ndarray]:
    """`batch` with its frames [B, T, p, p] replaced by their --pgram_cache
    rows: 'pgram' [B, T, p^2] float16, the frames' phasegram_cumsum
    computed on `device`, as bench.py:145-153 makes them."""
    frames = torch.from_numpy(batch["frames"]).to(device)
    rows = phasegram_cumsum(frames).to(torch.float16).cpu().numpy()
    return {"audio": batch["audio"], "pgram": rows}
