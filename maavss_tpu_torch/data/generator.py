"""The legacy data generator: random AV windows with the full-clip FFT
frontend (counterpart of generator.py:DataGenerator, main.py's data).

Each example draws a random video and a random `num_frames` window of it
from one `np.random.default_rng(seed)`, in the JAX generator's order (video,
start, then one normal draw of noise per batch), so video, start and noise
are bit for bit the JAX generator's for one seed. Frames come from the
port's `FrameShardStore`, audio from its `AudioMemmap`; only the FFT
features go through torch (`ops/fft_legacy.process_fft`, on the CPU: the
batches are numpy, like the datasets', and the step copies them to the
device).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.data.audio_memmap import AudioMemmap
from maavss_tpu_torch.data.frame_shards import FrameShardStore
from maavss_tpu_torch.ops.fft_legacy import process_fft


class DataGenerator:
    def __init__(self, cfg: RunConfig, frames: FrameShardStore,
                 audio: AudioMemmap, seed: int = 0):
        self.cfg = cfg
        self.frames = frames
        self.audio = audio
        self._rng = np.random.default_rng(seed)
        self.samples_per_window = cfg.hop * cfg.hops_per_frame * cfg.num_frames

    def _example(self) -> Tuple[np.ndarray, np.ndarray]:
        """(frames [T, H, W] float32 in [0, 1], audio [S] float32) of one
        random window."""
        cfg = self.cfg
        v = int(self._rng.integers(0, len(self.frames)))
        n = self.frames.num_frames(v)
        if n < cfg.num_frames:
            raise ValueError(f"video {v} shorter than num_frames")
        start = int(self._rng.integers(0, n - cfg.num_frames + 1))
        fr = self.frames.read(v, np.arange(start, start + cfg.num_frames))
        fr = fr.astype(np.float32) / 255.0
        a_start = int(round(start * cfg.samplerate / cfg.framerate))
        return fr, self.audio.read(v, a_start, self.samples_per_window)

    def generator(self) -> Iterator:
        """Infinite batches (x_fft, y_fft, frames, audio), numpy: features
        [B, 2, S/2] (real/imag, or mag/phase under cfg.use_polar), x = y +
        noise in feature space, frames [B, 1, T, H, W], audio [B, S]."""
        cfg = self.cfg
        while True:
            frs, aus = zip(*(self._example() for _ in range(cfg.batch_size)))
            frames = np.stack(frs)[:, None]
            audio = np.stack(aus)
            y_fft = process_fft(torch.from_numpy(audio),
                                normalize=cfg.normalize_fft,
                                polar=cfg.use_polar).numpy()
            noise = self._rng.normal(0, cfg.noise_scalar,
                                     y_fft.shape).astype(np.float32)
            yield y_fft + noise, y_fft, frames, audio
