"""Time-aligned AV windowing math.

Each video frame spans exactly `hops_per_frame` STFT hops so audio and video
time axes stay aligned (reference: utilities.py:24-28). Defaults (16 kHz,
30 fps, hops_per_frame=8) give hop=66 samples, so a `num_frames`-frame clip
covers `hops_per_frame * num_frames` STFT frames.
"""

from __future__ import annotations


def calc_hop_size(num_frames: int, hops_per_frame: int, fps: int, sr: int):
    """Return (hop, audio_sample_len, num_fft_frames).

    hop              — STFT hop in samples: (sr/fps)/hops_per_frame, floored
    audio_sample_len — samples spanned by `num_frames` video frames
    num_fft_frames   — STFT frames covering that span (= hops_per_frame * num_frames)

    Parity: utilities.py:24-28.
    """
    hop = int((sr / fps) / hops_per_frame)
    audio_sample_len = int(hops_per_frame * hop * num_frames)
    num_fft_frames = audio_sample_len // hop
    return hop, audio_sample_len, num_fft_frames
