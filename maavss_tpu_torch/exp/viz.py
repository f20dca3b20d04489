"""Media export (counterpart of maavss_tpu/exp/viz.py, its `save_audio`).

The JAX module's matplotlib callbacks (spectrogram and frame images during
training) are not ported yet: ROADMAP "M6-rest (media)".
"""

from __future__ import annotations

import os

import numpy as np

from maavss_tpu_torch.data.wavio import write_wav


def save_audio(path: str, wav: np.ndarray, sr: int = 16000) -> str:
    """Write `wav` (float32 samples) as a 16-bit PCM wav at `path`, making
    its directory; returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_wav(path, np.asarray(wav, np.float32), sr)
    return path
