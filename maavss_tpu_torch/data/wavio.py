"""Minimal dependency-free WAV I/O (PCM16/24/32 + IEEE float32/64).

The reference reads/writes audio via torchaudio's sox/libsndfile bindings
(save_memmap.py:26-41, utilities.py:85-103). Training-time audio here comes
from the float32 memmap cache, so WAV parsing is only an ingest/export
concern — a small pure-numpy RIFF reader/writer keeps the data plane free of
torch/ffmpeg at runtime.

A copy of maavss_tpu/data/wavio.py (numpy only), pinned to it by
tests/test_torch_data.py: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (audio [channels, samples] float32 in [-1,1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 0xFFFE and len(body) >= 26:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", body[24:26])[0]
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            x = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
        elif bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")
    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels).T, int(sr)


def write_wav(path: str, audio: np.ndarray, sr: int, pcm16: bool = True) -> None:
    """audio [samples] or [channels, samples] float32 -> WAV file."""
    a = np.asarray(audio, np.float32)
    if a.ndim == 1:
        a = a[None, :]
    interleaved = a.T.reshape(-1)
    if pcm16:
        payload = (np.clip(interleaved, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        fmt_code, bits = 1, 16
    else:
        payload = interleaved.astype("<f4").tobytes()
        fmt_code, bits = 3, 32
    ch = a.shape[0]
    block = ch * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt_code, ch, sr, sr * block, block, bits)
    hdr += b"data" + struct.pack("<I", len(payload))
    with open(path, "wb") as f:
        f.write(hdr + payload)
