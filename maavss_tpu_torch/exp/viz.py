"""Media export: the training media callback's images and audio
(counterpart of maavss_tpu/exp/viz.py).

The image functions (`filmstrip`, `stft_pair_image`, `phasegram_image`,
`latent_grid`) are the JAX module's numpy functions, the same arrays from
the same inputs. `save_image` writes what matplotlib's `imsave` writes for
a 2-D array, pixel for pixel, without matplotlib: the array normalised to
its own min and max in its dtype (matplotlib's `Normalize`), mapped
through the colormap's 256 colours as `Colormap.__call__(bytes=True)`
indexes them (x * 256, truncated, 1.0 to the last colour, NaN transparent
black), and written as an 8-bit RGBA PNG by `zlib`. The colours of magma
and viridis are the port's own copy of matplotlib 3.10.8's lookup tables,
as bytes (`colormaps.npz`). `png_pixels` reads such a file back.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

from maavss_tpu_torch.data.wavio import write_wav

_COLORMAPS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "colormaps.npz")
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _to_unit(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)  # uint8 inputs would wrap under subtraction
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def filmstrip(frames: np.ndarray, max_frames: int = 16) -> np.ndarray:
    """frames [T, H, W] -> one [H, T*W] strip (utilities.py:248-286)."""
    f = np.asarray(frames)[:max_frames]
    return np.concatenate(list(_to_unit(f)), axis=-1)


def stft_pair_image(y: np.ndarray, yh: np.ndarray) -> np.ndarray:
    """Target/output STFT panels stacked vertically, log magnitude
    (utilities.py:328-356). Inputs [2, T, F] (real/imag channels)."""

    def mag(s):
        m = np.sqrt(s[0] ** 2 + s[1] ** 2)
        return _to_unit(np.log1p(100.0 * m)).T[::-1]  # freq up, time right

    return np.concatenate([mag(np.asarray(y)), mag(np.asarray(yh))], axis=0)


def phasegram_image(y_pg: np.ndarray, yh_pg: np.ndarray) -> np.ndarray:
    """Phasegram target/output panels [1, T, S] -> [2T, S] image
    (utilities.py:288-326)."""
    a = _to_unit(np.asarray(y_pg)[0])
    b = _to_unit(np.asarray(yh_pg)[0])
    return np.concatenate([a, b], axis=0)


def latent_grid(latent: np.ndarray, cols: int = 16) -> np.ndarray:
    """Flat latent [D] -> [D/cols, cols] heat grid (utilities.py:359-380)."""
    v = np.asarray(latent).reshape(-1)
    rows = int(np.ceil(len(v) / cols))
    out = np.zeros(rows * cols, v.dtype)
    out[: len(v)] = v
    return _to_unit(out.reshape(rows, cols))


@functools.lru_cache(maxsize=None)
def colormap(name: str) -> np.ndarray:
    """The 256 RGBA colours of `name` (magma or viridis) as uint8 [256, 4]."""
    with np.load(_COLORMAPS) as z:
        if name not in z.files:
            raise ValueError(f"save_image: colormap {name!r} is not one of "
                             f"{', '.join(z.files)}")
        return z[name]


def to_rgba(img: np.ndarray, cmap: str = "magma") -> np.ndarray:
    """A 2-D array -> uint8 [H, W, 4], as imsave colours it."""
    x = np.asarray(img)
    if x.ndim != 2:
        raise ValueError(f"save_image takes a 2-D array, got {x.shape}")
    # Normalize.process_value: floats keep their dtype, small ints float32
    dtype = x.dtype
    if not np.issubdtype(dtype, np.floating):
        dtype = np.promote_types(dtype, np.float32)
    x = x.astype(dtype, copy=True)
    lo, hi = x.min(), x.max()
    if lo == hi:
        x.fill(0)
    else:
        x -= lo
        x /= hi - lo
    lut = colormap(cmap)
    n = len(lut)
    x *= n
    x[x == n] = n - 1
    under, over, bad = x < 0, x >= n, np.isnan(x)
    with np.errstate(invalid="ignore"):
        idx = x.astype(int)
    idx[under], idx[over] = 0, n - 1
    idx[bad] = n  # transparent black, after the colours
    return np.concatenate([lut, np.zeros((1, 4), np.uint8)]).take(idx, axis=0)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF)


def save_image(path: str, img: np.ndarray, cmap: str = "magma") -> str:
    """Write the 2-D array `img` as an RGBA PNG coloured by `cmap` (the
    pixels of matplotlib's `imsave(path, img, cmap=cmap)`), making its
    directory; returns the path."""
    rgba = to_rgba(img, cmap)
    h, w = rgba.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),  # filter 0 a row
                          rgba.reshape(h, 4 * w)], axis=1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
    return path


def png_pixels(path: str) -> np.ndarray:
    """The uint8 [H, W, 4] pixels of a PNG that `save_image` wrote (8-bit
    RGBA, not interlaced, every row filter 0); anything else raises."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_MAGIC):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, head = len(_PNG_MAGIC), b"", None
    while pos < len(data):
        (size,), kind = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + size]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + size:pos + 12 + size])[0]:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + size
    if head is None or head[2:] != (8, 6, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGBA PNG ({head})")
    w, h = head[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 4 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 4).copy()


def save_audio(path: str, wav: np.ndarray, sr: int = 16000) -> str:
    """Write `wav` (float32 samples) as a 16-bit PCM wav at `path`, making
    its directory; returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_wav(path, np.asarray(wav, np.float32), sr)
    return path


def reconstruction_callback(out_dir: str, step: int, y_stft: np.ndarray,
                            yh_stft: np.ndarray, audio_fn=None,
                            y_pgram: Optional[np.ndarray] = None,
                            yh_pgram: Optional[np.ndarray] = None,
                            frames: Optional[np.ndarray] = None,
                            sr: int = 16000) -> Sequence[str]:
    """Render the reference's per-cb_freq media set (train.py:170-178) to
    files under out_dir; returns written paths."""
    paths = [save_image(os.path.join(out_dir, f"stft_{step:07d}.png"),
                        stft_pair_image(y_stft, yh_stft))]
    if y_pgram is not None and yh_pgram is not None:
        paths.append(save_image(os.path.join(out_dir, f"pgram_{step:07d}.png"),
                                phasegram_image(y_pgram, yh_pgram)))
    if frames is not None:
        paths.append(save_image(os.path.join(out_dir, f"frames_{step:07d}.png"),
                                filmstrip(frames), cmap="viridis"))
    if audio_fn is not None:
        paths.append(save_audio(os.path.join(out_dir, f"audio_in_{step:07d}.wav"),
                                audio_fn(y_stft), sr))
        paths.append(save_audio(os.path.join(out_dir, f"audio_out_{step:07d}.wav"),
                                audio_fn(yh_stft), sr))
    return paths
