"""The PyTorch port's frontend against the JAX package on the same numpy
inputs: STFT / iSTFT and their feature forms, the phasegram halves, the
bilinear resize, the window and the separation metrics. All fp32; the
tolerance is 1e-5 relative to the largest magnitude (FFT summation order
differs between pocketfft builds). Frames are broadband noise, so no FFT bin
sits near zero where angle() could flip by pi (docs/PARITY.md:107-112)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maavss_tpu.ops import image as j_image
from maavss_tpu.ops import metrics as j_metrics
from maavss_tpu.ops import phasegram as j_pg
from maavss_tpu.ops.windows import hamming_window as j_hamming
from maavss_tpu_torch.ops import image, metrics, phasegram
from maavss_tpu_torch.ops import stft as t_stft
from maavss_tpu_torch.ops.windows import hamming_window
from tests.test_torch_workers import share_cores

share_cores()

# the package's ops/__init__ re-exports the function `stft` under the
# module's name
j_stft = importlib.import_module("maavss_tpu.ops.stft")
RTOL = 1e-5


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, err


def audio(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_hamming_window():
    for n in (64, 256):
        close(hamming_window(n).numpy(), j_hamming(n))


# (fft_len, hop): the tests' geometry (hop 66 > fft 64: no overlap), the
# flagship's (fft 256, hop 66) and a dense overlap
GEOMS = [(64, 66), (256, 66), (64, 16)]


@pytest.mark.parametrize("fft_len,hop", GEOMS)
def test_stft_istft(fft_len, hop):
    x = audio((2, 3, 66 * 12))
    spec = t_stft.stft(torch.from_numpy(x), fft_len, hop)
    want = j_stft.stft(jnp.asarray(x), fft_len, hop)
    close(spec.numpy(), np.asarray(want))
    close(t_stft.istft(spec, fft_len, hop).numpy(),
          j_stft.istft(want, fft_len, hop))


@pytest.mark.parametrize("fft_len,hop", GEOMS)
@pytest.mark.parametrize("trim_end", [True, False])
def test_feature_forms(fft_len, hop, trim_end):
    x = audio((2, 66 * 12), seed=1)
    feats = t_stft.stft_features(torch.from_numpy(x), fft_len, hop,
                                 trim_end=trim_end)
    want = j_stft.stft_features(jnp.asarray(x), fft_len, hop,
                                trim_end=trim_end)
    close(feats.numpy(), want)
    close(t_stft.istft_features(feats, fft_len, hop, trim_end=trim_end,
                                length=x.shape[-1]).numpy(),
          j_stft.istft_features(want, fft_len, hop, trim_end=trim_end,
                                length=x.shape[-1]))


def test_istft_inverts_stft_with_overlap():
    x = audio((2, 66 * 12), seed=2)
    spec = t_stft.stft(torch.from_numpy(x), 256, 66)
    close(t_stft.istft(spec, 256, 66, length=x.shape[-1]).numpy(), x,
          rtol=1e-5)


@pytest.mark.parametrize("hw,resize", [(16, None), (24, (16, 16)),
                                       (12, (16, 16))])
def test_phasegram(hw, resize):
    frames = np.random.default_rng(3).uniform(0, 1, (2, 8, hw, hw)).astype(
        np.float32)
    rows = phasegram.phasegram_cumsum(torch.from_numpy(frames), resize=resize)
    want = j_pg.phasegram_cumsum(jnp.asarray(frames), resize=resize)
    close(rows.numpy(), want)
    close(phasegram.phasegram_window(rows[:, 2:6]).numpy(),
          j_pg.phasegram_window(want[:, 2:6]))


def test_phasegram_window_of_constant_frames_is_zero():
    rows = phasegram.phasegram_cumsum(torch.zeros(1, 4, 8, 8))
    pg = phasegram.phasegram_window(rows)
    assert pg.shape == (1, 1, 4, 64) and torch.all(pg == 0)


@pytest.mark.parametrize("size", [(16, 16), (40, 24), (7, 9)])
def test_resize_bilinear(size):
    x = np.random.default_rng(4).uniform(0, 1, (2, 3, 20, 20)).astype(
        np.float32)
    close(image.resize_bilinear(torch.from_numpy(x), size).numpy(),
          j_image.resize_bilinear(jnp.asarray(x), size))


def test_si_sdr_and_sdr():
    target = audio((3, 1000), seed=5)
    est = target + 0.3 * audio((3, 1000), seed=6)
    t_t, t_e = torch.from_numpy(target), torch.from_numpy(est)
    close(metrics.si_sdr(t_e, t_t).numpy(),
          j_metrics.si_sdr(jnp.asarray(est), jnp.asarray(target)))
    close(metrics.sdr(t_e, t_t).numpy(),
          j_metrics.sdr(jnp.asarray(est), jnp.asarray(target)))
