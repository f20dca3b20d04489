"""The port's waveform ops (maavss_tpu_torch/ops/audio.py) and the
feature options that use them or the frames, against the JAX package on
the same seeded numpy inputs, on the CPU:

- mono_mix, peak_normalize, contrast, resample (44100 -> 16000, 48000 ->
  16000, 8000 -> 16000, batched) and audio_transforms within 1e-6
  relative to each result's largest magnitude;
- --compress_audio: `_prep_stft_pair` at noise 0, both STFT trims, within
  1e-6;
- --attn_diff: `attn_diff_frames` on uint8 (through `_vis_frames`) and
  float frames, `_pflat_from_batch` on raw frames, and the ValueError, word
  for word, when the batch holds precomputed phasegram rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.ops import audio as jax_audio
from maavss_tpu.train import steps as jax_steps
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.ops import audio
from maavss_tpu_torch.train import steps
from tests.test_torch_workers import share_cores

share_cores()

RTOL = 1e-6
SMALL = dict(num_frames=4, num_seq=4, fft_len=64, p_size=16, latent_chan=8,
             fc_size=256, batch_size=2, noise_scalar=0.0)


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


def _audio(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(
        np.float32)


@pytest.mark.parametrize("fn,args", [
    ("mono_mix", ((2, 900),)), ("mono_mix", ((900,),)),
    ("peak_normalize", ((900,),)), ("contrast", ((3, 900),)),
], ids=["mono_mix-stereo", "mono_mix-mono", "peak_normalize", "contrast"])
def test_pointwise_ops_match_jax(fn, args):
    x = _audio(args[0])
    want = getattr(jax_audio, fn)(jnp.asarray(x))
    got = getattr(audio, fn)(torch.from_numpy(x))
    close(got.numpy(), want)


@pytest.mark.parametrize("orig,new", [(44100, 16000), (48000, 16000),
                                      (8000, 16000)])
def test_resample_matches_jax(orig, new):
    x = _audio((2, 3, orig // 20), seed=orig)
    want = jax_audio.resample(jnp.asarray(x), orig, new)
    got = audio.resample(torch.from_numpy(x), orig, new)
    assert got.shape[-1] == -(-x.shape[-1] * new // orig)
    close(got.numpy(), want)
    same = torch.from_numpy(x)
    assert audio.resample(same, new, new) is same


def test_audio_transforms_match_jax():
    x = _audio((2, 4410), seed=5)
    want = jax_audio.audio_transforms(jnp.asarray(x), 44100, 16000,
                                      normalize=True, compress=True)
    got = audio.audio_transforms(torch.from_numpy(x), 44100, 16000,
                                 normalize=True, compress=True)
    close(got.numpy(), want)


@pytest.mark.parametrize("trim_end", [True, False])
def test_compress_audio_features_match_jax(trim_end):
    x = _audio((2, 66 * 4 * 8), seed=7)
    cfg_j = JaxRunConfig(**SMALL).replace(compress_audio=True)
    cfg = RunConfig(**SMALL).replace(compress_audio=True)
    want = jax_steps._prep_stft_pair(jnp.asarray(x), cfg_j,
                                     jax.random.PRNGKey(0), trim_end, False)
    got = steps._prep_stft_pair(torch.from_numpy(x), cfg, None, trim_end,
                                False)
    for g, w in zip(got, want):
        close(g.numpy(), w)
    plain = steps._prep_stft_pair(torch.from_numpy(x),
                                  cfg.replace(compress_audio=False), None,
                                  trim_end, False)[1]
    assert not torch.allclose(plain, got[1])  # the option acts


def _frames(dtype, seed=3):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, (2, 5, 16, 16)).astype(np.uint8)
    return rng.uniform(0, 1, (2, 5, 16, 16)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_attn_diff_frames_match_jax(dtype):
    fr = _frames(dtype)
    cfg_j = JaxRunConfig(**SMALL).replace(attn_diff=True)
    cfg = RunConfig(**SMALL).replace(attn_diff=True)
    want = jax_steps._vis_frames({"frames": jnp.asarray(fr)}, cfg_j)
    got = steps._vis_frames({"frames": torch.from_numpy(fr)}, cfg)
    assert got.dtype == torch.float32
    close(got.numpy(), want)
    assert not got[:, 0].any()  # the zero first frame
    raw = jax_steps.frames_f32(jnp.asarray(fr))
    close(steps.attn_diff_frames(steps.frames_f32(torch.from_numpy(fr)))
          .numpy(), jax_steps.attn_diff_frames(raw))
    off = steps._vis_frames({"frames": torch.from_numpy(fr)},
                            cfg.replace(attn_diff=False))
    close(off.numpy(), raw)


@pytest.mark.parametrize("attn_diff", [True, False])
def test_pflat_from_batch_matches_jax(attn_diff):
    fr = _frames("float32", seed=4)
    cfg_j = JaxRunConfig(**SMALL).replace(attn_diff=attn_diff)
    cfg = RunConfig(**SMALL).replace(attn_diff=attn_diff)
    want = jax_steps._pflat_from_batch({"frames": jnp.asarray(fr)}, cfg_j)
    got = steps._pflat_from_batch({"frames": torch.from_numpy(fr)}, cfg)
    close(got.numpy(), want, rtol=1e-5)


def test_attn_diff_with_pgram_rows_raises_jax_message():
    rows = np.zeros((2, 5, 256), np.float16)
    with pytest.raises(ValueError) as want:
        jax_steps._pflat_from_batch(
            {"pgram": jnp.asarray(rows)},
            JaxRunConfig(**SMALL).replace(attn_diff=True))
    with pytest.raises(ValueError) as got:
        steps._pflat_from_batch({"pgram": torch.from_numpy(rows)},
                                RunConfig(**SMALL).replace(attn_diff=True))
    assert str(got.value) == str(want.value)
