"""The STFT frontend's kernel route (maavss_tpu_torch/ops/stft.py,
csrc/stft_feat.cu) on the CPU: its eligibility check, the CPU route, and the
plain version against the JAX package's features.

`stft_features` takes the plain version on CPU tensors, any fft_len, with
gradients, and counts no launch; on CUDA tensors it runs the one-launch
kernel, which takes a power-of-two fft_len from 16 to 2048
(`stft_kernel_refusal`, a pure function, names the limit). The plain
version is held against JAX's `stft_features` here in one jitted call (rect
and polar at the tests' fft 64 and the flagship's 256; fp32, 1e-5 of the
largest magnitude; phases as wrapped differences weighted by magnitude, the
polar trap of ROADMAP §3). The `cuda`-marked tests hold the kernel against
the plain version on a card (chip_smoke.py's k4_stft phase holds the same
on more geometries).
"""

import functools
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu_torch.ops import stft as t_stft

j_stft = importlib.import_module("maavss_tpu.ops.stft")
# (fft_len, hop, samples): the tests' geometry and the flagship's
GEOMS = [(64, 16, 16 * 20), (256, 66, 66 * 12)]


def _audio(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=1)
def _jax_features():
    """{(fft_len, trim_end, polar): JAX features} on `_audio((2, s), n)`,
    every case in one jitted call."""
    keys = [(n, trim, polar) for n, _, _ in GEOMS for trim in (True, False)
            for polar in (False, True)]
    hops = {n: hop for n, hop, _ in GEOMS}

    def run(audios):
        return [j_stft.stft_features(audios[n], n, hops[n], trim_end=trim,
                                     polar=polar, pallas=False)
                for n, trim, polar in keys]

    audios = {n: jnp.asarray(_audio((2, s), n)) for n, _, s in GEOMS}
    return dict(zip(keys, map(np.asarray, jax.jit(run)(audios))))


@pytest.mark.parametrize("polar", [False, True], ids=["rect", "polar"])
@pytest.mark.parametrize("trim_end", [True, False])
@pytest.mark.parametrize("geom", GEOMS, ids=["fft64", "fft256"])
def test_plain_features_match_jax(geom, trim_end, polar):
    n, hop, s = geom
    got = t_stft.stft_features_plain(torch.from_numpy(_audio((2, s), n)), n,
                                     hop, trim_end=trim_end,
                                     polar=polar).numpy()
    want = _jax_features()[(n, trim_end, polar)]
    assert got.shape == want.shape == (2, 2, s // hop,
                                       n // 2 + (0 if trim_end else 1))
    if not polar:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        return
    mag = want[:, 0]
    assert np.abs(got[:, 0] - mag).max() <= 1e-5 * mag.max()
    dphi = np.abs(np.angle(np.exp(1j * (got[:, 1].astype(np.float64)
                                        - want[:, 1]))))
    assert (mag * dphi).max() <= 1e-5 * mag.max()


@pytest.mark.parametrize("polar", [False, True], ids=["rect", "polar"])
@pytest.mark.parametrize("normalized", [True, False])
def test_cpu_route_is_plain(normalized, polar):
    """On CPU tensors stft_features is the plain version bit for bit, over
    collapsible leading axes, and counts no launch."""
    t_stft.stft_features.launches = 0
    audio = torch.from_numpy(_audio((2, 3, 66 * 6), 5))
    for trim in (True, False):
        got = t_stft.stft_features(audio, 64, 66, normalized, trim, polar)
        want = t_stft.stft_features_plain(audio, 64, 66, normalized, trim,
                                          polar)
        assert got.shape == (2, 3, 2, 6, 32 + (0 if trim else 1))
        assert torch.equal(got, want)
    assert t_stft.stft_features.launches == 0


def test_cpu_route_takes_any_fft_len_and_gradients():
    """The CPU route has no kernel limit and differentiates the audio."""
    audio = torch.from_numpy(_audio((2, 400), 6)).requires_grad_(True)
    feats = t_stft.stft_features(audio, 48, 20)
    assert feats.shape == (2, 2, 20, 24)
    feats.square().sum().backward()
    assert audio.grad is not None and torch.isfinite(audio.grad).all()


@pytest.mark.parametrize("fft_len", [16, 32, 64, 256, 1024, 2048])
def test_kernel_takes_powers_of_two_16_to_2048(fft_len):
    assert t_stft.stft_kernel_refusal(fft_len, 16, 4096) is None


@pytest.mark.parametrize("fft_len", [8, 48, 100, 4096])
def test_kernel_refuses_other_fft_lens(fft_len):
    msg = t_stft.stft_kernel_refusal(fft_len, 16, 8192)
    assert msg is not None and "power-of-two fft_len from 16 to 2048" in msg
    assert str(fft_len) in msg


def test_kernel_refuses_short_audio_and_bad_hop():
    assert "more than" in t_stft.stft_kernel_refusal(64, 16, 32)
    assert t_stft.stft_kernel_refusal(64, 16, 33) is None
    assert "hop" in t_stft.stft_kernel_refusal(64, 0, 1000)


# ------------------------------------------------------------ on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode); "
                    "chip_smoke.py's k4_stft phase runs this comparison on "
                    "the card")


def _card_rel(got, want):
    return (torch.linalg.vector_norm((got - want).double())
            / torch.linalg.vector_norm(want.double())).item()


@pytest.mark.cuda
@pytest.mark.parametrize("fft_len,hop", [(64, 16), (256, 66), (2048, 512)])
def test_kernel_matches_plain_on_card(fft_len, hop):
    """(re, im) at rel L2 1e-6 and magnitudes likewise; phases as wrapped
    differences on bins above 1e-3 of the largest magnitude; the DC and
    Nyquist bins' imaginary parts exactly 0; one launch a call."""
    _card()
    audio = torch.from_numpy(_audio((3, hop * 40 + 7), 7)).cuda()
    for trim in (True, False):
        for normalized in (True, False):
            before = t_stft.stft_features.launches
            got = t_stft.stft_features(audio, fft_len, hop, normalized, trim)
            assert t_stft.stft_features.launches == before + 1
            want = t_stft.stft_features_plain(audio, fft_len, hop,
                                              normalized, trim)
            assert _card_rel(got, want) <= 1e-6
            assert not got[:, 1, :, 0].any()
            if not trim:
                assert not got[:, 1, :, -1].any()
            mp = t_stft.stft_features(audio, fft_len, hop, normalized, trim,
                                      polar=True)
            mag = want.square().sum(1).sqrt()
            assert _card_rel(mp[:, 0], mag) <= 1e-6
            keep = mag > 1e-3 * mag.max()
            dphi = torch.remainder(mp[:, 1] - torch.atan2(want[:, 1],
                                                          want[:, 0])
                                   + math.pi, 2 * math.pi) - math.pi
            assert dphi[keep].abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_kernel_raises_outside_its_limit_on_card():
    _card()
    audio = torch.zeros(2, 4096, device="cuda")
    with pytest.raises(ValueError, match="power-of-two fft_len"):
        t_stft.stft_features(audio, 48, 16)
    with pytest.raises(ValueError, match="forward only"):
        t_stft.stft_features(audio.requires_grad_(True), 64, 16)
