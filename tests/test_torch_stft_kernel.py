"""The STFT frontend's kernel route (maavss_tpu_torch/ops/stft.py,
csrc/stft_feat.cu) on the CPU: its eligibility check, the CPU route, and the
plain version against the JAX package's features.

`stft_features` takes the plain version on CPU tensors, any fft_len, with
gradients, and counts no launch; on CUDA tensors `stft_route` (a pure
function) sends it to the one-launch kernel, which takes a power-of-two
fft_len from 16 to 2048 (`stft_kernel_refusal` names the limit), or to the
"fft" route (cuFFT, and the magphase kernel for polar features) for any
other fft_len. The plain version and the "fft" route (which takes K4's
plain magphase on the CPU) are held against JAX's `stft_features` here,
one jitted call for each set of geometries (rect and polar at the tests'
fft 64, the flagship's 256 and the refused 4096; fp32, 1e-5 of the
largest magnitude; phases as wrapped differences weighted by magnitude on
bins of non-negligible magnitude, the polar trap of ROADMAP §3). The
`cuda`-marked tests hold both routes against the plain version on a card
(chip_smoke.py's k4_stft and stft_route phases hold the same on more
geometries).
"""

import functools
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu_torch.ops import cuda_complex as cc
from maavss_tpu_torch.ops import stft as t_stft
from tests.test_torch_workers import share_cores

share_cores()

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


FFT_GEOM = (4096, 66, 66 * 96)  # refused by the kernel: the "fft" route


@functools.lru_cache(maxsize=1)
def _jax_fft_features():
    """{polar: JAX features} at FFT_GEOM on `_audio((2, s), 4096)`, rect
    and polar in one jitted call."""
    n, hop, s = FFT_GEOM

    def run(audio):
        return [j_stft.stft_features(audio, n, hop, polar=polar,
                                     pallas=False) for polar in (False, True)]

    out = jax.jit(run)(jnp.asarray(_audio((2, s), n)))
    return dict(zip((False, True), map(np.asarray, out)))


def _close_to_jax(got, want, polar):
    """(re, im) within 1e-5 of the largest magnitude; (mag, phase): the
    magnitudes likewise and the phases as wrapped differences, weighted by
    magnitude, on bins above 1e-3 of the largest."""
    if not polar:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        return
    mag = want[:, 0]
    assert np.abs(got[:, 0] - mag).max() <= 1e-5 * mag.max()
    keep = mag > 1e-3 * mag.max()
    dphi = np.abs(np.angle(np.exp(1j * (got[:, 1].astype(np.float64)
                                        - want[:, 1]))))
    assert (mag * dphi)[keep].max() <= 1e-5 * mag.max()


@pytest.mark.parametrize("fft_len", [16, 32, 64, 128, 256, 512, 1024, 2048])
def test_route_takes_the_kernel_for_powers_of_two_16_to_2048(fft_len):
    assert t_stft.stft_route(fft_len, 16, 8192) == "kernel"


@pytest.mark.parametrize("fft_len", [4096, 8, 48])
def test_route_takes_fft_for_other_fft_lens(fft_len):
    assert t_stft.stft_route(fft_len, 16, 8192) == "fft"


@pytest.mark.parametrize("polar", [False, True], ids=["rect", "polar"])
def test_fft_route_matches_jax(polar):
    """The "fft" route's features at fft_len 4096 (on the CPU: the plain
    framing and rfft, K4's plain magphase) against JAX's."""
    n, hop, s = FFT_GEOM
    got = t_stft.stft_features_fft(torch.from_numpy(_audio((2, s), n)), n,
                                   hop, polar=polar).numpy()
    want = _jax_fft_features()[polar]
    assert got.shape == want.shape == (2, 2, s // hop, n // 2)
    _close_to_jax(got, want, polar)


@pytest.mark.parametrize("polar", [False, True], ids=["rect", "polar"])
def test_fft_route_on_cpu_is_plain(polar):
    """On CPU tensors the "fft" route is the plain version bit for bit and
    counts no launch of the STFT or the magphase kernel."""
    t_stft.stft_features.launches = 0
    cc.magphase_fwd.launches = 0
    audio = torch.from_numpy(_audio((2, 66 * 12), 8))
    got = t_stft.stft_features_fft(audio, 48, 66, polar=polar)
    assert torch.equal(got, t_stft.stft_features_plain(audio, 48, 66,
                                                       polar=polar))
    assert torch.equal(got, t_stft.stft_features(audio, 48, 66, polar=polar))
    assert t_stft.stft_features.launches == cc.magphase_fwd.launches == 0


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
    """The STFT kernel's launcher refuses fft_len 48 (stft_features routes
    it to cuFFT instead); stft_features still refuses audio that needs a
    gradient."""
    _card()
    from maavss_tpu_torch.ops import _build

    audio = torch.zeros(2, 4096, device="cuda")
    window, tw, norm = t_stft._stft_tables(48, audio.device)
    out = torch.empty(2, 2, 256, 24, device="cuda")
    with pytest.raises(RuntimeError, match="cudaError_t"):
        _build.launch("maavss_stft_feat", audio.device, (
            audio.data_ptr(), 4096, 2, 4096, 48, 16, 256, 24,
            window.data_ptr(), tw.data_ptr(), norm, 0, out.data_ptr()))
    with pytest.raises(ValueError, match="forward only"):
        t_stft.stft_features(audio.requires_grad_(True), 64, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("polar", [False, True], ids=["rect", "polar"])
def test_fft_route_on_card(polar):
    """At fft_len 4096 stft_features launches no STFT kernel: cuFFT, then
    under polar one launch of the magphase kernel; the plain version's
    values (the same rfft; magphase within 1e-6)."""
    _card()
    n, hop, s = FFT_GEOM
    audio = torch.from_numpy(_audio((3, s), 9)).cuda()
    stft0, mp0 = t_stft.stft_features.launches, cc.magphase_fwd.launches
    got = t_stft.stft_features(audio, n, hop, polar=polar)
    assert t_stft.stft_features.launches == stft0
    assert cc.magphase_fwd.launches == mp0 + int(polar)
    want = t_stft.stft_features_plain(audio, n, hop, polar=polar)
    assert _card_rel(got[:, 0], want[:, 0]) <= 1e-6
    if polar:
        mag = want[:, 0]
        dphi = torch.remainder(got[:, 1] - want[:, 1] + math.pi,
                               2 * math.pi) - math.pi
        assert dphi[mag > 1e-3 * mag.max()].abs().max().item() <= 1e-3
    else:
        assert torch.equal(got, want)
