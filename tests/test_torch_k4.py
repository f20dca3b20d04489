"""The port's complex-mask and polar functions (K4,
maavss_tpu_torch/ops/cuda_complex.py) against maavss_tpu/ops/pallas_kernels.py
on the CPU, and the K4 golden fixture tests/fixtures/torch_port_k4_golden.npz.

Kernel level: each plain version (the path a CPU tensor takes) against the
JAX function on the same numpy inputs, forward and VJP. The JAX side runs
its Pallas kernel in interpret mode (MAAVSS_MASK_IMPL=pallas for the mask;
`magphase` and `polar_to_rect` called directly) and also its default XLA
path (the jnp complex product, jnp.abs / jnp.angle, c0 * exp(i c1)).
Tolerance: relative L2 1e-6 (the same fp32 formulas; XLA may contract a
multiply-add or evaluate abs as a hypot); phases as the wrapped difference
angle(exp(i (a - b))), held to 1e-6 absolute on bins whose magnitude is
above 1e-3 of the largest. On atan2's branch cut (a negative real part with
an imaginary part of exactly +0.0 or -0.0) the phases must equal +pi and
-pi exactly on both sides. The card's kernels are held against these plain
versions by the `cuda`-marked tests below and by chip_smoke.py's k4 phase.

The golden: at the small geometry of tests/test_torch_train_golden.py
(fft 64, p 16, latent 8, fc 256, 4 frames, 4 windows, batch 4, lr 1e-3,
noise_scalar 0) it holds

- the weights as a seeded numpy recipe (`convert.random_flax_tree`);
- the JAX --mask_head separator's audio_out (MAAVSS_MASK_IMPL=pallas) and
  3 JAX train steps in mode 2 (losses, and per leaf of the final params
  and batch_stats the sum and the sum of absolute values, the conv biases
  that feed a train-mode BatchNorm and their running means left out);
- the JAX --use_polar separator's audio_out on the same weights, with the
  Pallas magphase (`stft_features(..., pallas=True)`) and polar kernels
  (MAAVSS_PALLAS_POLAR=1), in interpret mode.

- those JAX polar features of the clip (`feats_polar`, [B, 2, T, F]).

The batch is `synthetic_av_batch(seed=11)` with broadband frame noise, and
audio with a positive DC offset and broadband noise, so that no bin but
those of the first frame is near atan2's branch cut. The first frame is
real whatever the audio: centred on sample 0 and reflect-padded, it is
even-symmetric, so its bins' imaginary parts are rounding noise whose sign
(and so a phase of +pi or -pi) differs between FFT implementations (cuFFT
on the card, pocketfft here, JAX's ducc). The port's polar separator is
therefore fed the JAX features (`feats_polar`) in place of its own, on the
CPU here as in chip_smoke.py's k4_golden phase; the features themselves are
held against JAX in tests/test_torch_mask_polar.py with wrapped phases.
chip_smoke.py's k4_golden phase runs the port's kernels on the fixture.
Regenerate with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_k4.py

Tolerances of the port against the fixture on the CPU: audio relative L2
1e-4, losses relative 1e-5, leaf sums 1e-4 of the leaf's absolute sum.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch as jax_synthetic
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.ops import pallas_kernels as pk
from maavss_tpu.ops.stft import stft_features as jax_stft_features
from maavss_tpu.train import steps as jax_steps
from maavss_tpu.train.infer import make_separator as jax_separator
from maavss_tpu.train.state import create_train_state, make_optimizer
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    random_flax_tree,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.data.synthetic import synthetic_av_batch
from maavss_tpu_torch.ops import cuda_complex as cc
from maavss_tpu_torch.train import steps as port_steps
from maavss_tpu_torch.train.infer import make_separator
from maavss_tpu_torch.train.setup import build_fusion, build_fusion_state
from maavss_tpu_torch.train.steps import make_fusion_step
from tests.test_torch_workers import share_cores

share_cores()

TOL = 1e-6
# the fusion window, the frames middle-frame columns (F odd), two leading axes
SHAPES = [(2, 2, 16, 32), (2, 2, 4, 33), (2, 3, 2, 4, 8)]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64)
                                        - np.asarray(b, np.float64)))))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _special(shape, seed):
    """Gaussian planes with exact zeros, negative real parts over imaginary
    parts of +0.0 and -0.0, and values of exactly +-pi."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    u = rng.uniform(size=shape[:-3] + shape[-2:])
    re, im = x[..., 0, :, :], x[..., 1, :, :]
    re[u < 0.1] = 0.0
    im[u < 0.1] = 0.0
    cut = (u >= 0.1) & (u < 0.3)
    re[cut] = -np.abs(re[cut]) - 0.01
    im[cut & (u < 0.2)] = 0.0
    im[cut & (u >= 0.2)] = -0.0
    im[(u >= 0.3) & (u < 0.35)] = np.pi
    im[(u >= 0.35) & (u < 0.4)] = -np.pi
    return x


@pytest.fixture
def mask_impl(request, monkeypatch):
    monkeypatch.setenv("MAAVSS_MASK_IMPL", request.param)
    return request.param


def _jax_mask_xla(s, m):
    z = (s[..., 0, :, :] + 1j * s[..., 1, :, :]) * (
        m[..., 0, :, :] + 1j * m[..., 1, :, :])
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-3)


def _jax_magphase_xla(x):
    z = x[..., 0, :, :] + 1j * x[..., 1, :, :]
    return jnp.stack([jnp.abs(z), jnp.angle(z)], axis=-3)


def _jax_polar_xla(x):
    z = x[..., 0, :, :].astype(jnp.complex64) * jnp.exp(
        1j * x[..., 1, :, :].astype(jnp.complex64))
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-3)


def _port_vjp(fn, inputs, g):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_vjp(fn, inputs, g):
    out, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in inputs])
    return np.asarray(out), [np.asarray(d) for d in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("mask_impl", ["pallas", "xla"], indirect=True)
@pytest.mark.parametrize("shape", SHAPES)
def test_complex_mask_apply_matches_jax(mask_impl, shape):
    s, m, g = (_rand(shape, k) for k in (1, 2, 3))
    # MAAVSS_MASK_IMPL=pallas: the kernel and its conjugated VJP calls;
    # =xla: the fusable jnp product under the same custom VJP
    want, want_d = _jax_vjp(pk.complex_mask_apply, (s, m), g)
    got, got_d = _port_vjp(cc.complex_mask_apply, (s, m), g)
    assert _rel_l2(got, want) <= TOL
    for a, b in zip(got_d, want_d):
        assert _rel_l2(a, b) <= TOL
    # and the plain complex product, differentiated by JAX
    plain, plain_d = _jax_vjp(_jax_mask_xla, (s, m), g)
    assert _rel_l2(got, plain) <= TOL
    for a, b in zip(got_d, plain_d):
        assert _rel_l2(a, b) <= TOL


def _check_magphase(got, want):
    mag_g, ph_g = got[..., 0, :, :], got[..., 1, :, :]
    mag_w, ph_w = want[..., 0, :, :], want[..., 1, :, :]
    assert _rel_l2(mag_g, mag_w) <= TOL
    big = mag_w > 1e-3 * mag_w.max()
    assert _wrapped(ph_g, ph_w)[big].max() <= TOL


@pytest.mark.parametrize("path", ["pallas", "xla"])
@pytest.mark.parametrize("shape", SHAPES)
def test_magphase_matches_jax(path, shape):
    x, g = _rand(shape, 4), _rand(shape, 5)
    fn = pk.magphase if path == "pallas" else _jax_magphase_xla
    want, (want_d,) = _jax_vjp(fn, (x,), g)
    got, (got_d,) = _port_vjp(cc.magphase, (x,), g)
    _check_magphase(got, want)
    assert _rel_l2(got_d, want_d) <= TOL


@pytest.mark.parametrize("path", ["pallas", "xla"])
@pytest.mark.parametrize("shape", SHAPES)
def test_polar_to_rect_matches_jax(path, shape):
    x, g = _rand(shape, 6), _rand(shape, 7)
    fn = pk.polar_to_rect if path == "pallas" else _jax_polar_xla
    want, (want_d,) = _jax_vjp(fn, (x,), g)
    got, (got_d,) = _port_vjp(cc.polar_to_rect, (x,), g)
    assert _rel_l2(got, want) <= TOL
    assert _rel_l2(got_d, want_d) <= TOL


@pytest.mark.parametrize("pad_bins", [1, 0], ids=["trim_end", "untrimmed"])
def test_polar_to_spectrum_is_polar_to_rect_as_complex(pad_bins):
    """The iSTFT's spectrum form equals torch.complex of polar_to_rect's
    planes, padded with pad_bins zero bins (the trimmed Nyquist bin), on a
    strided view; its gradient equals autograd's through that composition."""
    full = torch.from_numpy(_special((2, 2, 20, 33), 18))
    x = full[:, :, 2:18].clone().requires_grad_(True)
    got = cc.polar_to_spectrum(x, pad_bins)
    rect = cc.polar_to_rect(x)
    want = torch.nn.functional.pad(
        torch.complex(rect[:, 0], rect[:, 1]), (0, pad_bins))
    assert got.dtype == torch.complex64 and got.shape == (2, 16, 33 + pad_bins)
    assert torch.equal(got, want)
    if pad_bins:
        assert not got[..., -1].any()
    g = torch.from_numpy(_rand((2, 16, 33 + pad_bins), 19)) * (1 + 0.5j)
    (got_d,) = torch.autograd.grad(got, x, g.to(torch.complex64))
    y = x.detach().clone().requires_grad_(True)
    want = torch.nn.functional.pad(
        torch.complex(y[:, 0] * torch.cos(y[:, 1]),
                      y[:, 0] * torch.sin(y[:, 1])), (0, pad_bins))
    (want_d,) = torch.autograd.grad(want, y, g.to(torch.complex64))
    torch.testing.assert_close(got_d, want_d, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(cc.polar_spectrum_fwd(x.detach(), pad_bins),
                               cc.polar_spectrum_fwd_plain(x.detach(),
                                                           pad_bins),
                               rtol=0, atol=0)


def test_branch_cut_and_zeros_match_jax():
    """Exact zeros give magnitude 0; a negative real part over +0.0 / -0.0
    gives +pi / -pi, in the port and in the JAX kernel alike; the polar
    conversion of those values and of phases +-pi matches too."""
    x = _special((2, 2, 16, 33), 8)
    got = cc.magphase(torch.from_numpy(x)).numpy()
    want = np.asarray(pk.magphase(jnp.asarray(x)))
    re, im = x[:, 0], x[:, 1]
    cut = (im == 0) & (re < 0)
    assert cut.sum() > 50
    expect = np.where(np.signbit(im[cut]), -np.pi, np.pi).astype(np.float32)
    np.testing.assert_array_equal(got[:, 1][cut], expect)
    np.testing.assert_array_equal(want[:, 1][cut], expect)
    zero = (re == 0) & (im == 0)
    assert zero.sum() > 20 and np.all(got[:, 0][zero] == 0)
    _check_magphase(got, want)
    back = cc.polar_to_rect(torch.from_numpy(x)).numpy()
    assert _rel_l2(back, np.asarray(pk.polar_to_rect(jnp.asarray(x)))) <= TOL
    mm = cc.complex_mask_apply(torch.from_numpy(x), torch.from_numpy(
        _special((2, 2, 16, 33), 9))).numpy()
    assert _rel_l2(mm, np.asarray(_jax_mask_xla(
        jnp.asarray(x), jnp.asarray(_special((2, 2, 16, 33), 9))))) <= TOL


@pytest.mark.parametrize("fn", [
    lambda x: cc.complex_mask_apply(x, x), cc.magphase, cc.polar_to_rect,
    lambda x: cc.mask_mul(x, x), cc.magphase_fwd, cc.polar_to_rect_plain,
    cc.polar_to_spectrum, cc.polar_spectrum_fwd,
], ids=["complex_mask_apply", "magphase", "polar_to_rect", "mask_mul",
        "magphase_fwd", "polar_to_rect_plain", "polar_to_spectrum",
        "polar_spectrum_fwd"])
def test_axis_minus_3_must_have_size_2(fn):
    """The JAX functions read channels 0 and 1 of any width (ROADMAP queue
    3); the port refuses anything but two."""
    with pytest.raises(ValueError, match="axis -3 must have size 2"):
        fn(torch.zeros(2, 4, 8, 16))
    with pytest.raises(ValueError, match="axis -3 must have size 2"):
        fn(torch.zeros(8, 16))


def test_wrappers_take_plain_path_on_cpu():
    """On CPU tensors the wrappers run their plain versions, strided
    operands included, and count no launch."""
    counters = (cc.mask_mul, cc.magphase_fwd, cc.polar_spectrum_fwd)
    for c in counters:
        c.launches = 0
    full = torch.from_numpy(_rand((2, 2, 24, 32), 10))
    a, b = full[:, :, 4:20], torch.from_numpy(_rand((2, 2, 16, 32), 11))
    for conj in (False, True):
        torch.testing.assert_close(cc.mask_mul(a, b, conj),
                                   cc.mask_mul_plain(a, b, conj), rtol=0,
                                   atol=0)
    torch.testing.assert_close(cc.magphase_fwd(a), cc.magphase_fwd_plain(a),
                               rtol=0, atol=0)
    torch.testing.assert_close(cc.polar_to_rect(a), cc.polar_fwd_plain(a),
                               rtol=0, atol=0)
    torch.testing.assert_close(cc.polar_spectrum_fwd(a, 1),
                               cc.polar_spectrum_fwd_plain(a, 1), rtol=0,
                               atol=0)
    assert [c.launches for c in counters] == [0, 0, 0]
    with pytest.raises(ValueError, match="shapes"):
        cc.mask_mul(a, b[:, :, :8])


def _read_as_kernel(t, lay):
    """What the kernel reads for tensor `t` given (items, item stride,
    plane stride, row stride): element [n, c, r, f] at
    n*bs + c*ps + r*rs + f from t's first element."""
    n, bs, ps, rs = lay
    storage = torch.as_strided(t, (t.untyped_storage().nbytes() // 4
                                   - t.storage_offset(),), (1,)).numpy()
    tt, f = t.shape[-2], t.shape[-1]
    idx = (np.arange(n)[:, None, None, None] * bs
           + np.arange(2)[None, :, None, None] * ps
           + np.arange(tt)[None, None, :, None] * rs
           + np.arange(f)[None, None, None, :])
    return storage[idx]


@pytest.mark.parametrize("case", ["contiguous", "fusion_window",
                                  "frames_middle", "two_leading_axes",
                                  "leading_slice"])
def test_kernel_layout_reads_the_view(case):
    """The strides the wrapper hands the kernel address exactly the view's
    elements, with no copy: the fusion separator's window of the clip, the
    frames model's middle-frame columns, collapsible leading axes."""
    base = torch.arange(3 * 4 * 2 * 24 * 33, dtype=torch.float32)
    views = {
        "contiguous": base[:2 * 2 * 24 * 33].view(2, 2, 24, 33),
        "fusion_window": base[:2 * 2 * 24 * 33].view(2, 2, 24, 33)[:, :,
                                                                  4:20],
        "frames_middle": base[:4 * 2 * 24 * 33].view(4, 2, 24, 33)[:, :,
                                                                  8:12],
        "two_leading_axes": base.view(3, 4, 2, 24, 33)[:, :, :, 2:6],
        "leading_slice": base.view(3, 4, 2, 24, 33)[1:, :, :, :5],
    }
    t = views[case]
    lay = cc._layout(t)
    assert lay is not None
    got = _read_as_kernel(t, lay)
    np.testing.assert_array_equal(got, t.reshape((-1,) + t.shape[-3:])
                                  .numpy())


def test_kernel_layout_refuses_what_it_cannot_read():
    base = torch.zeros(3, 4, 2, 8, 16)
    assert cc._layout(base[:, 1:3]) is None  # leading axes of two strides
    assert cc._layout(base.transpose(-1, -2)) is None  # last axis strided
    g = torch.zeros(2, 8, 16).expand(5, 2, 8, 16)  # a .sum()'s cotangent
    assert cc._layout(g) == (5, 0, 128, 16)


def test_mask_backward_launch_pattern(monkeypatch):
    """The mask product runs once forward and once backward when the STFT
    is data (d_mask only), twice backward when it needs a gradient."""
    calls = []
    real = cc.mask_mul

    def spy(a, b, conj=False):
        calls.append(conj)
        return real(a, b, conj)

    monkeypatch.setattr(cc, "mask_mul", spy)
    s = torch.from_numpy(_rand((2, 2, 8, 16), 12))
    m = torch.from_numpy(_rand((2, 2, 8, 16), 13)).requires_grad_(True)
    cc.complex_mask_apply(s, m).sum().backward()
    assert calls == [False, True]
    calls.clear()
    s.requires_grad_(True)
    cc.complex_mask_apply(s, m).square().sum().backward()
    assert calls == [False, True, True]


def _card(*arrays):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py's k4 phase runs this comparison "
                    "on the card")
    return [torch.from_numpy(a).cuda() for a in arrays]


def _card_rel(got, want):
    return (torch.linalg.vector_norm((got - want).double())
            / torch.linalg.vector_norm(want.double())).item()


@pytest.mark.cuda
def test_mask_mul_kernel_matches_plain_on_card():
    full, m = _card(_special((4, 2, 24, 33), 14), _rand((4, 2, 16, 33), 15))
    a = full[:, :, 4:20]
    for conj in (False, True):
        assert _card_rel(cc.mask_mul(a, m, conj),
                         cc.mask_mul_plain(a, m, conj)) <= TOL


@pytest.mark.cuda
def test_magphase_kernel_matches_plain_on_card():
    (x,) = _card(_special((4, 2, 24, 32), 16))
    got, want = cc.magphase_fwd(x), cc.magphase_fwd_plain(x)
    assert _card_rel(got, want) <= TOL
    cut = (x[:, 1] == 0) & (x[:, 0] < 0)
    assert torch.equal(got[:, 1][cut], want[:, 1][cut])


@pytest.mark.cuda
def test_polar_kernel_matches_plain_on_card():
    (x,) = _card(_special((4, 2, 24, 33), 17))
    assert _card_rel(cc.polar_to_rect(x[:, :, 2:]),
                     cc.polar_fwd_plain(x[:, :, 2:])) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("pad_bins", [1, 0], ids=["trim_end", "untrimmed"])
def test_polar_spectrum_kernel_matches_planar_on_card(pad_bins):
    """polar_to_rect is the spectrum's values bit for bit in planar order,
    the padded bins 0, and the spectrum agrees with its plain version."""
    (x,) = _card(_special((4, 2, 24, 33), 20))
    v = x[:, :, 2:]
    got = cc.polar_spectrum_fwd(v, pad_bins)
    rect = cc.polar_to_rect(v)
    assert torch.equal(torch.view_as_real(got[..., :33]),
                       torch.stack([rect[:, 0], rect[:, 1]], dim=-1))
    assert not got[..., 33:].any()
    want = cc.polar_spectrum_fwd_plain(v, pad_bins)
    assert _card_rel(torch.view_as_real(got), torch.view_as_real(want)) <= TOL


# ---------------------------------------------------------------- the golden

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "torch_port_k4_golden.npz")
GEOMETRY = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
                batch_size=4, noise_scalar=0.0)
SEED, STEPS, MODE = 2026, 3, 2
BATCH = dict(batch_seed=11, noise_seed=99, frames_noise=0.1, audio_dc=0.2,
             audio_noise=0.05)


def _jax_model(cfg, mask_head):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFusion(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla", mask_head=mask_head)


def golden_batch(cfg, meta, synthetic=synthetic_av_batch):
    """The synthetic batch with broadband frame noise, then a DC offset and
    broadband noise on the audio (one numpy stream, frames first; the same
    arithmetic as chip_smoke.py's k4_golden phase)."""
    batch = synthetic(cfg, cfg.batch_size, seed=meta["batch_seed"])
    rng = np.random.default_rng(meta["noise_seed"])
    batch["frames"] = np.clip(batch["frames"] + meta["frames_noise"] *
                              rng.standard_normal(batch["frames"].shape)
                              .astype(np.float32), 0.0, 1.0)
    batch["audio"] = (batch["audio"] + meta["audio_dc"] + meta["audio_noise"]
                      * rng.standard_normal(batch["audio"].shape)
                      .astype(np.float32)).astype(np.float32)
    return batch


def _bn_fed_paths():
    model, _ = build_fusion_state(RunConfig(**GEOMETRY),
                                  GEOMETRY["batch_size"], "cpu")
    paths = []
    for stack, mod in model.named_children():
        for conv, bn in getattr(mod, "names", ()):
            if bn is not None:
                paths += [f"params/{stack}/{conv}/bias",
                          f"batch_stats/{stack}/{bn}/BatchNorm_0/mean"]
    return sorted(paths)


def _sums(flat, left_out):
    return {k: [float(v.astype(np.float64).sum()),
                float(np.abs(v.astype(np.float64)).sum())]
            for k, v in flat.items() if k not in left_out}


def _jax_run(meta):
    """(mask audio, losses, final flat tree, polar audio, polar features)
    of the JAX reference with its K4 Pallas kernels in interpret mode."""
    tree = unflatten_tree(random_flax_tree(
        {k: tuple(v) for k, v in meta["shapes"].items()}, meta["seed"]))
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    cfg = JaxRunConfig(**meta["cfg"])
    batch = jax.tree_util.tree_map(
        jnp.asarray, golden_batch(cfg, meta, jax_synthetic))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAAVSS_MASK_IMPL", "pallas")
        mp.setenv("MAAVSS_PALLAS_POLAR", "1")
        mp.setattr(jax_steps, "stft_features",
                   functools.partial(jax_stft_features, pallas=True))
        mask_cfg = cfg.replace(mask_head=True)
        model = _jax_model(mask_cfg, True)
        state = create_train_state(variables,
                                   make_optimizer(cfg.learning_rate, "adam"))
        audio_mask = np.asarray(jax_separator(model, mask_cfg)(
            state, batch, jax.random.PRNGKey(0))["audio_out"])
        step = jax_steps.make_fusion_step(model, mask_cfg,
                                          window_mode="scan")
        losses = []
        for _ in range(STEPS):
            state, m = step(state, batch, jax.random.PRNGKey(0),
                            jnp.int32(meta["mode"]))
            losses.append(float(m["loss"]))
        final = flatten_tree(jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats}))
        polar_cfg = cfg.replace(use_polar=True)
        state = create_train_state(variables,
                                   make_optimizer(cfg.learning_rate, "adam"))
        audio_polar = np.asarray(jax_separator(
            _jax_model(polar_cfg, False), polar_cfg)(
                state, batch, jax.random.PRNGKey(0))["audio_out"])
        feats_polar = np.asarray(jax_stft_features(
            batch["audio"], cfg.fft_len, cfg.hop,
            normalized=cfg.normalize_fft, trim_end=True, polar=True,
            pallas=True))
    return audio_mask, losses, final, audio_polar, feats_polar


def make_golden(path: str = GOLDEN) -> None:
    cfg = JaxRunConfig(**GEOMETRY)
    model = _jax_model(cfg, True)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros(model.stft_shape),
                           jnp.zeros(model.pgram_shape), method=model.init_all)
    shapes = {k: list(v.shape) for k, v in flatten_tree(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}).items()}
    flat = random_flax_tree(shapes, SEED)
    meta = {"cfg": GEOMETRY, "seed": SEED, "shapes": shapes,
            "checksums": {k: float(v.astype(np.float64).sum())
                          for k, v in flat.items()},
            "mode": MODE, "window_mode": "scan", **BATCH,
            "bn_fed": _bn_fed_paths()}
    audio_mask, losses, final, audio_polar, feats_polar = _jax_run(meta)
    meta.update(losses=losses, sums=_sums(final, set(meta["bn_fed"])))
    np.savez_compressed(path, meta=json.dumps(meta), audio_mask=audio_mask,
                        audio_polar=audio_polar, feats_polar=feats_polar)


def _load():
    with np.load(GOLDEN) as z:
        return (json.loads(str(z["meta"])), z["audio_mask"],
                z["audio_polar"], z["feats_polar"])


def test_golden_recipe_regenerates():
    meta, audio_mask, audio_polar, _ = _load()
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    assert set(flat) == set(meta["checksums"])
    for k, total in meta["checksums"].items():
        assert np.isclose(flat[k].astype(np.float64).sum(), total,
                          rtol=1e-6, atol=1e-6), k
    assert set(meta["bn_fed"]) == set(_bn_fed_paths())
    assert set(meta["sums"]) == set(flat) - set(meta["bn_fed"])
    for audio in (audio_mask, audio_polar):
        assert audio.ndim == 2 and np.all(np.isfinite(audio))
    assert os.path.getsize(GOLDEN) < 200_000


def test_golden_matches_jax():
    """The fixture is still what the JAX reference computes (fp32, CPU)."""
    meta, audio_mask, audio_polar, feats_polar = _load()
    got_mask, losses, final, got_polar, got_feats = _jax_run(meta)
    np.testing.assert_allclose(got_mask, audio_mask, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_polar, audio_polar, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_feats, feats_polar, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(losses, meta["losses"], rtol=1e-6)
    for path, (total, abs_total) in meta["sums"].items():
        assert abs(final[path].astype(np.float64).sum() - total) <= (
            1e-6 * abs_total + 1e-9), path


def test_port_matches_golden_on_cpu():
    """The port's plain path on the fixture, with the fused-layer stack
    (the path the card runs); the polar separator on the JAX features."""
    meta, audio_mask, audio_polar, feats_polar = _load()
    tree = unflatten_tree(random_flax_tree(
        {k: tuple(v) for k, v in meta["shapes"].items()}, meta["seed"]))
    sd = from_flax(tree["params"], tree["batch_stats"])
    cfg = RunConfig(**meta["cfg"]).replace(pgenc_kernel="pallas")
    batch = golden_batch(cfg, meta)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    mask_cfg = cfg.replace(mask_head=True)
    model, state = build_fusion_state(mask_cfg, cfg.batch_size, "cpu")
    model.load_state_dict(sd)
    got = make_separator(model, mask_cfg)(tensors)["audio_out"].numpy()
    assert _rel_l2(got, audio_mask) <= 1e-4
    assert model.training  # the separator restores the train mode
    step = make_fusion_step(model, mask_cfg, device="cpu")
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch, meta["mode"])
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, meta["losses"], rtol=1e-5)
    params, stats = to_flax(model.state_dict())
    got_flat = flatten_tree({"params": params, "batch_stats": stats})
    for path, (total, abs_total) in meta["sums"].items():
        assert abs(got_flat[path].astype(np.float64).sum() - total) <= (
            1e-4 * abs_total + 1e-7), path
    polar_cfg = cfg.replace(use_polar=True)
    polar = build_fusion(polar_cfg, cfg.batch_size, "cpu")
    polar.load_state_dict(sd)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_steps, "stft_features",
                   lambda *args, **kwargs: torch.from_numpy(feats_polar))
        got = make_separator(polar, polar_cfg)(tensors)["audio_out"].numpy()
    assert _rel_l2(got, audio_polar) <= 1e-4


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    make_golden()
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
