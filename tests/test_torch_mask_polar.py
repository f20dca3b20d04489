"""The `--mask_head` and `--use_polar` paths of both model families in the
port against the JAX package, on the CPU: the models' forward, the train
steps, the features and the separators, on the same numpy inputs and the
same weights (carried across by `convert.from_flax`).

Geometries: the fusion model at tests/test_torch_train_step.py's (fft 64,
p 16, latent 8, fc 256, 4 frames, 4 windows), the frames model at
tests/test_torch_frames_step.py's (framesize 24, 2 frames, 2 windows, fft
64, latent 8), batch 2, lr 1e-3, noise_scalar 0, mode 2. The JAX mask head
runs its Pallas kernel in interpret mode (MAAVSS_MASK_IMPL=pallas). The
audio is the synthetic harmonic sweep plus a positive DC offset and
broadband noise (numpy seed), the frames the blobs plus broadband noise.

The polar trap: a clip's first STFT frame is real whatever the audio (it is
centred on sample 0 and reflect-padded, so even-symmetric), and the sign of
its rounding-noise imaginary parts, hence a phase of +pi or -pi, differs
between torch's and JAX's FFTs. The features are compared as wrapped phase
differences angle(exp(i (a - b))), weighted by the bin's magnitude (an
error of 1e-6 of the largest magnitude in re or im); the separators and
train steps under --use_polar feed the port's features to the JAX side
(`maavss_tpu.train.steps.stft_features` replaced), so both run the model on
the same inputs.

Tolerances: model outputs 1e-4 of their largest magnitude; losses relative
1e-4 per step over 3 steps (measured ~1e-6); leaves after step 1 relative
L2 1e-4, except the conv biases that feed a train-mode BatchNorm (fusion:
held within lr of their start on both sides) and the frames model's
BatchNorm shifts (2e-3 lr per element), as tests/test_torch_train_step.py
and tests/test_torch_frames_step.py explain; separated audio relative L2
1e-4.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.models.fusion_frames import AVFusionFramesModel as JaxFrames
from maavss_tpu.ops.stft import istft_features as jax_istft_features
from maavss_tpu.ops.stft import stft_features as jax_stft_features
from maavss_tpu.train import steps as jax_steps
from maavss_tpu.train.infer import make_frames_separator as jax_frames_sep
from maavss_tpu.train.infer import make_separator as jax_separator
from maavss_tpu.train.state import create_train_state, make_optimizer
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.data.synthetic import synthetic_av_batch
from maavss_tpu_torch.ops import cuda_complex as cc
from maavss_tpu_torch.ops import cuda_mask_head as cmh
from maavss_tpu_torch.ops.stft import istft_features, stft_features
from maavss_tpu_torch.train import steps as port_steps
from maavss_tpu_torch.train.infer import make_frames_separator, make_separator
from maavss_tpu_torch.train.setup import (
    build_frames_model,
    build_frames_state,
    build_fusion,
    build_fusion_state,
)
from tests.test_torch_workers import share_cores

share_cores()

FUSION = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
              p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
              batch_size=2, noise_scalar=0.0)
FRAMES = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
              framesize=24, learning_rate=1e-3, batch_size=2,
              noise_scalar=0.0)
LATENT = 8
STEPS = 3
LR = 1e-3


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _family(frames):
    return (FRAMES if frames else FUSION), frames


def _jax_model(cfg, frames, mask_head, mid=None):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    b = cfg.batch_size
    if frames:
        return JaxFrames(
            stft_shape=(b, 2, t_stft, cfg.fft_len // 2 + 1),
            frame_shape=(b, 1, cfg.num_frames, cfg.framesize, cfg.framesize),
            hops_per_frame=cfg.hops_per_frame, latent_channels=LATENT,
            mask_head=mask_head,
            mask_mid_frame=(cfg.num_seq - 1) // 2 if mid is None else mid)
    return JaxFusion(
        stft_shape=(b, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(b, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla", mask_head=mask_head)


def _jax_init(model, frames):
    """A fresh copy of the model's flax init (`_jax_init_once`)."""
    return jax.tree_util.tree_map(np.copy, _jax_init_once(model, frames))


@functools.lru_cache(maxsize=None)
def _jax_init_once(model, frames):
    """model.init under one jit, once a model: the same values as the eager
    init, which compiles a truncated normal for every kernel shape on its
    own (25-31 s for a family's first model on the CPU)."""
    second = model.frame_shape if frames else model.pgram_shape
    v = jax.jit(lambda key: model.init(key, jnp.zeros(model.stft_shape),
                                       jnp.zeros(second),
                                       method=model.init_all))(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, v)


def _batch(cfg, frames):
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=11,
                               frame_size=cfg.framesize if frames else None)
    rng = np.random.default_rng(99)
    batch["frames"] = np.clip(batch["frames"] + 0.1 * rng.standard_normal(
        batch["frames"].shape).astype(np.float32), 0.0, 1.0)
    batch["audio"] = (batch["audio"] + 0.2 + 0.05 * rng.standard_normal(
        batch["audio"].shape).astype(np.float32)).astype(np.float32)
    return batch


def _port_state(cfg, frames, variables):
    if frames:
        model, state = build_frames_state(cfg, cfg.batch_size,
                                          latent_channels=LATENT,
                                          device="cpu")
    else:
        model, state = build_fusion_state(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]), strict=True)
    return model, state


def _port_step(model, cfg, frames):
    make = port_steps.make_frames_step if frames else \
        port_steps.make_fusion_step
    return make(model, cfg, device="cpu")


def _jax_step(model, cfg, frames):
    if frames:
        return jax_steps.make_frames_step(model, cfg)
    return jax_steps.make_fusion_step(model, cfg, window_mode="scan")


def _port_features(cfg, frames, audio):
    return stft_features(torch.from_numpy(audio), cfg.fft_len, cfg.hop,
                         normalized=cfg.normalize_fft, trim_end=not frames,
                         polar=cfg.use_polar).numpy()


@pytest.fixture
def mask_kernel(monkeypatch):
    monkeypatch.setenv("MAAVSS_MASK_IMPL", "pallas")


# ------------------------------------------------------------ the models


@pytest.mark.parametrize("frames", [False, True], ids=["fusion", "frames"])
def test_mask_head_needs_no_new_leaves(frames):
    """The mask head reuses a_fc1: the flax trees with and without it have
    the same leaves and shapes, and `from_flax` fills the port's mask-head
    model exactly (strict load) from that tree."""
    geom, _ = _family(frames)
    cfg = JaxRunConfig(**geom)

    def zeros(mask_head):
        model = _jax_model(cfg, frames, mask_head)
        second = model.frame_shape if frames else model.pgram_shape
        tree = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros(model.stft_shape),
            jnp.zeros(second), method=model.init_all))
        return jax.tree_util.tree_map(
            lambda v: np.zeros(v.shape, np.float32), tree)

    trees = [flatten_tree(zeros(m)) for m in (False, True)]
    assert {k: v.shape for k, v in trees[0].items()} == \
        {k: v.shape for k, v in trees[1].items()}
    model, _ = _port_state(RunConfig(**geom).replace(mask_head=True), frames,
                           unflatten_tree(trees[1]))
    assert model.mask_head


@pytest.mark.parametrize("mask_impl", ["pallas", "xla"])
def test_fusion_mask_head_forward_matches_flax(monkeypatch, mask_impl):
    """Eval mode, random running statistics, the STFT input a window view
    of the clip's features (the separator's layout)."""
    monkeypatch.setenv("MAAVSS_MASK_IMPL", mask_impl)
    cfg = JaxRunConfig(**FUSION).replace(mask_head=True)
    model = _jax_model(cfg, False, True)
    variables = _jax_init(model, False)
    rng = np.random.RandomState(4)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    r = np.random.default_rng(5)
    t = model.stft_shape[2]
    x_full = r.standard_normal(model.stft_shape[:2] + (t + 8,)
                               + model.stft_shape[3:]).astype(np.float32)
    x_v = r.standard_normal(model.pgram_shape).astype(np.float32)
    x_a = x_full[:, :, 4:4 + t]
    want = model.apply(variables, jnp.asarray(x_a), jnp.asarray(x_v))
    port = build_fusion(RunConfig(**FUSION).replace(mask_head=True), 2,
                        "cpu")
    port.load_state_dict(from_flax(variables["params"],
                                   variables["batch_stats"]), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x_full)[:, :, 4:4 + t],
                   torch.from_numpy(x_v))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("mid", [0, 1])
def test_frames_mask_head_forward_matches_flax(mask_kernel, mid):
    """Eval mode: the mask multiplies the window's frame `mid` columns."""
    cfg = JaxRunConfig(**FRAMES).replace(mask_head=True)
    model = _jax_model(cfg, True, True, mid=mid)
    variables = _jax_init(model, True)
    r = np.random.default_rng(6)
    x_a = r.standard_normal(model.stft_shape).astype(np.float32)
    x_v = r.uniform(0, 1, model.frame_shape).astype(np.float32)
    want = model.apply(variables, jnp.asarray(x_a), jnp.asarray(x_v))
    port = build_frames_model(RunConfig(**FRAMES).replace(
        mask_head=True, num_seq=2 * mid + 1), 2, latent_channels=LATENT,
        device="cpu")
    assert port.mask_mid_frame == mid
    port.load_state_dict(from_flax(variables["params"],
                                   variables["batch_stats"]), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x_a), torch.from_numpy(x_v))
    assert got[0].shape == (2, 2, cfg.hops_per_frame, cfg.fft_len // 2 + 1)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


# ------------------------------------------------------------ train steps


def _track(frames, flags, feed_features=False):
    """(port metrics, JAX metrics, port leaves after step 1, JAX leaves
    after step 1, start leaves, model, calls of the K4 wrappers per step)."""
    geom, _ = _family(frames)
    cfg_j = JaxRunConfig(**geom).replace(**flags)
    cfg = RunConfig(**geom).replace(**flags)
    model_j = _jax_model(cfg_j, frames, cfg.mask_head)
    variables = _jax_init(model_j, frames)
    batch = _batch(cfg, frames)
    want, want1 = [], None
    with pytest.MonkeyPatch.context() as mp:
        if feed_features:
            feats = jnp.asarray(_port_features(cfg, frames, batch["audio"]))
            mp.setattr(jax_steps, "stft_features", lambda *a, **k: feats)
        state = create_train_state(variables, make_optimizer(LR, "adam"))
        step = _jax_step(model_j, cfg_j, frames)
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
        for i in range(STEPS):
            state, m = step(state, jbatch, jax.random.PRNGKey(0),
                            jnp.int32(2))
            want.append({k: float(v) for k, v in m.items()})
            if i == 0:
                want1 = flatten_tree(jax.tree_util.tree_map(np.asarray, {
                    "params": state.params,
                    "batch_stats": state.batch_stats}))
    model, pstate = _port_state(cfg, frames, variables)
    step = _port_step(model, cfg, frames)
    spied = {"mask_mul": cc, "magphase_fwd": cc, "polar_spectrum_fwd": cc,
             "mask_head_fwd": cmh, "mask_head_bwd": cmh,
             "stft_features": port_steps}
    calls = dict.fromkeys(spied, 0)
    got, got1 = [], None
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in spied.items():
            real = getattr(mod, name)

            def spy(*args, _real=real, _name=name, **kwargs):
                calls[_name] += 1
                return _real(*args, **kwargs)

            mp.setattr(mod, name, spy)
        for i in range(STEPS):
            pstate, m = step(pstate, batch, 2)
            got.append({k: float(v) for k, v in m.items()})
            if i == 0:
                params, stats = to_flax(model.state_dict())
                got1 = {k: v.copy() for k, v in flatten_tree(
                    {"params": params, "batch_stats": stats}).items()}
    per_step = {k: v // STEPS for k, v in calls.items()}
    return got, want, got1, want1, flatten_tree(variables), model, per_step


def _check_track(frames, got, want, got1, want1, init, model):
    for g, w in zip(got, want):
        for k in ("loss", "a_loss", "v_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=0,
                                       err_msg=k)
    assert set(got1) == set(want1)
    fed = set() if frames else {
        "params/" + k.replace(".", "/") for k in model.bn_fed_biases()}
    for path, w in want1.items():
        if path in fed:
            for side in (got1[path], w):
                np.testing.assert_allclose(side, init[path],
                                           atol=LR * 1.0001, rtol=0,
                                           err_msg=path)
            continue
        if frames and path.endswith("BatchNorm_0/bias"):
            np.testing.assert_allclose(got1[path], w, rtol=0, atol=2e-3 * LR,
                                       err_msg=path)
            continue
        assert _rel_l2(got1[path], w) <= 1e-4, path


@pytest.mark.parametrize("frames", [False, True], ids=["fusion", "frames"])
def test_mask_head_steps_track_jax(mask_kernel, frames):
    """3 mode-2 steps with --mask_head; the fused head runs once forward
    and once backward per window (the STFT input is data), the standalone
    mask product never, the STFT features once per step."""
    got, want, got1, want1, init, model, calls = _track(
        frames, dict(mask_head=True))
    _check_track(frames, got, want, got1, want1, init, model)
    ns = (FRAMES if frames else FUSION)["num_seq"]
    assert calls == {"mask_mul": 0, "magphase_fwd": 0,
                     "polar_spectrum_fwd": 0, "mask_head_fwd": ns,
                     "mask_head_bwd": ns, "stft_features": 1}


@pytest.mark.parametrize("frames", [False, True], ids=["fusion", "frames"])
def test_polar_steps_track_jax(frames):
    """3 mode-2 steps with --use_polar, the JAX side fed the port's
    features; the STFT features (magnitude and phase in their own kernel)
    run once per step, the standalone magphase never."""
    got, want, got1, want1, init, model, calls = _track(
        frames, dict(use_polar=True), feed_features=True)
    _check_track(frames, got, want, got1, want1, init, model)
    assert calls == {"mask_mul": 0, "magphase_fwd": 0,
                     "polar_spectrum_fwd": 0, "mask_head_fwd": 0,
                     "mask_head_bwd": 0, "stft_features": 1}


# ------------------------------------------------------- features, audio


@pytest.mark.parametrize("trim_end", [True, False])
@pytest.mark.parametrize("pallas", [True, None], ids=["pallas", "xla"])
def test_polar_features_match_jax(trim_end, pallas):
    """stft_features(polar=True) against JAX's magphase kernel (interpret
    mode) and its default jnp.abs / jnp.angle, phases wrapped and weighted
    by magnitude; istft_features(polar=True) against JAX's polar kernel and
    its c0 * exp(i c1) on the same features."""
    cfg = RunConfig(**FUSION)
    audio = _batch(cfg, False)["audio"]
    got = stft_features(torch.from_numpy(audio), cfg.fft_len, cfg.hop,
                        trim_end=trim_end, polar=True).numpy()
    want = np.asarray(jax_stft_features(jnp.asarray(audio), cfg.fft_len,
                                        cfg.hop, trim_end=trim_end,
                                        polar=True, pallas=pallas))
    mag = want[:, 0]
    assert _rel_l2(got[:, 0], mag) <= 1e-6
    dphi = np.abs(np.angle(np.exp(1j * (got[:, 1].astype(np.float64)
                                        - want[:, 1]))))
    assert (mag * dphi).max() <= 1e-6 * mag.max()
    # the first frame is real: its phases are 0 or +-pi on both sides
    ph0 = np.abs(want[:, 1, 0].astype(np.float64))
    assert np.minimum(ph0, np.pi - ph0).max() <= 1e-5
    back = istft_features(torch.from_numpy(want.copy()), cfg.fft_len, cfg.hop,
                          trim_end=trim_end, polar=True,
                          length=audio.shape[-1]).numpy()
    ref = np.asarray(jax_istft_features(jnp.asarray(want), cfg.fft_len,
                                        cfg.hop, trim_end=trim_end,
                                        polar=True, pallas=pallas,
                                        length=audio.shape[-1]))
    assert _rel_l2(back, ref) <= 1e-6
    # the same audio as the (re, im) features resynthesize
    rect = stft_features(torch.from_numpy(audio), cfg.fft_len, cfg.hop,
                         trim_end=trim_end)
    assert _rel_l2(back, istft_features(rect, cfg.fft_len, cfg.hop,
                                        trim_end=trim_end,
                                        length=audio.shape[-1]).numpy()) <= 1e-5


@pytest.mark.parametrize("frames", [False, True], ids=["fusion", "frames"])
@pytest.mark.parametrize("flag", ["mask_head", "use_polar"])
def test_separators_match_jax(mask_kernel, frames, flag):
    """Each family's separator with --mask_head or --use_polar (the JAX
    side fed the port's polar features) against the JAX separator; under
    --use_polar the resynthesis runs the polar wrapper once per call."""
    geom, _ = _family(frames)
    cfg_j = JaxRunConfig(**geom).replace(**{flag: True})
    cfg = RunConfig(**geom).replace(**{flag: True})
    model_j = _jax_model(cfg_j, frames, cfg.mask_head)
    variables = _jax_init(model_j, frames)
    batch = _batch(cfg, frames)
    with pytest.MonkeyPatch.context() as mp:
        if cfg.use_polar:
            feats = jnp.asarray(_port_features(cfg, frames, batch["audio"]))
            mp.setattr(jax_steps, "stft_features", lambda *a, **k: feats)
        sep = jax_frames_sep if frames else jax_separator
        want = sep(model_j, cfg_j)(
            create_train_state(variables, make_optimizer(LR, "adam")),
            jax.tree_util.tree_map(jnp.asarray, batch),
            jax.random.PRNGKey(0))
    model, _ = _port_state(cfg, frames, variables)
    polar_calls = []
    real = cc.polar_spectrum_fwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cc, "polar_spectrum_fwd",
                   lambda *a: polar_calls.append(1) or real(*a))
        sep = make_frames_separator if frames else make_separator
        got = sep(model, cfg)({k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert len(polar_calls) == (2 if cfg.use_polar else 0)  # out and in
    for k in ("audio_out", "audio_in"):
        assert _rel_l2(got[k].numpy(), np.asarray(want[k])) <= 1e-4, k
