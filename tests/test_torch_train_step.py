"""The port's fusion train step (maavss_tpu_torch/train/steps.py) against the
JAX `make_fusion_step`, as a whole, on the CPU.

Both start from the same flax init (converted with `from_flax`) and train on
the same synthetic batch at tests/test_parity_training.py:54-56's geometry
with noise_scalar 0 and broadband frames (test_parity_training.py:120-128:
smooth blob frames have FFT bins whose phase is numerically arbitrary).
Four steps in modes 0, 1 and 2, both window modes, and the port's
phasegram encoder both as ConvStack ('xla') and as the fused-layer stack
('pallas', its plain versions on the CPU).

In mode 2 (audio + visual, the slice's path) the port runs free for the
four steps. Modes 0 and 1 zero one encoder's input: that encoder's conv
weight gradients then come from near-total cancellation (a constant input
against a batch-normalised dyc that sums to zero), i.e. float noise, which
Adam turns into updates of up to lr with arbitrary signs in either
framework. The free-running trajectories then drift apart about tenfold a
step after step 2 (measured at lr 1e-3: <= 3e-6 at step 1, 2.6e-5 at step
3, 1.8e-4 at step 4). So in modes 0 and 1 each of the four port steps
starts from the JAX state before that step (parameters, BN statistics,
Adam count and moments, via `from_flax`) and is compared with that JAX
step alone.

Tolerances. Losses: relative 1e-5 in mode 2 (the torch twin of
test_parity_training.py tracks to 4.1e-6 over 8 steps; the two frameworks
sum convolutions and matmuls in different orders); 1e-4 in modes 0 and 1,
where even one step from the same state measured up to 1.1e-5 (vectorized,
mode 1): the zeroed encoder's BatchNorm normalises a nearly constant batch,
whose variance is far below eps, so rounding differences in it are
amplified by up to 1/sqrt(eps) ~ 316 before they reach the loss. Parameters and BN
statistics after step 1: relative L2 1e-4 per leaf, except the conv biases
that feed a train-mode BatchNorm. Their true gradient is exactly 0 (the
batch mean cancels them); autodiff in either framework returns float noise
of ~1e-8 that Adam's first step turns into an update of up to lr with an
arbitrary sign, and the fused-layer stack returns 0. Those leaves, listed by
`AVFusionModel.bn_fed_biases` (the phasegram and STFT encoder conv biases,
and the decoders', which get no gradient at all), are held on each side to
within lr (absolute) of their common starting value: two noise-driven
updates may then differ by up to 2 lr from each other.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.train.state import create_train_state as jax_create_state
from maavss_tpu.train.state import make_optimizer as jax_make_optimizer
from maavss_tpu.train.steps import make_fusion_eval as jax_make_eval
from maavss_tpu.train.steps import make_fusion_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import flatten_tree, from_flax, to_flax
from maavss_tpu_torch.train.setup import (
    build_fusion,
    build_fusion_state,
    check_supported,
    stack_batches,
)
from maavss_tpu_torch.train.state import create_train_state
from maavss_tpu_torch.train.steps import make_fusion_eval, make_fusion_step
from tests.test_torch_workers import share_cores

share_cores()

GEOMETRY = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
                batch_size=4, noise_scalar=0.0)
STEPS = 4
LOSS_RTOL = {0: 1e-4, 1: 1e-4, 2: 1e-5}
PARAM_RTOL = 1e-4
LR = GEOMETRY["learning_rate"]


def _jax_model(cfg):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFusion(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla")


def _batch(cfg):
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=11)
    noise = np.random.default_rng(99).standard_normal(
        batch["frames"].shape).astype(np.float32)
    batch["frames"] = np.clip(batch["frames"] + 0.1 * noise, 0.0, 1.0)
    return batch


@pytest.fixture(scope="module")
def jax_setup():
    cfg = JaxRunConfig(**GEOMETRY)
    model = _jax_model(cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros(model.stft_shape),
                           jnp.zeros(model.pgram_shape), method=model.init_all)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return cfg, model, variables, _batch(cfg)


_TRAJECTORIES = {}


def _np_tree(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def _jax_trajectory(jax_setup, window_mode, mode):
    """Per-step metrics, the JAX state before each step (numpy trees), and
    the (params, batch_stats) after step 1, cached per (window_mode, mode):
    one compile per window mode."""
    key = (window_mode, mode)
    if key not in _TRAJECTORIES:
        cfg, model, variables, batch_np = jax_setup
        state = jax_create_state(variables, jax_make_optimizer(LR, "adam"))
        step = _jax_steps(model, cfg, window_mode)
        batch = jax.tree_util.tree_map(jnp.asarray, batch_np)
        metrics, before, after1 = [], [], None
        for i in range(STEPS):
            adam = state.opt_state[0]
            before.append(jax.tree_util.tree_map(np.asarray, (
                state.params, state.batch_stats, adam.mu, adam.nu,
                adam.count)))
            state, m = step(state, batch, jax.random.PRNGKey(0),
                            jnp.int32(mode))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                after1 = (_np_tree(state.params), _np_tree(state.batch_stats))
        _TRAJECTORIES[key] = (metrics, before, after1)
    return _TRAJECTORIES[key]


def _load_jax_state(state, jax_state):
    """Put a JAX train state (numpy trees) into the port's state: weights,
    BN statistics, Adam's count and moments."""
    params, batch_stats, mu, nu, count = jax_state
    state.model.load_state_dict(from_flax(params, batch_stats))
    names = [n for n, _ in state.model.named_parameters()]
    for moments, tree in ((state.tx.m, mu), (state.tx.v, nu)):
        sd = from_flax(tree)
        for dst, name in zip(moments, names):
            dst.copy_(sd[name])
    state.tx.count = int(count)


_STEPS = {}


def _jax_steps(model, cfg, window_mode):
    if window_mode not in _STEPS:
        _STEPS[window_mode] = jax_make_step(model, cfg,
                                            window_mode=window_mode)
    return _STEPS[window_mode]


def _port_state(variables, pgenc_kernel):
    cfg = RunConfig(**GEOMETRY).replace(pgenc_kernel=pgenc_kernel)
    model = build_fusion(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]))
    return cfg, model, create_train_state(model, cfg, "cpu")


@pytest.mark.parametrize("pgenc_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("window_mode", ["scan", "vectorized"])
def test_step_tracks_jax(jax_setup, window_mode, mode, pgenc_kernel):
    _, _, variables, batch = jax_setup
    want, before, (params1, stats1) = _jax_trajectory(jax_setup, window_mode,
                                                      mode)
    cfg, model, state = _port_state(variables, pgenc_kernel)
    assert model.pgenc_kernel == pgenc_kernel
    init = flatten_tree(variables["params"])
    step = make_fusion_step(model, cfg, window_mode=window_mode, device="cpu")
    got = []
    for i in range(STEPS):
        if mode != 2 and i > 0:
            _load_jax_state(state, before[i])
        state, m = step(state, batch, mode)
        got.append({k: float(v) for k, v in m.items()})
        if i == 0:
            params, stats = to_flax(model.state_dict())
            _compare_after_step1(model, _np_tree(params), _np_tree(stats),
                                 params1, stats1, init)
    assert state.step == STEPS
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "a_loss", "v_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL[mode],
                                       atol=0, err_msg=k)
    if mode == 2:
        assert got[-1]["loss"] < got[0]["loss"]
        # the gradient and parameter norms of step 1 (in modes 0 and 1 the
        # zeroed encoder's gradients are float noise, see above)
        for k, w in want[0].items():
            np.testing.assert_allclose(got[0][k], w, rtol=PARAM_RTOL,
                                       atol=1e-9, err_msg=k)


def _compare_after_step1(model, params, stats, params_j, stats_j, init):
    fed = set(model.bn_fed_biases())
    assert fed == {
        *(f"phasegram_encoder.Conv_{i}.bias" for i in range(6)),
        *(f"stft_encoder.Conv_{i}.bias" for i in range(3)),
        *(f"phasegram_decoder.ConvTranspose_{i}.bias" for i in range(5)),
        *(f"stft_decoder.ConvTranspose_{i}.bias" for i in range(2))}
    fed_paths = {k.replace(".", "/") for k in fed}
    assert set(params) == set(params_j) and set(stats) == set(stats_j)
    for path, want in params_j.items():
        got = params[path]
        if path in fed_paths:
            for side in (got, want):
                np.testing.assert_allclose(side, init[path], atol=LR * 1.0001,
                                           rtol=0, err_msg=path)
            continue
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
        assert rel <= PARAM_RTOL, (path, rel)
    for path, want in stats_j.items():
        rel = (np.linalg.norm(stats[path] - want)
               / max(np.linalg.norm(want), 1e-12))
        assert rel <= PARAM_RTOL, (path, rel)


def test_eval_matches_jax(jax_setup):
    cfg_j, model_j, variables, batch = jax_setup
    state_j = jax_create_state(variables, jax_make_optimizer(LR, "adam"))
    want = jax_make_eval(model_j, cfg_j)(
        state_j, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0), jnp.int32(2))
    cfg, model, state = _port_state(variables, "pallas")
    got = make_fusion_eval(model, cfg, device="cpu")(state, batch, 2)
    assert model.training  # the eval pass restores the train mode
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL[2], err_msg=k)


@pytest.mark.parametrize("flags", [
    dict(fused_opt=True),
])
def test_unported_train_flags_raise(flags):
    cfg = RunConfig(**GEOMETRY).replace(**flags)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(cfg, train=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_fusion_state(cfg, 2, "cpu")


@pytest.mark.parametrize("flags", [
    dict(fusion_encode="full"), dict(noise_schedule="linear:0.1:0"),
    dict(steps_per_dispatch=2), dict(microbatch=2),
    dict(lr_schedule="cosine"), dict(remat=True),
])
def test_ported_train_flags_take_a_step(flags):
    """Flags that no longer raise: the model and state build and take one
    CPU step, or under --steps_per_dispatch one stacked dispatch
    (tests/test_torch_fullenc.py, tests/test_torch_multistep.py,
    tests/test_torch_microbatch.py, tests/test_torch_lr_schedule.py and
    tests/test_torch_remat.py hold them against JAX)."""
    cfg = RunConfig(**GEOMETRY).replace(**flags)
    check_supported(cfg, train=True)
    model, state = build_fusion_state(cfg, cfg.batch_size, "cpu",
                                      torch.Generator().manual_seed(0))
    k = cfg.steps_per_dispatch
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=3)
    if k > 1:
        batch = stack_batches([batch] * k)
    state, m = make_fusion_step(model, cfg, device="cpu")(state, batch, 2)
    assert state.step == k and m["loss"].numel() == (k if k > 1 else 1)
    assert np.all(np.isfinite(m["loss"].numpy()))


def test_build_fusion_state_pairs_model_and_state():
    cfg = RunConfig(**GEOMETRY)
    model, state = build_fusion_state(cfg, 2, "cpu",
                                      torch.Generator().manual_seed(0))
    assert state.model is model and model.training and state.step == 0
    assert state.tx.kernel == "xla"  # 'auto' on CPU parameters
    assert len(state.tx.m) == len(list(model.parameters()))
    assert dataclasses.is_dataclass(state)
