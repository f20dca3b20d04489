"""The model options a checkpoint can carry, in the port against the JAX
package on the CPU: --rnn_cell gru|none, --attn_diff and --compress_audio.

- The recurrences (models/layers.py: GRU, BiGRU, ParallelMixer) against
  flax's on converted parameters, fp32: the output and the gradients of
  the input and of every parameter within 1e-5 relative to each one's
  largest magnitude; a bf16 forward under tests/test_torch_bf16.py's
  bound (at most RATIO times as far from JAX's bf16 output as that is from
  JAX's fp32 one, and not the port's fp32 output).
- The trees: `to_flax(from_flax(p)) == p` for both families' gru and none
  trees, which load into the port's models strictly; a JAX `save_model`
  pickle of either loads through exp/checkpoint.load_model.
- Both families with gru and none, from one seeded weight tree over the
  flax model's leaves (`random_flax_tree`, random BatchNorm statistics):
  the eval forward within 1e-4, 3 train steps' losses within 1e-5 (mode
  2, lr 1e-3, noise 0) in window mode and full encode; under gru and none
  no K1 wrapper is called. One fusion step each under --attn_diff and
  --compress_audio.
- The separators of both families under each option against JAX's at
  noise 0: every clip's SI-SDR within 1e-3 dB, audio_out within 1e-4
  relative L2.

Geometry: the fusion model at num_frames 4, num_seq 2, hops_per_frame 4,
fft 64, p_size 16, latent 8, fc 256, batch 2 (the phasegram encoder
ConvStack on both sides); the frames model at framesize 24, num_frames 2,
num_seq 2, latent 4, with MAAVSS_S2D_MIN_HW=8 (K5's plain chain in train
mode). The frames carry broadband noise: a smooth blob's near-zero FFT bins
have arbitrary phases, and so phasegrams. Each JAX function is compiled
once a case.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.models import layers as jax_layers
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.models.fusion_frames import AVFusionFramesModel as JaxFrames
from maavss_tpu.train.infer import make_frames_separator as jax_frames_sep
from maavss_tpu.train.infer import make_separator as jax_fusion_sep
from maavss_tpu.train.state import create_train_state as jax_create_state
from maavss_tpu.train.state import make_optimizer as jax_make_optimizer
from maavss_tpu.train.steps import make_frames_step as jax_frames_step
from maavss_tpu.train.steps import make_fusion_step as jax_fusion_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    random_flax_tree,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.data.synthetic import synthetic_av_batch
from maavss_tpu_torch.exp.checkpoint import load_model
from maavss_tpu_torch.models.layers import GRU, BiGRU, ParallelMixer
from maavss_tpu_torch.ops import cuda_lstm
from maavss_tpu_torch.train.infer import make_separator
from maavss_tpu_torch.train.setup import build_frames_state, build_fusion_state
from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step
from tests.test_torch_bf16 import check_ratio
from tests.test_torch_workers import share_cores

share_cores()

FUSION = dict(num_frames=4, num_seq=2, hops_per_frame=4, fft_len=64,
              p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
              batch_size=2, noise_scalar=0.0, pgenc_kernel="xla")
FRAMES = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
              framesize=24, learning_rate=1e-3, batch_size=2,
              noise_scalar=0.0)
GEOMETRY = {"fusion": FUSION, "frames": FRAMES}
LATENT, MODE, SEED, STEPS = 4, 2, 2027, 3
MODULE_RTOL, FWD_RTOL, LOSS_RTOL, AUDIO_RTOL, DB_TOL = 1e-5, 1e-4, 1e-5, \
    1e-4, 1e-3
CELLS = ("gru", "none")


@pytest.fixture(autouse=True)
def _k5_stages(monkeypatch):
    monkeypatch.setenv("MAAVSS_S2D_MIN_HW", "8")


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------- modules

MODULES = {
    "gru-fwd": (lambda: jax_layers.GRU(16), lambda: GRU(12, 16)),
    "gru-rev": (lambda: jax_layers.GRU(16, reverse=True),
                lambda: GRU(12, 16, reverse=True)),
    "bigru": (lambda: jax_layers.BiGRU(16), lambda: BiGRU(12, 16)),
    "mixer": (lambda: jax_layers.ParallelMixer(16),
              lambda: ParallelMixer(12, 16)),
}


@pytest.mark.parametrize("kind", list(MODULES))
def test_recurrence_matches_flax(kind):
    """Forward, d input and d every parameter of one module, fp32."""
    make_jax, make_port = MODULES[kind]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    module = make_jax()
    params = jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    y, vjp = jax.vjp(lambda p, x: module.apply({"params": p}, x), params,
                     jnp.asarray(x))
    cot = rng.standard_normal(y.shape).astype(np.float32)
    d_params, d_x = vjp(jnp.asarray(cot))

    port = make_port()
    port.load_state_dict(from_flax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    out.backward(torch.from_numpy(cot))
    assert _max_rel(out.detach().numpy(), y) <= MODULE_RTOL
    assert _max_rel(xt.grad.numpy(), d_x) <= MODULE_RTOL
    grads = flatten_tree(to_flax({n: p.grad for n, p in
                                  port.named_parameters()})[0])
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, d_params))
    assert set(grads) == set(want)
    for path, g in want.items():
        assert _max_rel(grads[path], g) <= MODULE_RTOL, path


@pytest.mark.parametrize("cell", CELLS)
def test_recurrence_bf16_forward(cell):
    """--dtype bfloat16: the GRU's parameters and carry in bf16 (flax
    creates them so), the mixer's dense by the port's `dense` rule; the
    output under tests/test_torch_bf16.py's bound."""
    jax_cls, port_cls = ((jax_layers.BiGRU, BiGRU) if cell == "gru"
                         else (jax_layers.ParallelMixer, ParallelMixer))
    x = np.random.default_rng(5).standard_normal((4, 6, 24)).astype(
        np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, jax_cls(32).init(
        jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    if cell == "gru":  # bf16 values, so both dtypes start from one tree
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
                jnp.float32)), params)
    outs = {}
    for name, jdt, tdt in (("bf16", jnp.bfloat16, torch.bfloat16),
                           ("f32", jnp.float32, torch.float32)):
        p = params if cell == "none" else jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jdt), params)
        outs[("jax", name)] = jax_cls(32, dtype=jdt).apply(
            {"params": p}, jnp.asarray(x, jdt))
        port = port_cls(24, 32, dtype=tdt)
        port.load_state_dict(from_flax(params), strict=True)
        with torch.no_grad():
            outs[("port", name)] = port(torch.from_numpy(x).to(tdt))
    assert outs[("port", "bf16")].dtype == torch.bfloat16
    assert outs[("jax", "bf16")].dtype == jnp.bfloat16
    check_ratio(f"{cell} bf16", outs[("port", "bf16")], outs[("jax", "bf16")],
                outs[("jax", "f32")], outs[("port", "f32")])


# ------------------------------------------------------------------ models

def _jax_model(family, cfg, batch):
    if family == "frames":
        t_stft = cfg.hops_per_frame * cfg.num_frames
        return JaxFrames(
            stft_shape=(batch, 2, t_stft, cfg.fft_len // 2 + 1),
            frame_shape=(batch, 1, cfg.num_frames, cfg.framesize,
                         cfg.framesize),
            hops_per_frame=cfg.hops_per_frame, latent_channels=LATENT,
            rnn_cell=cfg.rnn_cell)
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFusion(
        stft_shape=(batch, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(batch, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla", rnn_cell=cfg.rnn_cell)


def _cfgs(family, **flags):
    return (JaxRunConfig(**GEOMETRY[family]).replace(**flags),
            RunConfig(**GEOMETRY[family]).replace(**flags))


@functools.lru_cache(maxsize=None)
def _variables(family, cell):
    """Seeded weights over the flax model's leaf shapes (numpy trees)."""
    cfg, _ = _cfgs(family, rnn_cell=cell)
    model = _jax_model(family, cfg, 2)
    second = model.frame_shape if family == "frames" else model.pgram_shape
    tree = jax.tree_util.tree_map(
        lambda s: np.empty(s.shape, s.dtype), jax.eval_shape(
            lambda: model.init(jax.random.PRNGKey(0),
                               jnp.zeros(model.stft_shape),
                               jnp.zeros(second), method=model.init_all)))
    shapes = {k: v.shape for k, v in flatten_tree(
        {"params": tree["params"],
         "batch_stats": tree["batch_stats"]}).items()}
    return unflatten_tree(random_flax_tree(shapes, SEED))


def _batch(family, cfg, seed):
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=seed,
                               frame_size=cfg.framesize
                               if family == "frames" else None)
    noise = np.random.default_rng(seed + 90).standard_normal(
        batch["frames"].shape).astype(np.float32)
    batch["frames"] = np.clip(batch["frames"] + 0.1 * noise, 0.0, 1.0)
    return batch


def _port_state(family, cfg, variables):
    if family == "frames":
        model, state = build_frames_state(cfg, cfg.batch_size,
                                          latent_channels=LATENT,
                                          device="cpu")
    else:
        model, state = build_fusion_state(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]), strict=True)
    return model, state


def _jax_state(variables):
    return jax_create_state({"params": variables["params"],
                             "batch_stats": variables["batch_stats"]},
                            jax_make_optimizer(FUSION["learning_rate"],
                                               "adam"))


@pytest.fixture
def no_k1(monkeypatch):
    """Fails a test that reaches a K1 wrapper (gru and none never do)."""
    def refuse(*args, **kwargs):
        raise AssertionError("K1 reached under --rnn_cell gru|none")

    for name in ("lstm_bidir", "lstm_recurrence", "lstm_recurrence_plain"):
        monkeypatch.setattr(cuda_lstm, name, refuse)
    from maavss_tpu_torch.models import layers

    monkeypatch.setattr(layers, "lstm_bidir", refuse)
    monkeypatch.setattr(layers, "lstm_recurrence_plain", refuse)


CASES = [(f, c) for f in ("fusion", "frames") for c in CELLS]
IDS = [f"{f}-{c}" for f, c in CASES]


@pytest.mark.parametrize("family,cell", CASES, ids=IDS)
def test_tree_round_trip(family, cell, tmp_path, monkeypatch):
    """from_flax and to_flax are inverse on the option's tree, which loads
    strictly; a JAX save_model pickle loads through load_model."""
    from maavss_tpu.exp.checkpoint import save_model as jax_save_model

    variables = _variables(family, cell)
    _, cfg = _cfgs(family, rnn_cell=cell)
    model, _ = _port_state(family, cfg, variables)
    params, stats = to_flax(from_flax(variables["params"],
                                      variables["batch_stats"]))
    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        got, want = flatten_tree(got), flatten_tree(want)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    leaves = flatten_tree(variables["params"])
    rnn = sorted(k for k in leaves if k.startswith("lstm/"))
    assert rnn == (["lstm/bwd/w_h", "lstm/bwd/w_i", "lstm/fwd/w_h",
                    "lstm/fwd/w_i"] if cell == "gru"
                   else ["lstm/Dense_0/kernel"])
    monkeypatch.setenv("MAAVSS_CKPT_BACKEND", "pkl")
    path = jax_save_model(str(tmp_path / "m"), variables["params"])
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    load_model(path, model)
    for name, p in model.named_parameters():
        want = from_flax(variables["params"])[name]
        assert torch.equal(p, want), name


@pytest.mark.parametrize("family,cell", CASES, ids=IDS)
def test_forward_matches_jax(family, cell, no_k1):
    variables = _variables(family, cell)
    cfg_j, cfg = _cfgs(family, rnn_cell=cell)
    model_j = _jax_model(family, cfg_j, 2)
    rng = np.random.default_rng(6)
    x_a = rng.standard_normal(model_j.stft_shape).astype(np.float32)
    second = (model_j.frame_shape if family == "frames"
              else model_j.pgram_shape)
    x_v = rng.uniform(0, 1, second).astype(np.float32)
    want = model_j.apply(variables, jnp.asarray(x_a), jnp.asarray(x_v))
    model, _ = _port_state(family, cfg, variables)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x_a), torch.from_numpy(x_v))
    for g, w in zip(got, want):
        assert _max_rel(g.numpy(), w) <= FWD_RTOL


def _port_losses(family, flags, steps):
    """The port's losses over `steps` train steps from the seeded tree."""
    _, cfg = _cfgs(family, **flags)
    model, state = _port_state(family, cfg, _variables(
        family, flags.get("rnn_cell", "lstm")))
    make = make_frames_step if family == "frames" else make_fusion_step
    step, got = make(model, cfg, device="cpu"), []
    for i in range(steps):
        state, m = step(state, _batch(family, cfg, seed=11 + i), MODE)
        got.append(float(m["loss"]))
    return got


def _steps_vs_jax(family, flags, steps):
    """(port losses, JAX losses) of `steps` train steps from one tree."""
    cfg_j, _ = _cfgs(family, **flags)
    make_j = jax_frames_step if family == "frames" else jax_fusion_step
    step_j = make_j(_jax_model(family, cfg_j, cfg_j.batch_size), cfg_j)
    state_j = _jax_state(_variables(family, flags.get("rnn_cell", "lstm")))
    want = []
    for i in range(steps):
        batch = _batch(family, cfg_j, seed=11 + i)
        state_j, m = step_j(state_j, jax.tree_util.tree_map(jnp.asarray,
                                                            batch),
                            jax.random.PRNGKey(0), jnp.int32(MODE))
        want.append(float(m["loss"]))
    return _port_losses(family, flags, steps), want


TRAIN = [(f, c, e) for f, c in CASES for e in ("window", "full")]


@pytest.mark.parametrize("family,cell,encode", TRAIN,
                         ids=[f"{f}-{c}-{e}" for f, c, e in TRAIN])
def test_train_steps_match_jax(family, cell, encode, no_k1):
    key = "frames_encode" if family == "frames" else "fusion_encode"
    got, want = _steps_vs_jax(family, {"rnn_cell": cell, key: encode},
                              STEPS)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert np.all(np.isfinite(got)) and len(set(got)) == STEPS


@pytest.mark.parametrize("option", ["attn_diff", "compress_audio"])
def test_fusion_option_step_matches_jax(option):
    got, want = _steps_vs_jax("fusion", {option: True}, 1)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    plain = _port_losses("fusion", {}, 1)
    assert abs(got[0] - plain[0]) > 1e-3 * abs(plain[0])  # the option acts


SEPARATORS = [(f, o) for f in ("fusion", "frames")
              for o in ("gru", "none", "attn_diff", "compress_audio")]


@pytest.mark.parametrize("family,option", SEPARATORS,
                         ids=[f"{f}-{o}" for f, o in SEPARATORS])
def test_separator_matches_jax(family, option):
    """Every clip's SI-SDR within 1e-3 dB and audio_out within 1e-4 rel
    L2; under --compress_audio the SI-SDR reference stays the batch's
    uncompressed audio, as in the JAX separator."""
    flags = ({"rnn_cell": option} if option in CELLS else {option: True})
    variables = _variables(family, flags.get("rnn_cell", "lstm"))
    cfg_j, cfg = _cfgs(family, **flags)
    batch = _batch(family, cfg, seed=21)
    make_j = jax_frames_sep if family == "frames" else jax_fusion_sep
    want = make_j(_jax_model(family, cfg_j, 2), cfg_j)(
        _jax_state(variables), jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    model, _ = _port_state(family, cfg, variables)
    got = make_separator(model, cfg, frames_model=family == "frames")(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel_l2(got["audio_out"].numpy(), want["audio_out"]) <= AUDIO_RTOL
    for key in ("si_sdr", "si_sdr_noisy", "si_sdr_gain"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=DB_TOL, err_msg=key)
