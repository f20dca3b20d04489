"""The port's AVFusionModel (models/fusion.py) against flax `model.apply`
on converted weights (convert.from_flax), fp32, small geometry: the fused
forward under both phasegram-encoder paths, and both autoencoder paths
(which exercise the ConvTranspose crop). Running statistics are random so
every BatchNorm matters. Tolerance 1e-4 relative to each output's largest
magnitude."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.train.setup import build_fusion as jax_build_fusion
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import from_flax
from maavss_tpu_torch.data.synthetic import synthetic_av_batch, with_pgram_rows
from maavss_tpu_torch.models.fusion import AVFusionModel
from maavss_tpu_torch.train.setup import build_fusion, build_fusion_state
from maavss_tpu_torch.train.steps import make_fusion_step
from tests.test_torch_workers import share_cores

share_cores()

SMALL = dict(num_frames=4, num_seq=4, fft_len=64, p_size=16, latent_chan=8,
             fc_size=256, batch_size=2)
RTOL = 1e-4


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= RTOL, err


@pytest.fixture(scope="module")
def flax_model():
    cfg = RunConfig(**SMALL)
    t_stft = cfg.hops_per_frame * cfg.num_frames
    model = JaxFusion(
        stft_shape=(2, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(2, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla")
    variables = jax.jit(lambda key: model.init(
        key, jnp.zeros(model.stft_shape), jnp.zeros(model.pgram_shape),
        method=model.init_all))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(4)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 1.5, v.shape)
                      if "var" in jax.tree_util.keystr(p)
                      else rng.normal(0, 0.2, v.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    r = np.random.default_rng(5)
    x_a = r.standard_normal(model.stft_shape).astype(np.float32)
    x_v = r.standard_normal(model.pgram_shape).astype(np.float32)
    return cfg, model, variables, x_a, x_v


def _port(cfg, variables, pgenc_kernel):
    model = build_fusion(cfg.replace(pgenc_kernel=pgenc_kernel), 2, "cpu")
    model.load_state_dict(from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        variables["batch_stats"]), strict=True)
    return model


@pytest.mark.parametrize("pgenc_kernel", ["xla", "pallas"])
def test_fused_forward_matches_flax(flax_model, pgenc_kernel):
    cfg, model, variables, x_a, x_v = flax_model
    want = model.apply(variables, jnp.asarray(x_a), jnp.asarray(x_v))
    port = _port(cfg, variables, pgenc_kernel)
    with torch.no_grad():
        got = port(torch.from_numpy(x_a), torch.from_numpy(x_v))
    for g, w in zip(got, want):
        close(g.numpy(), w)


@pytest.mark.parametrize("path", ["audio_ae_forward", "visual_ae_forward"])
def test_autoencoder_paths_match_flax(flax_model, path):
    cfg, model, variables, x_a, x_v = flax_model
    x = x_a if path == "audio_ae_forward" else x_v
    want = model.apply(variables, jnp.asarray(x), method=getattr(model, path))
    port = _port(cfg, variables, "xla")
    with torch.no_grad():
        got = getattr(port, path)(torch.from_numpy(x))
    close(got.numpy(), want)


def test_auto_gate_is_convstack_on_cpu():
    model = AVFusionModel((2, 2, 32, 32), (2, 1, 4, 256), latent_channels=8,
                          fc_size=256)
    assert model.pgenc_kernel == "xla"
    assert type(model.phasegram_encoder).__name__ == "ConvStack"


@pytest.mark.parametrize("flags", [
    dict(pgenc_kernel="fold"), dict(stft_fold="fold"),
])
def test_unported_options_raise_at_build(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_fusion(RunConfig(**SMALL).replace(**flags), 2, "cpu")


@pytest.mark.parametrize("flags", [
    dict(fusion_encode="full"), dict(pgram_cache=True),
    dict(rnn_cell="gru"), dict(rnn_cell="none"),
    dict(compress_audio=True), dict(attn_diff=True), dict(dtype="float16"),
])
def test_ported_options_build_and_step(flags):
    """Options that no longer raise: the model and its state build, and
    one CPU train step runs on the batch the option reads (--pgram_cache:
    float16 phasegram rows; tests/test_torch_fullenc.py holds the path
    against JAX, tests/test_torch_rnn_options.py --rnn_cell gru|none,
    --compress_audio and --attn_diff, tests/test_torch_fp16.py --dtype
    float16)."""
    cfg = RunConfig(**SMALL).replace(**flags)
    model, state = build_fusion_state(cfg, 2, "cpu",
                                      torch.Generator().manual_seed(0))
    batch = synthetic_av_batch(cfg, 2, seed=4)
    if cfg.pgram_cache:
        batch = with_pgram_rows(batch)
        assert batch["pgram"].dtype == np.float16
    state, m = make_fusion_step(model, cfg, device="cpu")(state, batch, 2)
    assert state.step == 1 and np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("build", [build_fusion, build_fusion_state],
                         ids=["build_fusion", "build_fusion_state"])
def test_mask_head_with_use_polar_raises(build):
    """--mask_head multiplies (re, im) features: with --use_polar the port's
    builders exit as the JAX build_fusion does, with its message."""
    flags = dict(mask_head=True, use_polar=True)
    with pytest.raises(SystemExit) as want:
        jax_build_fusion(JaxRunConfig(**SMALL).replace(**flags), 2)
    with pytest.raises(SystemExit) as got:
        build(RunConfig(**SMALL).replace(**flags), 2, "cpu")
    assert str(got.value) == str(want.value)
