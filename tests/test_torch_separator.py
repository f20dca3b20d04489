"""The port's serving function and eval separator against the JAX package's
on the same (converted) weights and numpy inputs, fp32, small geometry:
- exp/export.make_serving_fn: audio_out within 1e-4 relative L2;
- train/infer.make_separator with noise_scalar=0: SI-SDR within 1e-3 dB.
Frames are broadband noise in [0, 1]."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.exp.export import make_serving_fn as jax_serving_fn
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.train.infer import make_separator as jax_make_separator
from maavss_tpu.train.state import TrainState
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import from_flax
from maavss_tpu_torch.exp.export import (
    make_serving_fn,
    random_serving_inputs,
    serving_input_specs,
)
from maavss_tpu_torch.train.infer import make_separator
from maavss_tpu_torch.train.setup import build_fusion
from tests.test_torch_workers import share_cores

share_cores()

SMALL = dict(num_frames=4, num_seq=4, fft_len=64, p_size=16, latent_chan=8,
             fc_size=256, batch_size=2)


@pytest.fixture(scope="module")
def both():
    jcfg = JaxRunConfig(**SMALL)
    t_stft = jcfg.hops_per_frame * jcfg.num_frames
    model = JaxFusion(
        stft_shape=(2, 2, t_stft, jcfg.fft_len // 2),
        pgram_shape=(2, 1, jcfg.num_frames, jcfg.p_size ** 2),
        latent_channels=jcfg.latent_chan, fc_size=jcfg.fc_size,
        pgenc_kernel="xla")
    v = jax.jit(lambda key: model.init(
        key, jnp.zeros(model.stft_shape), jnp.zeros(model.pgram_shape),
        method=model.init_all))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    cfg = RunConfig(**SMALL)
    port = build_fusion(cfg, 2, "cpu")
    port.load_state_dict(from_flax(params, stats), strict=True)
    audio, visual = random_serving_inputs(cfg, 2, seed=0)
    visual = np.random.default_rng(1).uniform(0, 1, visual.shape).astype(
        np.float32)
    return jcfg, model, params, stats, cfg, port, audio, visual


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_inputs_and_specs_match_jax():
    from maavss_tpu.exp.export import random_serving_inputs as jax_inputs
    from maavss_tpu.exp.export import serving_input_specs as jax_specs

    cfg, jcfg = RunConfig(**SMALL), JaxRunConfig(**SMALL)
    for port_arr, jax_arr in zip(random_serving_inputs(cfg, 3, seed=4),
                                 jax_inputs(jcfg, 3, seed=4)):
        np.testing.assert_array_equal(port_arr, jax_arr)
    for p, j in zip(serving_input_specs(cfg, 3), jax_specs(jcfg, 3)):
        assert tuple(p.shape) == tuple(j.shape)
        assert np.dtype(p.dtype) == np.dtype(j.dtype)


@pytest.mark.parametrize("normalize_output_fft", [False, True])
def test_serving_fn_matches_jax(both, normalize_output_fft):
    jcfg, model, params, stats, cfg, port, audio, visual = both
    jcfg = jcfg.replace(normalize_output_fft=normalize_output_fft)
    cfg = cfg.replace(normalize_output_fft=normalize_output_fft)
    want = np.asarray(jax_serving_fn(model, jcfg)(params, stats, audio, visual))
    got = make_serving_fn(port, cfg)(torch.from_numpy(audio),
                                     torch.from_numpy(visual)).numpy()
    assert got.shape == audio.shape and np.all(np.isfinite(got))
    assert _rel_l2(got, want) < 1e-4


def test_separator_si_sdr_matches_jax(both):
    jcfg, model, params, stats, cfg, port, audio, visual = both
    jcfg, cfg = jcfg.replace(noise_scalar=0.0), cfg.replace(noise_scalar=0.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=(), tx=None)
    want = jax_make_separator(model, jcfg)(
        state, {"audio": audio, "frames": visual}, jax.random.PRNGKey(0))
    got = make_separator(port, cfg)({"audio": torch.from_numpy(audio),
                                     "frames": torch.from_numpy(visual)})
    for key in ("si_sdr", "si_sdr_noisy", "si_sdr_gain"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-3, rtol=0, err_msg=key)
    assert _rel_l2(got["audio_out"].numpy(), np.asarray(want["audio_out"])) \
        < 1e-4


def test_separator_noise_is_seeded(both):
    *_, cfg, port, audio, visual = both
    sep = make_separator(port, cfg)  # noise_scalar 0.1
    batch = {"audio": torch.from_numpy(audio),
             "frames": torch.from_numpy(visual)}
    a = sep(batch, torch.Generator().manual_seed(3))
    b = sep(batch, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a["audio_in"], b["audio_in"], rtol=0, atol=0)
    assert not torch.equal(a["audio_in"],
                           sep(batch, torch.Generator().manual_seed(4))[
                               "audio_in"])
