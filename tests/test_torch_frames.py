"""The port's frames model family (maavss_tpu_torch/models/fusion_frames.py,
the frames separator and serving function) against the JAX package, on the
same numpy inputs and the same weights carried across by `convert.from_flax`.

The geometry is small: framesize 24, num_frames 2, fft 64, latent 8, with
MAAVSS_S2D_MIN_HW=8 so that, as at the flagship's framesize 256, the
encoder's stages 0 and 1 take the fused epilogue in train mode (the JAX
package with MAAVSS_CONV3D=s2d and MAAVSS_EPILOGUE=fused, its Pallas kernels
in interpret mode; the port's plain versions on the CPU).

Tolerances: the encoder's, those of tests/test_pallas_epilogue.py:171-178
(outputs rtol/atol 1e-4, running statistics rtol 1e-4 atol 1e-5, gradients
rtol 2e-3 atol 2e-4: conv3d sums in another order, and the space-to-depth
fold on the JAX side); the whole model's outputs 1e-4; the separator's audio
relative L2 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch
from maavss_tpu.exp.export import make_serving_fn as jax_serving_fn
from maavss_tpu.exp.export import random_serving_inputs as jax_inputs
from maavss_tpu.exp.export import serving_input_specs as jax_specs
from maavss_tpu.models.fusion_frames import AVFusionFramesModel as JaxFrames
from maavss_tpu.models.fusion_frames import FramesVisualEncoder as JaxEncoder
from maavss_tpu.train.infer import make_frames_separator as jax_separator
from maavss_tpu.train.setup import build_frames_model as jax_build_frames
from maavss_tpu.train.state import create_train_state, make_optimizer
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.exp.export import (
    make_serving_fn,
    random_serving_inputs,
    serving_input_specs,
)
from maavss_tpu_torch.models import layers as port_layers
from maavss_tpu_torch.models.fusion_frames import (
    AVFusionFramesModel,
    FramesVisualEncoder,
)
from maavss_tpu_torch.train.infer import make_frames_separator
from maavss_tpu_torch.train.setup import (
    build_frames_model,
    build_frames_state,
    check_supported,
)
from maavss_tpu_torch.train.steps import make_frames_step
from tests.test_torch_workers import share_cores

share_cores()

GEOMETRY = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
                framesize=24, batch_size=2, noise_scalar=0.0)
LATENT = 8
ENV = dict(MAAVSS_CONV3D="s2d", MAAVSS_EPILOGUE="fused", MAAVSS_S2D_MIN_HW="8")


@pytest.fixture
def fused_env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


@pytest.fixture
def count_fused(monkeypatch):
    """Counts the port's calls of the fused epilogue."""
    calls = []
    real = port_layers.fused_bn_pool_leaky

    def spy(y, gamma, beta, split=False):
        calls.append(tuple(y.shape))
        return real(y, gamma, beta, split=split)

    monkeypatch.setattr(port_layers, "fused_bn_pool_leaky", spy)
    return calls


def _jax_model(cfg, batch):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFrames(
        stft_shape=(batch, 2, t_stft, cfg.fft_len // 2 + 1),
        frame_shape=(batch, 1, cfg.num_frames, cfg.framesize, cfg.framesize),
        hops_per_frame=cfg.hops_per_frame, latent_channels=LATENT)


def _jax_init(cfg, batch, seed=0):
    model = _jax_model(cfg, batch)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros(model.stft_shape),
                           jnp.zeros(model.frame_shape),
                           method=model.init_all)
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _port_model(cfg, variables, batch):
    model = build_frames_model(cfg, batch, latent_channels=LATENT,
                               device="cpu")
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]), strict=True)
    return model


def _close_trees(got, want, rtol, atol):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_encoder_matches_jax(fused_env, count_fused, train):
    """FramesVisualEncoder: output, the loss's gradients and the updated
    running statistics, in train mode with the fused epilogue at stages 0
    and 1, and in eval mode."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 1, 3, 24, 24)) * 0.5).astype(np.float32)
    enc_j = JaxEncoder(latent_channels=16, conv_impl="s2d", epilogue="fused")
    variables = enc_j.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def loss_fn(params):
        out, mut = enc_j.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=train,
                               mutable=["batch_stats"])
        return jnp.sum(jnp.square(out)), (out, mut["batch_stats"])

    (loss_j, (out_j, stats_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    enc = FramesVisualEncoder(latent_channels=16)
    enc.load_state_dict(from_flax(variables["params"],
                                  variables["batch_stats"]), strict=True)
    enc.train(train)
    out = enc(torch.from_numpy(x))
    loss = torch.sum(out * out)
    loss.backward()
    assert count_fused == ([(2, 16, 3, 24, 24), (2, 32, 3, 12, 12)]
                           if train else [])
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=1e-4,
                               atol=1e-4)
    grads = {name: p.grad for name, p in enc.named_parameters()}
    params, stats = to_flax({**grads, **dict(enc.named_buffers())})
    _close_trees(params, jax.tree_util.tree_map(np.asarray, grads_j),
                 rtol=2e-3, atol=2e-4)
    _close_trees(stats, jax.tree_util.tree_map(np.asarray, stats_j),
                 rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_model_forward_matches_jax(fused_env, count_fused, train):
    cfg = JaxRunConfig(**GEOMETRY)
    model_j, variables = _jax_init(cfg, 2)
    rng = np.random.default_rng(1)
    x_a = (rng.standard_normal(model_j.stft_shape) * 0.3).astype(np.float32)
    x_v = rng.uniform(0, 1, model_j.frame_shape).astype(np.float32)
    (want, mut) = model_j.apply(variables, jnp.asarray(x_a),
                                jnp.asarray(x_v), train=train,
                                mutable=["batch_stats"])
    model = _port_model(RunConfig(**GEOMETRY), variables, 2)
    model.train(train)
    got = model(torch.from_numpy(x_a), torch.from_numpy(x_v))
    assert len(count_fused) == (2 if train else 0)
    for g, w, name in zip(got, want, ("stft", "frame", "fused")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    _, stats = to_flax(model.state_dict())
    _close_trees(stats, jax.tree_util.tree_map(np.asarray,
                                               mut["batch_stats"]),
                 rtol=1e-4, atol=1e-5)


def test_flagship_tree_converts_both_ways():
    """from_flax covers the flagship frames model's whole tree (shapes from
    jax.eval_shape: conv3d kernels, the bias-free stacks, the channel-axis
    LSTM, fc1 8192x8192) and to_flax gives it back."""
    cfg = JaxRunConfig()
    model_j = JaxFrames(
        stft_shape=(8, 2, cfg.hops_per_frame * cfg.num_frames,
                    cfg.fft_len // 2 + 1),
        frame_shape=(8, 1, cfg.num_frames, cfg.framesize, cfg.framesize),
        hops_per_frame=cfg.hops_per_frame, latent_channels=16)
    abstract = jax.eval_shape(lambda key: model_j.init(
        key, jnp.zeros(model_j.stft_shape), jnp.zeros(model_j.frame_shape),
        method=model_j.init_all), jax.random.PRNGKey(0))
    shapes = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  {"params": abstract["params"],
                   "batch_stats": abstract["batch_stats"]})[0]}
    cfg_p = RunConfig()
    with torch.device("meta"):  # shapes only: no 107 M-parameter init
        model = AVFusionFramesModel(
            stft_shape=(8, 2, cfg_p.hops_per_frame * cfg_p.num_frames,
                        cfg_p.fft_len // 2 + 1),
            frame_shape=(8, 1, cfg_p.num_frames, cfg_p.framesize,
                         cfg_p.framesize),
            hops_per_frame=cfg_p.hops_per_frame, latent_channels=16)
    sd = model.state_dict()
    tree = {"params": {}, "batch_stats": {}}
    for path, shape in shapes.items():
        top, rest = path.split("/", 1)
        tree[top][rest] = np.zeros(shape, np.float32)
    port = from_flax(unflatten_tree(tree["params"]),
                     unflatten_tree(tree["batch_stats"]))
    assert set(port) == set(sd)
    for k, v in port.items():
        assert tuple(v.shape) == tuple(sd[k].shape), k
    assert sd["fc1.weight"].shape == (8192, 8192)
    assert sd["visual_encoder.Conv_0.weight"].shape == (16, 1, 3, 5, 5)
    n_params = sum(int(np.prod(s)) for k, s in shapes.items()
                   if k.startswith("params/"))
    assert n_params == sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(2)
    kernel = rng.standard_normal((3, 5, 5, 16, 32)).astype(np.float32)
    back, _ = to_flax(from_flax({"Conv_1": {"kernel": kernel}}))
    np.testing.assert_array_equal(back["Conv_1"]["kernel"], kernel)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def test_separator_matches_jax(fused_env):
    cfg_j = JaxRunConfig(**GEOMETRY)
    model_j, variables = _jax_init(cfg_j, 2, seed=3)
    batch = synthetic_av_batch(cfg_j, 2, seed=4, frame_size=24)
    state = create_train_state(variables, make_optimizer(1e-3, "adam"))
    want = jax_separator(model_j, cfg_j)(
        state, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    cfg = RunConfig(**GEOMETRY)
    model = _port_model(cfg, variables, 2).train()
    got = make_frames_separator(model, cfg)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert model.training  # the separator restores the mode
    for k in ("audio_out", "audio_in"):
        assert got[k].shape == want[k].shape
        assert _rel_l2(got[k].numpy(), np.asarray(want[k])) <= 1e-4, k
    np.testing.assert_allclose(got["si_sdr"].numpy(), want["si_sdr"],
                               rtol=1e-4, atol=1e-4)


def test_serving_fn_specs_and_payloads_match_jax(fused_env):
    cfg_j = JaxRunConfig(**GEOMETRY)
    cfg = RunConfig(**GEOMETRY)
    for p, j in zip(serving_input_specs(cfg, 3, frames_model=True),
                    jax_specs(cfg_j, 3, frames_model=True)):
        assert p.shape == tuple(j.shape) and p.dtype == j.dtype
    assert serving_input_specs(cfg, 3, frames_model=True)[1].dtype == np.uint8
    for a, b in zip(random_serving_inputs(cfg, 3, frames_model=True, seed=4),
                    jax_inputs(cfg_j, 3, frames_model=True, seed=4)):
        np.testing.assert_array_equal(a, b)
    model_j, variables = _jax_init(cfg_j, 2, seed=5)
    audio, visual = random_serving_inputs(cfg, 2, frames_model=True, seed=6)
    want = jax_serving_fn(model_j, cfg_j, frames_model=True)(
        variables["params"], variables["batch_stats"], jnp.asarray(audio),
        jnp.asarray(visual))
    model = _port_model(cfg, variables, 2)
    got = make_serving_fn(model, cfg, frames_model=True)(
        torch.from_numpy(audio), torch.from_numpy(visual))
    assert got.shape == audio.shape
    assert _rel_l2(got.numpy(), np.asarray(want)) <= 1e-4


@pytest.mark.parametrize("flags, item", [
    (dict(fused_opt=True), "queue 1, 'Not carried'"),
])
def test_unported_frames_flags_raise(flags, item):
    """Each frames option not ported yet raises NotImplementedError
    naming its ROADMAP item, from the check, build_frames_state and the step."""
    cfg = RunConfig(**GEOMETRY).replace(**flags)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        check_supported(cfg, train=True)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        build_frames_state(cfg, 2, device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        make_frames_step(None, cfg, device="cpu")


@pytest.mark.parametrize("flags", [
    dict(frames_encode="full"), dict(frames_encode="full", frames_halo=1),
    dict(microbatch=2), dict(attn_diff=True), dict(rnn_cell="gru"),
    dict(rnn_cell="none"), dict(remat=True), dict(dtype="float16"),
])
def test_ported_frames_flags_take_a_step(fused_env, flags):
    """Frames options that no longer raise: the state builds and takes one
    CPU step (tests/test_torch_frames_full.py holds them against JAX,
    tests/test_torch_rnn_options.py --attn_diff and --rnn_cell gru|none,
    tests/test_torch_fp16.py --dtype float16)."""
    cfg = RunConfig(**GEOMETRY).replace(**flags)
    check_supported(cfg, train=True)
    model, state = build_frames_state(cfg, 2, latent_channels=LATENT,
                                      device="cpu")
    batch = synthetic_av_batch(cfg, 2, seed=3, frame_size=24)
    assert batch["frames"].shape[1] == 4 + 2 * cfg.frames_halo
    state, m = make_frames_step(model, cfg, device="cpu")(state, batch, 2)
    assert state.step == 1 and np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("build", [build_frames_model, build_frames_state],
                         ids=["build_frames_model", "build_frames_state"])
def test_mask_head_with_use_polar_raises(build):
    """--mask_head multiplies (re, im) features: with --use_polar the port's
    builders exit as the JAX build_frames_model does, with its message."""
    flags = dict(mask_head=True, use_polar=True)
    with pytest.raises(SystemExit) as want:
        jax_build_frames(JaxRunConfig(**GEOMETRY).replace(**flags), 2, 24)
    with pytest.raises(SystemExit) as got:
        build(RunConfig(**GEOMETRY).replace(**flags), 2, device="cpu")
    assert str(got.value) == str(want.value)
