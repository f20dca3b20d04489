"""--frames_encode full, --frames_halo and --microbatch in the port's frames
step and separator (maavss_tpu_torch/train/steps.py:make_frames_step,
train/infer.py:separate_frames_windows) against the JAX package, on the CPU.

Geometry: tests/test_frames_fullseq.py's (framesize 24, num_frames 2,
num_seq 2, hops_per_frame 4, fft 64, latent 8), batch 4, lr 1e-3,
noise_scalar 0, mode 2, with MAAVSS_S2D_MIN_HW=8: the port's encoder stages
0 and 1 take K5's plain chain in train mode, as at the flagship's framesize
256; the JAX step runs its default CPU tail (conv3d direct, XLA epilogue),
the same math. Both sides start from one seeded weight tree over the flax
model's leaf shapes (`convert.random_flax_tree`, as
tests/test_torch_fullenc.py), carried across by `from_flax`, and take one
synthetic batch (seed 7) with broadband frame noise
(tests/test_torch_frames_step.py's).

Against JAX, one step per case, each JAX step compiled once:
- full: one full-encode step;
- full-halo1-mb2: --frames_halo 1 (the clip extends by 2 frames and window j
  starts at frame 1 + j) and --microbatch 2 (two chunks of 2 examples);
- window-mb2: window mode at --microbatch 2.
Tolerances, tests/test_torch_frames_step.py's: losses relative 1e-5,
the step's gradient and parameter norms 1e-4, Adam's first moment (0.1 x
the gradient after one step) and every leaf and BatchNorm statistic after
the step relative L2 1e-4, except the BatchNorm shifts: their gradients are
near-total cancellations whose last digits Adam's first step carries, so
they are held within 2e-3 lr per element and their gradients not compared.

On the port alone: at num_seq 1 full encode equals window mode (losses and
leaves within 1e-5 relative, tests/test_frames_fullseq.py:52); a batch of
two equal halves gives at --microbatch 2 the losses and the gradient of
--microbatch 1 within 1e-5 relative (tests/test_frames_fullseq.py:89-96;
the running statistics differ by design: two updates against one). The
full-encode separator's audio is held at relative L2 1e-4 against JAX's
make_frames_separator with frames_encode="full". The step's ValueErrors
carry JAX's messages word for word.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch
from maavss_tpu.models.fusion_frames import AVFusionFramesModel as JaxFrames
from maavss_tpu.train.infer import make_frames_separator as jax_separator
from maavss_tpu.train.state import create_train_state as jax_create_state
from maavss_tpu.train.state import make_optimizer as jax_make_optimizer
from maavss_tpu.train.steps import make_frames_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    random_flax_tree,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.train.infer import make_frames_separator
from maavss_tpu_torch.train.setup import build_frames_state
from maavss_tpu_torch.train.steps import make_frames_step
from tests.test_torch_workers import share_cores

share_cores()

GEOMETRY = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
                framesize=24, learning_rate=1e-3, batch_size=4,
                noise_scalar=0.0)
LATENT, MODE, SEED = 8, 2, 2025
LR = GEOMETRY["learning_rate"]
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4
CASES = {"full": dict(frames_encode="full"),
         "full-halo1-mb2": dict(frames_encode="full", frames_halo=1,
                                microbatch=2),
         "window-mb2": dict(microbatch=2)}


@pytest.fixture(autouse=True)
def _k5_stages(monkeypatch):
    monkeypatch.setenv("MAAVSS_S2D_MIN_HW", "8")


def _jax_model(cfg, batch):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFrames(
        stft_shape=(batch, 2, t_stft, cfg.fft_len // 2 + 1),
        frame_shape=(batch, 1, cfg.num_frames, cfg.framesize, cfg.framesize),
        hops_per_frame=cfg.hops_per_frame, latent_channels=LATENT)


@pytest.fixture(scope="module")
def variables():
    """Seeded weights over the flax model's leaf shapes
    (`random_flax_tree`; eval_shape traces the init without running it)."""
    cfg = JaxRunConfig(**GEOMETRY)
    model = _jax_model(cfg, cfg.batch_size)
    tree = jax.tree_util.tree_map(
        lambda s: np.empty(s.shape, s.dtype), jax.eval_shape(
            lambda: model.init(jax.random.PRNGKey(0),
                               jnp.zeros(model.stft_shape),
                               jnp.zeros(model.frame_shape),
                               method=model.init_all)))
    shapes = {k: v.shape for k, v in flatten_tree(
        {"params": tree["params"],
         "batch_stats": tree["batch_stats"]}).items()}
    return unflatten_tree(random_flax_tree(shapes, SEED))


def _batch(cfg, batch_size=None, seed=7):
    batch = synthetic_av_batch(cfg, batch_size or cfg.batch_size, seed=seed,
                               frame_size=cfg.framesize)
    noise = np.random.default_rng(98).standard_normal(
        batch["frames"].shape).astype(np.float32)
    batch["frames"] = np.clip(batch["frames"] + 0.1 * noise, 0.0, 1.0)
    return batch


def _port_state(cfg, variables):
    model, state = build_frames_state(cfg, cfg.batch_size,
                                      latent_channels=LATENT, device="cpu")
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]))
    return model, state


def _flat_copy(tree):
    # copies: on the CPU to_flax's arrays share the live tensors' memory
    return {k: np.array(v) for k, v in flatten_tree(tree).items()}


def _port_after(model, state):
    """Flat flax trees of the parameters, the statistics and Adam's first
    moment."""
    params, stats = to_flax(model.state_dict())
    names = [n for n, _ in model.named_parameters()]
    mu, _ = to_flax(dict(zip(names, state.tx.m)))
    return _flat_copy(params), _flat_copy(stats), _flat_copy(mu)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _is_shift(path):
    return path.endswith("BatchNorm_0/bias")


@pytest.mark.parametrize("case", list(CASES))
def test_step_tracks_jax(variables, case):
    flags = CASES[case]
    cfg_j = JaxRunConfig(**GEOMETRY).replace(**flags)
    batch = _batch(cfg_j)
    assert batch["frames"].shape[1] == 2 + 2 + 2 * cfg_j.frames_halo
    state_j = jax_create_state(variables, jax_make_optimizer(LR, "adam"))
    step_j = jax_make_step(_jax_model(cfg_j, cfg_j.batch_size), cfg_j)
    state_j, want = step_j(state_j, jax.tree_util.tree_map(jnp.asarray,
                                                           batch),
                           jax.random.PRNGKey(0), jnp.int32(MODE))
    params_j = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                   state_j.params))
    stats_j = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                  state_j.batch_stats))
    mu_j = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                               state_j.opt_state[0].mu))

    cfg = RunConfig(**GEOMETRY).replace(**flags)
    model, state = _port_state(cfg, variables)
    state, got = make_frames_step(model, cfg, device="cpu")(state, batch,
                                                            MODE)
    assert state.step == 1 and set(got) == set(want)
    for k in ("loss", "a_loss", "v_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, atol=0, err_msg=k)
    for k in want:  # the gradient and parameter norms
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=PARAM_RTOL, atol=1e-9, err_msg=k)
    params, stats, mu = _port_after(model, state)
    assert set(params) == set(params_j) and set(stats) == set(stats_j)
    for path, w in params_j.items():
        if _is_shift(path):
            np.testing.assert_allclose(params[path], w, rtol=0,
                                       atol=2e-3 * LR, err_msg=path)
            continue
        assert _rel(params[path], w) <= PARAM_RTOL, (path, _rel(params[path],
                                                                w))
        assert _rel(mu[path], mu_j[path]) <= PARAM_RTOL, path
    for path, w in stats_j.items():
        assert _rel(stats[path], w) <= PARAM_RTOL, (path, _rel(stats[path],
                                                               w))


def _port_run(cfg, variables, batch):
    model, state = _port_state(cfg, variables)
    state, m = make_frames_step(model, cfg, device="cpu")(state, batch, MODE)
    return {k: float(v) for k, v in m.items()}, _port_after(model, state)


def test_full_equals_window_at_one_window(variables):
    cfg = RunConfig(**GEOMETRY).replace(num_seq=1)
    batch = _batch(cfg)
    m_w, (p_w, s_w, _) = _port_run(cfg, variables, batch)
    m_f, (p_f, s_f, _) = _port_run(cfg.replace(frames_encode="full"),
                                   variables, batch)
    for k in ("loss", "a_loss", "v_loss"):
        np.testing.assert_allclose(m_f[k], m_w[k], rtol=1e-5, err_msg=k)
    for got, want in ((p_f, p_w), (s_f, s_w)):
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-6,
                                       err_msg=path)


@pytest.mark.parametrize("encode", ["full", "window"])
def test_duplicated_chunks_match_one_chunk(variables, encode):
    """Two equal halves: each chunk's BatchNorm sees the whole batch's
    statistics, so microbatch 2 gives microbatch 1's losses and gradient."""
    cfg = RunConfig(**GEOMETRY).replace(frames_encode=encode)
    half = _batch(cfg, batch_size=2, seed=2)
    batch = {k: np.concatenate([v, v]) for k, v in half.items()}
    m1, (_, _, mu1) = _port_run(cfg, variables, batch)
    m2, (_, _, mu2) = _port_run(cfg.replace(microbatch=2), variables, batch)
    for k in ("loss", "a_loss", "v_loss"):
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-5, err_msg=k)
    for path, g in mu1.items():
        if not _is_shift(path):
            assert _rel(mu2[path], g) <= 1e-5, (path, _rel(mu2[path], g))


def test_full_separator_matches_jax(variables):
    cfg_j = JaxRunConfig(**GEOMETRY).replace(frames_encode="full",
                                             batch_size=2)
    tree = {"params": variables["params"],
            "batch_stats": variables["batch_stats"]}
    batch = _batch(cfg_j, seed=4)
    assert batch["frames"].shape[1] == 4  # a served clip: no halo
    want = jax_separator(_jax_model(cfg_j, 2), cfg_j)(
        jax_create_state(tree, jax_make_optimizer(LR, "adam")),
        jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0))
    cfg = RunConfig(**GEOMETRY).replace(frames_encode="full", batch_size=2)
    model, _ = _port_state(cfg, variables)
    got = make_frames_separator(model, cfg)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert model.training  # the separator restores the mode
    for k in ("audio_out", "audio_in"):
        assert got[k].shape == want[k].shape
        assert _rel(got[k].numpy(), np.asarray(want[k])) <= 1e-4, k
    np.testing.assert_allclose(got["si_sdr"].numpy(), want["si_sdr"],
                               rtol=1e-4, atol=1e-4)
    # the window-mode separator gives other audio from the same weights
    window = make_frames_separator(model, cfg.replace(frames_encode="window"))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(window["audio_out"].numpy(), got["audio_out"].numpy()) > 1e-4


@pytest.mark.parametrize("flags", [
    dict(frames_encode="tiles"), dict(frames_halo=1),
    dict(frames_encode="full", frames_halo=-1),
], ids=["unknown-encode", "halo-without-full", "negative-halo"])
def test_step_checks_raise_jax_messages(flags):
    cfg_j = JaxRunConfig(**GEOMETRY).replace(**flags)
    with pytest.raises(ValueError) as want:
        jax_make_step(_jax_model(cfg_j, 4), cfg_j)
    with pytest.raises(ValueError) as got:
        make_frames_step(None, RunConfig(**GEOMETRY).replace(**flags),
                         device="cpu")
    assert str(got.value) == str(want.value)


def test_microbatch_that_does_not_divide_raises_jax_message(variables):
    flags = dict(frames_encode="full", microbatch=3)
    cfg_j = JaxRunConfig(**GEOMETRY).replace(**flags)
    batch = _batch(cfg_j)
    with pytest.raises(ValueError) as want:
        jax_make_step(_jax_model(cfg_j, 4), cfg_j)(
            jax_create_state(variables, jax_make_optimizer(LR, "adam")),
            jax.tree_util.tree_map(jnp.asarray, batch),
            jax.random.PRNGKey(0), jnp.int32(MODE))
    cfg = RunConfig(**GEOMETRY).replace(**flags)
    model, state = _port_state(cfg, variables)
    with pytest.raises(ValueError) as got:
        make_frames_step(model, cfg, device="cpu")(state, batch, MODE)
    assert str(got.value) == str(want.value)
    assert str(got.value) == "batch size 4 not divisible by microbatch 3"
