"""The staged-training regimes of the port against the JAX package on the
CPU, where the kernels run their plain versions (maavss_tpu_torch/train/
steps.py, ops/phasegram.py, models/fusion_conv.py, tools/fit_torch.py).

Same numpy inputs on both sides, the weights of one flax init carried
across by `convert.from_flax`, noise_scalar 0, broadband frames
(tests/test_torch_train_step.py's `_batch`), tests/test_train_steps.py's
small geometry at batch 4; one JAX compile per regime, cached for the
module.

- The staged AV step (train_av_net.py: `make_fusion_step` with only
  FUSION_SUBNETS trainable) against JAX's with the multi_transform mask,
  3 steps in modes 0, 1 and 2: losses within 1e-5 relative (1e-4 in
  modes 0 and 1, tests/test_torch_train_step.py's reason), the frozen
  leaves bit for bit at their start on both sides, the frozen encoders'
  running statistics within 1e-5 of JAX's (absolute, and relative where
  a statistic is larger than 1: a running mean near 1e-3 carries the conv
  sums' rounding at ~1e-5 of itself), the trainable leaves after
  step 1 within 1e-4 (relative L2), and the gradient norms (all leaves,
  frozen ones too) within 1e-4 in mode 2.
- The STFT-autoencoder and phasegram-autoencoder steps and evals: losses
  within 1e-5 relative over 3 steps, and the evals before and after.
- `video_phasegram` with resize on and off and each flag, against JAX's
  (max-abs-scaled error 1e-5, as tests/test_torch_frontend.py holds the
  phasegram halves).
- The middle-frame step at --microbatch 1 and 2 in modes 0, 1 and 2:
  losses within 1e-5 (mode 2, free running) or 1e-4 (modes 0 and 1, each
  step from JAX's state before it).
- AVFusionModelConv in eval and train mode within 1e-4 relative L2.
- tools/fit_torch.py's four new models run at the small geometry, write
  their checkpoints by their policy and resume; an av_net run from a
  --saved_model the JAX package wrote ends with the frozen leaves equal to
  the loaded ones.
"""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.models.fusion_conv import AVFusionModelConv as JaxConv
from maavss_tpu.ops import phasegram as j_pg
from maavss_tpu.train import steps as j_steps
from maavss_tpu.train.setup import FUSION_SUBNETS as JAX_SUBNETS
from maavss_tpu.train.state import create_train_state as jax_create_state
from maavss_tpu.train.state import make_optimizer as jax_make_optimizer
from maavss_tpu_torch.config import RunConfig, model_args
from maavss_tpu_torch.convert import flatten_tree, from_flax, to_flax
from maavss_tpu_torch.models.fusion_conv import AVFusionModelConv
from maavss_tpu_torch.ops import phasegram
from maavss_tpu_torch.train import steps
from maavss_tpu_torch.train.setup import FUSION_SUBNETS, build_fusion
from maavss_tpu_torch.train.state import create_train_state
from tests.test_torch_workers import share_cores
from tools import fit_torch

share_cores()

GEOMETRY = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
                batch_size=4, noise_scalar=0.0)
STEPS = 3
LR = GEOMETRY["learning_rate"]
LOSS_RTOL = {0: 1e-4, 1: 1e-4, 2: 1e-5}


def _jax_model(cfg):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFusion(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla")


def _batch(cfg, seed):
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=seed)
    noise = np.random.default_rng(99 + seed).standard_normal(
        batch["frames"].shape).astype(np.float32)
    batch["frames"] = np.clip(batch["frames"] + 0.1 * noise, 0.0, 1.0)
    return batch


@pytest.fixture(scope="module")
def setup_j():
    cfg = JaxRunConfig(**GEOMETRY)
    model = _jax_model(cfg)
    # one jit: the eager init's values, without its truncated normal
    # compiled once a kernel shape
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: model.init(key, jnp.zeros(model.stft_shape),
                               jnp.zeros(model.pgram_shape),
                               method=model.init_all))(
        jax.random.PRNGKey(0)))
    return cfg, model, variables, [_batch(cfg, 11 + i) for i in range(STEPS)]


_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _port(variables, trainable=None, **flags):
    cfg = RunConfig(**GEOMETRY).replace(**flags)
    model = build_fusion(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]))
    return cfg, model, create_train_state(model, cfg, "cpu",
                                          trainable=trainable)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _np_tree(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


# --- the staged AV step -----------------------------------------------------

def _jax_staged(setup_j, mode):
    """JAX's staged trajectory in `mode`: per-step metrics, and the
    (params, batch_stats) after step 1 and after the last step."""
    cfg, model, variables, batches = setup_j
    step = _cached("staged_step", lambda: j_steps.make_fusion_step(
        model, cfg))

    def run():
        tx = jax_make_optimizer(LR, "adam", trainable=JAX_SUBNETS,
                                params=variables["params"])
        state = jax_create_state(variables, tx)
        metrics, after = [], []
        for b in batches:
            state, m = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                            jax.random.PRNGKey(0), jnp.int32(mode))
            metrics.append({k: float(v) for k, v in m.items()})
            after.append((_np_tree(state.params),
                          _np_tree(state.batch_stats)))
        return metrics, after

    return _cached(("staged", mode), run)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_staged_step_tracks_jax(setup_j, mode):
    assert tuple(FUSION_SUBNETS) == tuple(JAX_SUBNETS)
    _, _, variables, batches = setup_j
    want, after = _jax_staged(setup_j, mode)
    cfg, model, state = _port(variables, trainable=FUSION_SUBNETS,
                              pgenc_kernel="pallas")
    init = flatten_tree(variables["params"])
    step = steps.make_fusion_step(model, cfg, device="cpu")
    frozen = {n.replace(".", "/") for n, t in zip(
        [n for n, _ in model.named_parameters()], state.tx.trainable)
        if not t}
    frozen_flax = {p for p in init if p.split("/")[0] not in FUSION_SUBNETS}
    got = []
    for i, b in enumerate(batches):
        state, m = step(state, b, mode)
        got.append({k: float(v) for k, v in m.items()})
        params, stats = (flatten_tree(t) for t in to_flax(model.state_dict()))
        params_j, stats_j = after[i]
        for path in frozen_flax:  # bit for bit at their start, both sides
            np.testing.assert_array_equal(params[path], init[path],
                                          err_msg=path)
            np.testing.assert_array_equal(params_j[path], init[path],
                                          err_msg=path)
        for path, w in stats_j.items():  # the frozen encoders' statistics
            np.testing.assert_allclose(stats[path], w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i + 1} {path}")
        if i == 0:
            for path, w in params_j.items():
                if path not in frozen_flax:
                    assert _rel(params[path], w) <= 1e-4, path
    assert len(frozen) == len(frozen_flax) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "a_loss", "v_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL[mode],
                                       atol=0, err_msg=k)
    if mode == 2:
        for k, w in want[0].items():
            if k.startswith("grad_norm") or k == "param_norm":
                np.testing.assert_allclose(got[0][k], w, rtol=1e-4,
                                           atol=1e-9, err_msg=k)


# --- the autoencoder regimes ------------------------------------------------

AE = {
    "audio": (j_steps.make_audio_ae_step, j_steps.make_audio_ae_eval,
              steps.make_audio_ae_step, steps.make_audio_ae_eval),
    "visual": (j_steps.make_visual_ae_step, j_steps.make_visual_ae_eval,
               steps.make_visual_ae_step, steps.make_visual_ae_eval),
}


def _jax_ae(setup_j, kind):
    """JAX's AE trajectory: per-step metrics, the eval at the init and
    after the last step, and the (params, batch_stats) after it."""
    cfg, model, variables, batches = setup_j
    make_step, make_eval = AE[kind][:2]

    def run():
        step, evaluate = make_step(model, cfg), make_eval(model, cfg)
        state = jax_create_state(variables, jax_make_optimizer(LR, "adam"))
        batch0 = jax.tree_util.tree_map(jnp.asarray, batches[0])
        evals = [float(evaluate(state, batch0, jax.random.PRNGKey(0),
                                jnp.int32(2))["loss"])]
        metrics = []
        for b in batches:
            state, m = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                            jax.random.PRNGKey(0), jnp.int32(2))
            metrics.append({k: float(v) for k, v in m.items()})
        evals.append(float(evaluate(state, batch0, jax.random.PRNGKey(0),
                                    jnp.int32(2))["loss"]))
        last = jax.tree_util.tree_map(np.asarray, (state.params,
                                                   state.batch_stats))
        return metrics, evals, last

    return _cached(("ae", kind), run)


@pytest.mark.parametrize("pgenc_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["audio", "visual"])
def test_autoencoder_step_and_eval_track_jax(setup_j, kind, pgenc_kernel):
    """The steps run free; each eval is held on JAX's state (at the init,
    and after JAX's last step, loaded into the port): the conv biases that
    feed a train-mode BatchNorm take noise-driven steps of up to lr in
    either framework (tests/test_torch_train_step.py), which eval mode,
    where no batch mean cancels them, would otherwise read."""
    _, _, variables, batches = setup_j
    want, want_evals, (params_j, stats_j) = _jax_ae(setup_j, kind)
    cfg, model, state = _port(variables, pgenc_kernel=pgenc_kernel)
    make_step, make_eval = AE[kind][2:]
    step = make_step(model, cfg, device="cpu")
    evaluate = make_eval(model, cfg, device="cpu")
    evals = [float(evaluate(state, batches[0], 2)["loss"])]
    assert model.training
    got = []
    for b in batches:
        state, m = step(state, b, 2)
        got.append({k: float(v) for k, v in m.items()})
    assert state.step == STEPS
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "a_loss", "v_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=0,
                                       err_msg=k)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4)
    model.load_state_dict(from_flax(params_j, stats_j))
    evals.append(float(evaluate(state, batches[0], 2)["loss"]))
    np.testing.assert_allclose(evals, want_evals, rtol=1e-5, atol=0)
    assert got[-1]["loss"] < got[0]["loss"]


@pytest.mark.parametrize("hw, resize, flags", [
    (16, None, {}), (24, (16, 16), {}), (12, (16, 16), {}),
    (16, None, dict(diff=False)), (16, None, dict(cumulative=False)),
    (16, None, dict(normalize=False)),
])
def test_video_phasegram_matches_jax(hw, resize, flags):
    frames = np.random.default_rng(3).uniform(0, 1, (2, 1, 6, hw, hw)).astype(
        np.float32)
    got = phasegram.video_phasegram(torch.from_numpy(frames), resize=resize,
                                    **flags).numpy()
    want = np.asarray(j_pg.video_phasegram(jnp.asarray(frames),
                                           resize=resize, **flags))
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= 1e-5, err
    if not flags:  # the two halves, as the JAX docstring states
        rows = phasegram.phasegram_cumsum(torch.from_numpy(frames),
                                          resize=resize)
        assert torch.equal(phasegram.phasegram_window(rows),
                           torch.from_numpy(got))


# --- the middle-frame objective ---------------------------------------------

def _jax_middle(setup_j, mb, mode):
    cfg, model, variables, batches = setup_j
    step = _cached(("middle_step", mb), lambda: j_steps.make_fusion_middle_step(
        model, cfg.replace(microbatch=mb)))

    def run():
        state = jax_create_state(variables, jax_make_optimizer(LR, "adam"))
        metrics, before = [], []
        for b in batches:
            adam = state.opt_state[0]
            before.append(jax.tree_util.tree_map(np.asarray, (
                state.params, state.batch_stats, adam.mu, adam.nu,
                adam.count)))
            state, m = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                            jax.random.PRNGKey(0), jnp.int32(mode))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, before

    return _cached(("middle", mb, mode), run)


def _load_jax_state(state, jax_state):
    params, batch_stats, mu, nu, count = jax_state
    state.model.load_state_dict(from_flax(params, batch_stats))
    names = [n for n, _ in state.model.named_parameters()]
    for moments, tree in ((state.tx.m, mu), (state.tx.v, nu)):
        sd = from_flax(tree)
        for dst, name in zip(moments, names):
            dst.copy_(sd[name])
    state.tx.count = int(count)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("mb", [1, 2])
def test_middle_step_tracks_jax(setup_j, mb, mode):
    _, _, variables, batches = setup_j
    want, before = _jax_middle(setup_j, mb, mode)
    cfg, model, state = _port(variables, microbatch=mb)
    step = steps.make_fusion_middle_step(model, cfg, device="cpu")
    got = []
    for i, b in enumerate(batches):
        if mode != 2 and i > 0:
            _load_jax_state(state, before[i])
        state, m = step(state, b, mode)
        got.append({k: float(v) for k, v in m.items()})
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "a_loss", "v_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL[mode],
                                       atol=0, err_msg=k)


# --- AVFusionModelConv ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _conv_variables(sa, sp):
    """(flax AVFusionModelConv, its init under one jit: the eager init's
    values, without its truncated normal compiled once a kernel shape)."""
    model_j = JaxConv(stft_shape=sa, pgram_shape=sp, latent_channels=8,
                      fc_size=256)
    return model_j, jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: model_j.init(key, jnp.zeros(sa), jnp.zeros(sp),
                                 method=model_j.init_all))(
        jax.random.PRNGKey(0)))


@pytest.mark.parametrize("train", [False, True])
def test_fusion_conv_forward_matches_jax(train):
    sa, sp = (4, 2, 16, 32), (4, 1, 4, 256)
    model_j, variables = _conv_variables(sa, sp)
    variables = jax.tree_util.tree_map(np.copy, variables)
    rng = np.random.default_rng(5)
    x_a = rng.standard_normal(sa).astype(np.float32)
    x_v = rng.standard_normal(sp).astype(np.float32)
    model = AVFusionModelConv(sa, sp, latent_channels=8, fc_size=256)
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]))
    assert not any(n.endswith("bias") for n, _ in model.named_parameters()
                   if "Conv" in n)
    model.train(train)
    got = model(torch.from_numpy(x_a), torch.from_numpy(x_v))
    if train:
        want, mut = model_j.apply(variables, x_a, x_v, train=True,
                                  mutable=["batch_stats"])
        stats = flatten_tree(to_flax(model.state_dict())[1])
        for path, w in _np_tree(mut["batch_stats"]).items():
            assert _rel(stats[path], w) <= 1e-4, path
    else:
        want = model_j.apply(variables, x_a, x_v, train=False)
    for g, w in zip(got, want):
        assert _rel(g.detach().numpy(), np.asarray(w)) <= 1e-4


# --- tools/fit_torch.py -----------------------------------------------------

SMALL = ["--device", "cpu", "--data_path", "synthetic", "-s", "2", "-v", "1",
         "-a", "4",
         "-b", "2", "--num_frames", "4", "--fft_len", "64", "--p_size", "16",
         "--latent_chan", "8", "--fc_size", "256", "-lr", "1e-3"]


def _fit(model_name, extra=()):
    argv = ["--model", model_name, *SMALL, *extra]
    own = [a for a in argv if a not in ("--model", model_name, "--device",
                                        "cpu")]
    return fit_torch.fit(model_args(own), model_name, "cpu")


@pytest.mark.parametrize("model_name, prefix, policy_every_epoch", [
    ("audio_net", "audio-net", False), ("autoencoder", "stft-ae", True),
    ("visual_net", "visual-net", False), ("av_net", "av-net", False),
])
def test_fit_tool_runs_and_resumes(model_name, prefix, policy_every_epoch,
                                   tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    state = _fit(model_name, ["-e", "2"])
    assert state.step == 4
    cps = glob.glob(os.path.join("checkpoints", f"{prefix}-*.ckpt.pt"))
    assert len(cps) == 1
    saved = torch.load(cps[0], weights_only=True)
    # 'epoch' saves at the end of every epoch; 'best' at a lower val loss
    if policy_every_epoch:
        assert saved["epoch"] == 1
    else:
        assert saved["epoch"] in (0, 1) and "val_loss" in capsys.readouterr().out
    models = glob.glob(os.path.join("saved_models", f"{prefix}-*"))
    assert len(models) == (1 if model_name == "autoencoder" else 0)
    if model_name == "av_net":
        trained = {n for n, t in zip(
            [n for n, _ in state.model.named_parameters()],
            state.tx.trainable) if t}
        assert set(saved["opt"]["m"]) == trained
        assert all(n.split(".")[0] in FUSION_SUBNETS for n in trained)
    resumed = _fit(model_name, ["-e", "3", "-c", "--cp_load_opt"])
    assert resumed.step == saved["step"] + 2 * (3 - saved["epoch"])
    assert resumed.tx.count == resumed.step


def test_av_net_from_jax_saved_model_keeps_the_frozen_leaves(
        setup_j, tmp_path, monkeypatch):
    from maavss_tpu.exp.checkpoint import save_model as jax_save_model

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MAAVSS_CKPT_BACKEND", "pkl")
    _, _, variables, _ = setup_j
    path = jax_save_model(os.path.join(str(tmp_path), "pretrained", "ae"),
                          variables["params"])
    state = _fit("av_net", ["-e", "1", "--saved_model", path])
    loaded = from_flax(variables["params"])
    moved = 0
    for (n, p), train in zip(state.model.named_parameters(),
                             state.tx.trainable):
        if train:
            moved += not torch.equal(p.detach(), loaded[n])
        else:
            assert torch.equal(p.detach(), loaded[n]), n
    assert moved
