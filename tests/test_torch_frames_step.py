"""The port's frames train step (maavss_tpu_torch/train/steps.py:
make_frames_step, window mode) against the JAX `make_frames_step`, as a
whole, on the CPU.

Both start from one flax init (carried across with `from_flax`) at the small
geometry of tests/test_frames_fullseq.py (framesize 24, num_frames 2,
num_seq 2, fft 64, latent 8, batch 4, lr 1e-3) with noise_scalar 0, and
train on one synthetic batch with broadband frame noise. MAAVSS_S2D_MIN_HW=8
makes the encoder's stages 0 and 1 take the fused epilogue in train mode on
both sides (JAX: MAAVSS_CONV3D=s2d, MAAVSS_EPILOGUE=fused, Pallas in
interpret mode), as at the flagship's framesize 256.

Tolerances: per-step losses relative 1e-5 over 3 steps in mode 2 (the two
frameworks sum convolutions and matmuls in other orders; the fusion step
tracks to ~1e-6, tests/test_torch_train_step.py); every parameter leaf and
BN statistic after step 1 relative L2 1e-4 (measured <= 3.5e-6), except
the BatchNorm shifts, held within 2e-3 lr per element. A shift's gradient
is a sum over the whole batch, and where the next train-mode BN nearly
cancels it, it is tiny: one channel of stage 1's is 4.5e-7 (the median
1e-5), and its last digits follow the summation order. Adam's first step
is lr * g / (|g| + 1e-8), so those digits reach the parameter: that leaf's
relative L2 ranged 8.0e-5 to 1.6e-4 with the CPU thread count (1 to 12),
its largest element difference 4.2e-4 to 7.9e-4 lr. The frames model has
no conv bias (its stacks are bias-free), so no leaf has the noise-driven
Adam update of a bias that feeds a train-mode BatchNorm. Modes 0 and 1 (with
objective_zeros, so all four masks act) are compared on the first step's
losses only: a zeroed encoder's gradients are float noise, and free-running
trajectories drift (tests/test_torch_train_step.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch
from maavss_tpu.models.fusion_frames import AVFusionFramesModel as JaxFrames
from maavss_tpu.train.state import create_train_state as jax_create_state
from maavss_tpu.train.state import make_optimizer as jax_make_optimizer
from maavss_tpu.train.steps import make_frames_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import flatten_tree, from_flax, to_flax
from maavss_tpu_torch.ops.cuda_epilogue import epilogue_stats
from maavss_tpu_torch.train.setup import build_frames_state
from maavss_tpu_torch.train.steps import make_frames_step
from tests.test_torch_workers import share_cores

share_cores()

GEOMETRY = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
                framesize=24, learning_rate=1e-3, batch_size=4,
                noise_scalar=0.0, objective_zeros=True)
LATENT = 8
STEPS = 3
ENV = dict(MAAVSS_CONV3D="s2d", MAAVSS_EPILOGUE="fused", MAAVSS_S2D_MIN_HW="8")


def _batch(cfg):
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=7,
                               frame_size=cfg.framesize)
    noise = np.random.default_rng(98).standard_normal(
        batch["frames"].shape).astype(np.float32)
    batch["frames"] = np.clip(batch["frames"] + 0.1 * noise, 0.0, 1.0)
    return batch


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trajectories: 3 steps in mode 2, 1 step in modes 0 and 1,
    under the fused-epilogue environment (read while tracing)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        cfg = JaxRunConfig(**GEOMETRY)
        t_stft = cfg.hops_per_frame * cfg.num_frames
        model = JaxFrames(
            stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2 + 1),
            frame_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.framesize,
                         cfg.framesize),
            hops_per_frame=cfg.hops_per_frame, latent_channels=LATENT)
        variables = model.init(jax.random.PRNGKey(0),
                               jnp.zeros(model.stft_shape),
                               jnp.zeros(model.frame_shape),
                               method=model.init_all)
        variables = jax.tree_util.tree_map(np.asarray, variables)
        batch_np = _batch(cfg)
        batch = jax.tree_util.tree_map(jnp.asarray, batch_np)
        step = jax_make_step(model, cfg)
        # one optimizer object: it is a static field of the state, and a
        # new one would compile the step again for each mode
        tx = jax_make_optimizer(cfg.learning_rate, "adam")
        runs = {}
        for mode, n in ((2, STEPS), (0, 1), (1, 1)):
            state = jax_create_state(variables, tx)
            metrics, after1 = [], None
            for i in range(n):
                state, m = step(state, batch, jax.random.PRNGKey(0),
                                jnp.int32(mode))
                metrics.append({k: float(v) for k, v in m.items()})
                if i == 0:
                    after1 = flatten_tree(jax.tree_util.tree_map(
                        np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats}))
            runs[mode] = (metrics, after1)
    return variables, batch_np, runs


def _port_run(variables, batch, mode, n):
    cfg = RunConfig(**GEOMETRY)
    model, state = build_frames_state(cfg, cfg.batch_size,
                                      latent_channels=LATENT, device="cpu")
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]))
    step = make_frames_step(model, cfg, device="cpu")
    metrics, after1 = [], None
    for i in range(n):
        state, m = step(state, batch, mode)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            params, stats = to_flax(model.state_dict())
            # copies: on the CPU the arrays share the live tensors' memory
            after1 = {k: v.copy() for k, v in flatten_tree(
                {"params": params, "batch_stats": stats}).items()}
    assert state.step == n and model.training
    return metrics, after1


def test_step_tracks_jax_mode2(jax_runs, monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    variables, batch, runs = jax_runs
    want, want1 = runs[2]
    got, got1 = _port_run(variables, batch, 2, STEPS)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "a_loss", "v_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=0,
                                       err_msg=k)
    # the first step's gradient and parameter norms, globally and per module
    for k, w in want[0].items():
        np.testing.assert_allclose(got[0][k], w, rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    assert set(got1) == set(want1)
    lr = GEOMETRY["learning_rate"]
    for path, w in want1.items():
        if path.endswith("BatchNorm_0/bias"):
            # see the module docstring: Adam's step on a BN shift
            np.testing.assert_allclose(got1[path], w, rtol=0, atol=2e-3 * lr,
                                       err_msg=path)
            continue
        rel = (np.linalg.norm(got1[path] - w)
               / max(np.linalg.norm(w), 1e-12))
        assert rel <= 1e-4, (path, rel)


@pytest.mark.parametrize("mode", [0, 1])
def test_first_step_losses_track_jax_modes_0_1(jax_runs, monkeypatch, mode):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    variables, batch, runs = jax_runs
    want, _ = runs[mode]
    got, _ = _port_run(variables, batch, mode, 1)
    for k in ("loss", "a_loss", "v_loss"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    # objective_zeros: mode 0 zeroes the frame target, mode 1 the audio one
    assert (got[0]["a_loss"] if mode == 1 else got[0]["v_loss"]) > 0


def test_fused_stages_counted_per_window(monkeypatch):
    """With MAAVSS_S2D_MIN_HW=8, each window of a step runs the fused
    epilogue's statistics once for each of stages 0 and 1 (on the card
    `epilogue_stats.launches` counts the same calls: 2 per window)."""
    monkeypatch.setenv("MAAVSS_S2D_MIN_HW", "8")
    calls = []
    import maavss_tpu_torch.ops.cuda_epilogue as ep

    real = ep.epilogue_stats

    def spy(y):
        calls.append(tuple(y.shape))
        return real(y)

    monkeypatch.setattr(ep, "epilogue_stats", spy)
    cfg = RunConfig(**GEOMETRY)
    model, state = build_frames_state(cfg, 2, latent_channels=LATENT,
                                      device="cpu")
    batch = _batch(cfg.replace(batch_size=2))
    make_frames_step(model, cfg, device="cpu")(state, batch, 2)
    assert calls == [(2, 16, 2, 24, 24), (2, 32, 2, 12, 12)] * cfg.num_seq
    assert epilogue_stats.launches == 0  # the CPU runs the plain version
    monkeypatch.setenv("MAAVSS_S2D_MIN_HW", "128")
    calls.clear()
    make_frames_step(model, cfg, device="cpu")(state, batch, 2)
    assert calls == []
