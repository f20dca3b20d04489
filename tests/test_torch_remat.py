"""--remat in the port (maavss_tpu_torch/train/steps.py:_train_apply), on
the CPU, where the kernels run their plain versions.

- The remat step equals the plain step bit for bit (loss, every
  parameter, every BatchNorm running statistic, Adam's moments) for the
  fusion scan, vectorized and full-encode steps, the middle-frame step
  and the frames window and full-encode steps, under both
  MAAVSS_REMAT_POLICY values.
- A recompute that updated the running statistics a second time would
  show: with the recompute's freeze taken away, the statistics differ.
- The step's forward draws nothing: with noise 0.1 drawn from one
  generator seed the remat step equals the plain one, and no default
  generator moves.
- The port's remat step tracks the JAX package's remat step
  (tests/test_train_steps.py:test_remat_step_matches_plain's pattern:
  one JAX compile), losses within 1e-5 relative.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch as jax_batch
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.train.state import create_train_state as jax_create_state
from maavss_tpu.train.state import make_optimizer as jax_make_optimizer
from maavss_tpu.train.steps import make_fusion_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import flatten_tree, from_flax, to_flax
from maavss_tpu_torch.data.synthetic import synthetic_av_batch
from maavss_tpu_torch.train import setup, steps
from maavss_tpu_torch.train.state import create_train_state
from tests.test_torch_workers import share_cores

share_cores()

# tests/test_train_steps.py:31-34's geometry at batch 4
GEOMETRY = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
                batch_size=4, noise_scalar=0.0)
# tests/test_torch_frames.py's geometry, with K5 at stages 0 and 1
FRAMES = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
              framesize=24, batch_size=2, learning_rate=1e-3,
              noise_scalar=0.0)
STEPS = 2
# the model method only the full-encode steps call
FULL_ENCODERS = {"fusion_full": "encode_both", "frames_full": "encode_frames"}
CASES = {
    "fusion_scan": (False, {}, steps.make_fusion_step),
    "fusion_vectorized": (False, dict(window_mode="vectorized"),
                          steps.make_fusion_step),
    "fusion_full": (False, dict(fusion_encode="full"),
                    steps.make_fusion_step),
    "middle": (False, {}, steps.make_fusion_middle_step),
    "frames_window": (True, {}, steps.make_frames_step),
    "frames_full": (True, dict(frames_encode="full", frames_halo=1),
                    steps.make_frames_step),
}


def _run(kind, remat, monkeypatch, noise=0.0, generator_seed=None,
         n_steps=STEPS):
    """(final state, [losses], whether the process's default generator
    moved during the steps) of `n_steps` steps of case `kind` from one
    seeded model, remat on or off."""
    frames_model, flags, make = CASES[kind]
    if frames_model:
        monkeypatch.setenv("MAAVSS_S2D_MIN_HW", "8")
        cfg = RunConfig(**FRAMES).replace(**flags)
        build = functools.partial(setup.build_frames_state,
                                  latent_channels=8)
        fs = 24
    else:
        cfg = RunConfig(**GEOMETRY).replace(**flags)
        build, fs = setup.build_fusion_state, None
    cfg = cfg.replace(remat=remat, noise_scalar=noise)
    model, state = build(cfg, cfg.batch_size, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    trunk = FULL_ENCODERS.get(kind)
    calls = []
    if trunk:  # the full-encode step must take its full-encode path
        method = getattr(model, trunk)
        setattr(model, trunk,
                lambda *a: calls.append(1) or method(*a))
    step = make(model, cfg, device="cpu")
    gen = (None if generator_seed is None
           else torch.Generator().manual_seed(generator_seed))
    batches = [synthetic_av_batch(cfg, cfg.batch_size, seed=i, frame_size=fs)
               for i in range(n_steps)]
    losses, before = [], torch.get_rng_state()
    for batch in batches:
        state, m = step(state, batch, 2, gen)
        losses.append(m["loss"])
    assert bool(calls) == bool(trunk), kind
    return state, losses, not torch.equal(torch.get_rng_state(), before)


def _assert_same(a, b, what):
    for (n, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(x, y), f"{what}: {n}"
    for x, y in zip(a.tx.m + a.tx.v, b.tx.m + b.tx.v):
        assert torch.equal(x, y), f"{what}: Adam moments"


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("kind", list(CASES))
def test_remat_step_equals_plain_step_bit_for_bit(kind, policy,
                                                  monkeypatch):
    monkeypatch.setenv("MAAVSS_REMAT_POLICY", policy)
    plain, plain_losses, _ = _run(kind, False, monkeypatch)
    remat, remat_losses, _ = _run(kind, True, monkeypatch)
    assert [float(v) for v in remat_losses] == [float(v)
                                                for v in plain_losses]
    _assert_same(remat, plain, f"{kind} {policy}")


@pytest.mark.parametrize("kind", ["fusion_scan", "frames_full"])
def test_a_doubled_running_statistics_update_would_show(kind, monkeypatch):
    """The recompute's freeze is what keeps the statistics right: without
    it the backward's second forward applies the 0.9 / 0.1 update again
    and the running statistics part from the plain step's."""
    plain, _, _ = _run(kind, False, monkeypatch, n_steps=1)
    monkeypatch.setattr(steps, "running_stats_frozen",
                        contextlib.nullcontext)
    doubled, _, _ = _run(kind, True, monkeypatch, n_steps=1)
    stats = [n for n, _ in plain.model.named_buffers()]
    differ = [n for n in stats if not torch.equal(
        plain.model.get_buffer(n), doubled.model.get_buffer(n))]
    assert differ and all(n.endswith(("running_mean", "running_var"))
                          for n in differ)


def test_remat_forward_draws_nothing(monkeypatch):
    """Noise 0.1 from one generator seed: the remat step still equals the
    plain step, and the process's default generator never moves, so the
    checkpoint keeps no RNG state (preserve_rng_state=False)."""
    plain, plain_losses, moved = _run("fusion_full", False, monkeypatch,
                                      noise=0.1, generator_seed=3)
    remat, remat_losses, remat_moved = _run("fusion_full", True,
                                            monkeypatch, noise=0.1,
                                            generator_seed=3)
    assert not moved and not remat_moved
    assert [float(v) for v in remat_losses] == [float(v)
                                                for v in plain_losses]
    _assert_same(remat, plain, "noise 0.1")


def test_remat_policy_rejects_unknown(monkeypatch):
    monkeypatch.setenv("MAAVSS_REMAT_POLICY", "offload")
    with pytest.raises(ValueError, match="full|dots"):
        steps.remat_policy()


def test_remat_step_tracks_jax_remat_step():
    """The port's and the JAX package's --remat fusion scan step (mode 2)
    from one flax init over two steps: losses within 1e-5 relative, the
    parameters after them as tests/test_torch_train_step.py holds them
    (the BN-fed conv biases within lr a step of their start)."""
    lr = GEOMETRY["learning_rate"]
    cfg_j = JaxRunConfig(**GEOMETRY).replace(remat=True)
    t_stft = cfg_j.hops_per_frame * cfg_j.num_frames
    model_j = JaxFusion(
        stft_shape=(cfg_j.batch_size, 2, t_stft, cfg_j.fft_len // 2),
        pgram_shape=(cfg_j.batch_size, 1, cfg_j.num_frames,
                     cfg_j.p_size ** 2),
        latent_channels=cfg_j.latent_chan, fc_size=cfg_j.fc_size,
        pgenc_kernel="xla")
    variables = jax.tree_util.tree_map(np.asarray, model_j.init(
        jax.random.PRNGKey(0), jnp.zeros(model_j.stft_shape),
        jnp.zeros(model_j.pgram_shape), method=model_j.init_all))
    batches = []
    for i in range(STEPS):
        b = jax_batch(cfg_j, cfg_j.batch_size, seed=11 + i)
        noise = np.random.default_rng(99 + i).standard_normal(
            b["frames"].shape).astype(np.float32)
        b["frames"] = np.clip(b["frames"] + 0.1 * noise, 0.0, 1.0)
        batches.append(b)
    state_j = jax_create_state(variables, jax_make_optimizer(lr, "adam"))
    step_j = jax_make_step(model_j, cfg_j)
    want = []
    for b in batches:
        state_j, m = step_j(state_j, jax.tree_util.tree_map(jnp.asarray, b),
                            jax.random.PRNGKey(0), jnp.int32(2))
        want.append(float(m["loss"]))
    params_j = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                   state_j.params))

    cfg = RunConfig(**GEOMETRY).replace(remat=True, pgenc_kernel="xla")
    model = setup.build_fusion(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]))
    state = create_train_state(model, cfg, "cpu")
    step = steps.make_fusion_step(model, cfg, device="cpu")
    got = []
    for b in batches:
        state, m = step(state, b, 2)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    params = flatten_tree(to_flax(model.state_dict())[0])
    init = flatten_tree(variables["params"])
    fed = {k.replace(".", "/") for k in model.bn_fed_biases()}
    for path, w in params_j.items():
        if path in fed:
            for side in (params[path], w):
                np.testing.assert_allclose(side, init[path],
                                           atol=STEPS * lr * 1.0001, rtol=0,
                                           err_msg=path)
            continue
        rel = np.linalg.norm(params[path] - w) / max(np.linalg.norm(w),
                                                      1e-12)
        assert rel <= 1e-4, (path, rel)


@pytest.mark.cuda
def test_remat_step_equals_plain_step_on_card():
    """On the card, under cuDNN's deterministic algorithms: the remat
    fusion scan step equals the plain one bit for bit, and each forward
    kernel in a checkpointed window launches twice a window."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode); "
                    "chip_smoke.py's remat phase holds every case there")
    from maavss_tpu_torch.ops.cuda_lstm import lstm_recurrence

    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for remat in (False, True):
            cfg = RunConfig(**GEOMETRY).replace(remat=remat)
            model, state = setup.build_fusion_state(
                cfg, cfg.batch_size, "cuda", torch.Generator().manual_seed(0))
            step = steps.make_fusion_step(model, cfg, device="cuda")
            lstm_recurrence.launches = 0
            state, m = step(state, synthetic_av_batch(cfg, cfg.batch_size,
                                                      seed=0), 2)
            out[remat] = (state, m["loss"], lstm_recurrence.launches)
        assert torch.equal(out[True][1], out[False][1])
        _assert_same(out[True][0], out[False][0], "card")
        assert out[True][2] == 2 * out[False][2] == 2 * GEOMETRY["num_seq"]
    finally:
        torch.backends.cudnn.deterministic = False
