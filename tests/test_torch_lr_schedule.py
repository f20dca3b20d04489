"""--lr_schedule in the port (train/state.py:resolve_lr, FusedAdam) against
the JAX package's optax schedules (maavss_tpu/train/setup.py:resolve_lr),
on the CPU.

- The rate: the port computes it on the parameters' device from the
  optimizer's count, by torch ops in fp32, before the count's increment,
  as optax's `scale_by_schedule` does (step n takes `schedule(n - 1)`).
  At every step of a 100-step horizon it equals optax's within 1e-6
  relative (the two compute the same fp32 operations; cos may differ by
  an ulp), for both schedules, the default warmup of total // 20 and an
  explicit one, with and without a floor (--lr_final_scale).
- Six fusion train steps under each schedule against JAX's with
  --opt_kernel xla (optax.adam on the schedule), from one flax init, in
  mode 2. fp32 (the window geometry of tests/test_torch_train_step.py):
  losses within its 1e-5, and every leaf after the six steps within its
  1e-4 relative L2 but the conv biases that feed a train-mode BatchNorm
  (true gradient 0, rounding noise that Adam turns into +-lr: each side
  within the sum of the six rates of the common start). bf16 (the
  full-encode geometry of tests/test_torch_bf16.py, float16 rows, JAX on
  its kernels' paths): losses within its 5e-4, and the port's fp32 leaves'
  updates within its GRAD_RATIO of JAX's bf16-vs-fp32 distance.
- The refusal the JAX package makes, a schedule with its Pallas Adam
  ("the fused flat/pallas kernels bake a scalar LR"), is lifted in the
  port: K3 reads [c1, c2, lr] from the card, so a schedule runs with
  --opt_kernel auto|pallas. --fused_opt still raises (not carried).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch as jax_synthetic
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.ops.phasegram import phasegram_cumsum as jax_cumsum
from maavss_tpu.train.setup import resolve_lr as jax_resolve_lr
from maavss_tpu.train.state import create_train_state as jax_create_state
from maavss_tpu.train.state import make_optimizer as jax_make_optimizer
from maavss_tpu.train.steps import make_fusion_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.ops.cuda_adam import adam_multi_tensor
from maavss_tpu_torch.train.fused_adam import FusedAdam
from maavss_tpu_torch.train.setup import build_fusion_state
from maavss_tpu_torch.train.state import make_optimizer, resolve_lr
from maavss_tpu_torch.train.steps import make_fusion_step
from tests.test_torch_workers import share_cores

share_cores()

STEPS = 6
# tests/test_torch_train_step.py's window geometry and gates (mode 2)
FP32 = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
            p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
            batch_size=4, noise_scalar=0.0, pgenc_kernel="xla")
FP32_LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4
# tests/test_torch_bf16.py's full-encode geometry and gates
BF16 = dict(num_frames=4, num_seq=2, hops_per_frame=4, fft_len=64,
            p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-4,
            batch_size=4, noise_scalar=0.0, fusion_encode="full",
            pgram_cache=True, pgenc_kernel="xla")
BF16_LOSS_RTOL, GRAD_RATIO = 5e-4, 2.0
JAX_BF16_ENV = dict(MAAVSS_LSTM="pallas")
SCHEDULES = ("cosine", "warmup_cosine")
HORIZON = dict(epochs=1, steps_per_epoch=STEPS)


@contextlib.contextmanager
def _env(values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("flags", [
    dict(lr_schedule="cosine"),
    dict(lr_schedule="warmup_cosine"),
    dict(lr_schedule="cosine", lr_final_scale=0.1),
    dict(lr_schedule="warmup_cosine", warmup_steps=7, lr_final_scale=0.05),
])
def test_rate_equals_optax_at_every_step(flags):
    common = dict(epochs=4, steps_per_epoch=25, learning_rate=1e-3, **flags)
    want_fn = jax_resolve_lr(JaxRunConfig(**common))
    p = torch.zeros(3)
    p.grad = torch.zeros(3)
    opt = FusedAdam([p], resolve_lr(RunConfig(**common)), kernel="xla")
    for n in range(1, 101):
        opt.step()
        got, want = float(opt.bc[2]), float(want_fn(jnp.int32(n - 1)))
        if want == 0.0:  # warmup's first step
            assert got == 0.0, n
        else:
            assert abs(got - want) <= 1e-6 * abs(want), (n, got, want)
    assert opt.count == 100 and float(opt.count_tensor) == 100.0


def test_constant_rate_is_the_float():
    """--lr_schedule constant stays a Python float on the plain leaves and
    the kernel's [c1, c2, lr] holds its fp32 rounding."""
    cfg = RunConfig(learning_rate=3e-4)
    assert resolve_lr(cfg) == 3e-4 and isinstance(resolve_lr(cfg), float)
    p = torch.zeros(2)
    opt = FusedAdam([p], resolve_lr(cfg), kernel="xla")
    assert opt.lr == 3e-4 and opt.schedule is None
    assert float(opt.bc[2]) == float(np.float32(3e-4))


def test_schedule_refusal_lifted():
    """The JAX package refuses a schedule with its Pallas Adam, whose kernel
    takes the rate as a constant; the port's K3 reads it from the card, so
    the port builds the same optimizer with every kernel choice, and its
    multi-tensor update (here its plain version) takes the rate from
    [c1, c2, lr]."""
    jcfg = JaxRunConfig(lr_schedule="cosine", **HORIZON)
    with pytest.raises(ValueError, match="bake a scalar LR"):
        jax_make_optimizer(jax_resolve_lr(jcfg), "adam", kernel="pallas")
    cfg = RunConfig(lr_schedule="cosine", **HORIZON)
    for kernel in ("auto", "pallas", "xla"):
        tx = make_optimizer([("w", torch.zeros(4))], resolve_lr(cfg),
                            kernel=kernel)
        assert callable(tx.schedule) and tx.bc.shape == (3,)
    with pytest.raises(NotImplementedError, match="Not carried"):
        make_optimizer([("w", torch.zeros(4))], resolve_lr(cfg), flat=True)
    g = torch.ones(4)
    m, v, p = torch.zeros(4), torch.zeros(4), torch.zeros(4)
    adam_multi_tensor([g], [m], [v], [p], torch.tensor([0.1, 0.001, 0.0]),
                      0.9, 0.999, 1e-8)
    assert torch.equal(p, torch.zeros(4))  # lr 0 from the buffer: no move
    adam_multi_tensor([g], [m], [v], [p], torch.tensor([0.1, 0.001, 1e-3]),
                      0.9, 0.999, 1e-8)
    assert torch.all(p < 0)
    with pytest.raises(NotImplementedError, match="fused_opt"):
        build_fusion_state(RunConfig(lr_schedule="cosine", fused_opt=True,
                                     **HORIZON), 2, "cpu")


# ----------------------------------------------------- six train steps

def _jax_model(cfg, dtype):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFusion(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla", dtype=jnp.dtype(dtype))


def _batch(cfg, rows: bool):
    batch = jax_synthetic(cfg, cfg.batch_size, seed=11)
    noise = np.random.default_rng(99).standard_normal(
        batch["frames"].shape).astype(np.float32)
    frames = np.clip(batch["frames"] + 0.1 * noise, 0.0, 1.0)
    if rows:
        return {"audio": batch["audio"],
                "pgram": np.asarray(jax_cumsum(jnp.asarray(frames)),
                                    np.float16)}
    return {"audio": batch["audio"], "frames": frames}


@pytest.fixture(scope="module")
def init_tree():
    """One flax init of each geometry, fp32 numpy trees."""
    out = {}
    for name, geo in (("float32", FP32), ("bfloat16", BF16)):
        cfg = JaxRunConfig(**geo)
        model = _jax_model(cfg, "float32")
        v = jax.jit(lambda key, m=model: m.init(
            key, jnp.zeros(m.stft_shape), jnp.zeros(m.pgram_shape),
            method=m.init_all))(jax.random.PRNGKey(0))
        out[name] = jax.tree_util.tree_map(np.asarray, v)
    return out


def _jax_run(geo, dtype, schedule, variables, batch):
    cfg = JaxRunConfig(**geo, **HORIZON).replace(lr_schedule=schedule,
                                                  dtype=dtype)
    env = JAX_BF16_ENV if dtype == "bfloat16" else {}
    params = variables["params"]
    if dtype == "bfloat16":
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(a, jnp.bfloat16)
            if jax.tree_util.keystr(p).endswith(("'w_i']", "'w_h']"))
            else jnp.asarray(a), params)
    state = jax_create_state(
        {"params": params, "batch_stats": variables["batch_stats"]},
        jax_make_optimizer(jax_resolve_lr(cfg), "adam", kernel="xla"))
    with _env(env):
        step = jax_make_step(_jax_model(cfg, dtype), cfg)
        jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
        losses = []
        for _ in range(STEPS):
            state, m = step(state, jbatch, jax.random.PRNGKey(0),
                            jnp.int32(2))
            losses.append([float(m[k]) for k in ("loss", "a_loss",
                                                 "v_loss")])
    params = flatten_tree(jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), state.params))
    return np.array(losses), params


def _port_run(geo, dtype, schedule, variables, batch):
    cfg = RunConfig(**geo, **HORIZON).replace(lr_schedule=schedule,
                                               dtype=dtype)
    model, state = build_fusion_state(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]))
    step = make_fusion_step(model, cfg, device="cpu")
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch, 2)
        losses.append([float(m[k]) for k in ("loss", "a_loss", "v_loss")])
    assert state.tx.count == STEPS and callable(state.tx.schedule)
    params, _ = to_flax(model.state_dict())
    return np.array(losses), flatten_tree(params), model


def _rates(geo, schedule):
    fn = jax_resolve_lr(JaxRunConfig(**geo, **HORIZON).replace(
        lr_schedule=schedule))
    return [float(fn(jnp.int32(n))) for n in range(STEPS)]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_fp32_steps_track_jax(init_tree, schedule):
    variables = init_tree["float32"]
    batch = _batch(JaxRunConfig(**FP32), rows=False)
    want, jparams = _jax_run(FP32, "float32", schedule, variables, batch)
    got, params, model = _port_run(FP32, "float32", schedule, variables,
                                   batch)
    np.testing.assert_allclose(got, want, rtol=FP32_LOSS_RTOL, atol=0)
    init = flatten_tree(variables["params"])
    fed = {k.replace(".", "/") for k in model.bn_fed_biases()}
    moved = sum(_rates(FP32, schedule))
    for path, w in jparams.items():
        if path in fed:
            for side in (params[path], w):
                np.testing.assert_allclose(side, init[path],
                                           atol=moved * 1.0001, rtol=0,
                                           err_msg=path)
            continue
        rel = (np.linalg.norm(params[path] - w)
               / max(np.linalg.norm(w), 1e-12))
        assert rel <= PARAM_RTOL, (path, rel)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_bf16_steps_track_jax(init_tree, schedule):
    variables = init_tree["bfloat16"]
    # the LSTM leaves as bf16 values, so both dtypes start from one tree
    flat = flatten_tree(variables["params"])
    for k in flat:
        if k.endswith(("w_i", "w_h")):
            flat[k] = torch.tensor(flat[k]).bfloat16().float().numpy()
    variables = {"params": unflatten_tree(flat),
                 "batch_stats": variables["batch_stats"]}
    batch = _batch(JaxRunConfig(**BF16), rows=True)
    want, jb = _jax_run(BF16, "bfloat16", schedule, variables, batch)
    _, jf = _jax_run(BF16, "float32", schedule, variables, batch)
    got, pb, model = _port_run(BF16, "bfloat16", schedule, variables, batch)
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL, atol=0)
    fed = {k.replace(".", "/") for k in model.bn_fed_biases()}
    keys = [k for k in jb if not k.endswith(("w_i", "w_h")) and k not in fed]
    cat = lambda t: np.concatenate([t[k].ravel() - flat[k].ravel()  # noqa
                                    for k in keys])
    assert _rel(cat(pb), cat(jb)) <= GRAD_RATIO * _rel(cat(jb), cat(jf))
