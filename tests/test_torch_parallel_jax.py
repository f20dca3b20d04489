"""The port's data x tensor parallel fusion step against the JAX package's
sharded step, and the sharded checkpoint.

(b) Four gloo ranks run the port's fusion SGD step on a (2, 2) mesh
(parallel/: global-batch BatchNorm, the phasegram encoder's K2 split route
in its plain version, column-parallel heads and LSTM projection, the
gradient all-reduce) from converted flax weights, and the JAX package runs
its step on a (2, 2) mesh of the virtual CPU devices, on the same global
batch (noise_scalar 0, broadband frames as in test_torch_train_step.py):
loss within 1e-4 relative, parameters within rtol 5e-4, atol 1e-6 (the
JAX dryrun's standard). The gradient the ranks averaged is held to the
JAX package's one-device gradient (its SGD update at lr 1) within 1e-3 in
relative L2, every leaf but the BN-fed conv biases (rounding noise around
a true 0), and BatchNorm's running statistics to its one-device step's
within 1e-4: an SGD step at lr 1e-3 moves a parameter by less than the
parameter gate sees. Neither is held to the (2, 2)-mesh step's: that
step's STFT encoder takes BatchNorm statistics that are not the global
batch's, and its gradient there is half the one-device step's
(tools/mesh_grad_probe.py).

(f) A checkpoint saved from a (2, 2) Adam run (rank 0 writes the whole
state) loads in one process, equal leaf for leaf to the ranks' gathered
state, and a resume re-shards it bit for bit on every rank
(tests/torch_parallel_ranks.py:checkpoint_rank)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch
from maavss_tpu.parallel.mesh import make_mesh, shard_batch, shard_state
from maavss_tpu.train.state import create_train_state as jax_create_state
from maavss_tpu.train.state import make_optimizer as jax_make_optimizer
from maavss_tpu.train.steps import make_fusion_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import from_flax, save_npz
from maavss_tpu_torch.exp.checkpoint import load_checkpoint
from maavss_tpu_torch.train.setup import build_fusion_state
from tests import torch_parallel_ranks as ranks
from tests.test_torch_train_step import _jax_model
from tests.test_torch_workers import share_cores

share_cores()

GEOMETRY = dict(ranks.SMALL, batch_size=4, noise_scalar=0.0)
LR = GEOMETRY["learning_rate"]


def _batch(cfg):
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=11)
    noise = np.random.default_rng(99).standard_normal(
        batch["frames"].shape).astype(np.float32)
    batch["frames"] = np.clip(batch["frames"] + 0.1 * noise, 0.0, 1.0)
    return batch


def test_dpxtp_step_matches_the_jax_sharded_step(tmp_path):
    cfg = JaxRunConfig(**GEOMETRY)
    model = _jax_model(cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros(model.stft_shape),
                           jnp.zeros(model.pgram_shape), method=model.init_all)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    batch = _batch(cfg)
    npz, batch_path = str(tmp_path / "w.npz"), str(tmp_path / "batch.npz")
    save_npz(npz, variables["params"], variables["batch_stats"])
    np.savez(batch_path, **batch)
    handle = ranks.start(ranks.jax_step_rank, 4, npz, batch_path,
                         dict(GEOMETRY, pgenc_kernel="pallas"))
    # meanwhile the JAX package's step on a (2, 2) mesh, as its dryrun runs
    # it (maavss_tpu/__graft_entry__.py:dryrun_multichip)
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    state = jax_create_state(variables, jax_make_optimizer(LR, "sgd"))
    state, sshard = shard_state(mesh, state)
    step = jax_make_step(model, cfg, mesh=mesh, state_shardings=sshard)
    state, metrics = step(state, shard_batch(mesh, batch),
                          jax.random.PRNGKey(0), jnp.int32(2))
    want_loss = float(metrics["loss"])
    want = from_flax(jax.tree_util.tree_map(np.asarray, state.params),
                     jax.tree_util.tree_map(np.asarray, state.batch_stats))
    init = {k: v.numpy() for k, v in from_flax(variables["params"]).items()}
    got = ranks.finish(handle)

    rel = abs(got["loss"] - want_loss) / abs(want_loss)
    assert rel < 1e-4, (got["loss"], want_loss)
    names = sorted(init)
    for name in names:
        np.testing.assert_allclose(got["state"][name].numpy(),
                                   want[name].numpy(), rtol=5e-4, atol=1e-6,
                                   err_msg=name)
    # the averaged gradient and BatchNorm's running statistics against the
    # one-device JAX step's, at lr 1
    one = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    state1 = jax_create_state(variables, jax_make_optimizer(1.0, "sgd"))
    state1, sshard1 = shard_state(one, state1)
    step1 = jax_make_step(model, cfg, mesh=one, state_shardings=sshard1)
    state1, _ = step1(state1, shard_batch(one, batch), jax.random.PRNGKey(0),
                      jnp.int32(2))
    after1 = from_flax(jax.tree_util.tree_map(np.asarray, state1.params),
                       jax.tree_util.tree_map(np.asarray, state1.batch_stats))
    for name in set(after1) - set(init):  # BatchNorm's running statistics
        w = after1[name].numpy()
        g = got["state"][name].numpy()
        assert np.linalg.norm(g - w) <= 1e-4 * max(np.linalg.norm(w),
                                                   1e-12), name
    keep = [k for k in names if k not in set(got["bn_fed"])]
    g_jax = np.concatenate([(init[k] - after1[k].numpy()).reshape(-1)
                            for k in keep]).astype(np.float64)
    g_port = np.concatenate([got["grads"][k].numpy().reshape(-1)
                             for k in keep]).astype(np.float64)
    grel = np.linalg.norm(g_port - g_jax) / np.linalg.norm(g_jax)
    assert grel < 1e-3, grel


def test_dpxtp_checkpoint_loads_in_one_process(tmp_path):
    cp_dir = str(tmp_path / "cp")
    got = ranks.spawn(ranks.checkpoint_rank, 4, cp_dir)
    files = os.listdir(cp_dir)
    assert files == ["run.ckpt.pt"], files
    cfg = RunConfig(**ranks.SMALL, batch_size=4)
    model, state = build_fusion_state(cfg, 4, "cpu",
                                      torch.Generator().manual_seed(1))
    load_checkpoint(cp_dir, state, auto=True, load_opt=True)
    names = [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), got["params"][name]), name
    for name, b in model.named_buffers():
        assert torch.equal(b, got["buffers"][name]), name
    for col, key in ((state.tx.m, "m"), (state.tx.v, "v")):
        for name, t in zip(names, col):
            assert torch.equal(t, got[key][name]), (key, name)
    assert state.tx.count == got["count"] == 1 and state.step == got["step"]
