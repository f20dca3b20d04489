"""The port's optimizers (maavss_tpu_torch/train/fused_adam.py,
train/state.py:make_optimizer) against optax on the same numpy inputs, and
the staged freeze's checkpoints.

- sgd, adamw and Adam, each with and without the staged trainable mask
  (optax.multi_transform with set_to_zero, as
  maavss_tpu/train/state.py:make_optimizer builds it), and sgd and adamw
  under a schedule: 5 steps on fixed gradients, parameters and moments
  within 1e-6 relative (+1e-9 absolute).
- A frozen leaf stays bit for bit where it was and keeps no moments.
- `trainable_labels` marks the fusion model's leaves as JAX's does.
- A staged run's checkpoint keeps the trainable leaves' moments alone and
  resumes; a staged JAX checkpoint (pickle backend, multi_transform state)
  loads into a staged port state with the same moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maavss_tpu.train.state import make_optimizer as jax_make_optimizer
from maavss_tpu.train.state import trainable_labels as jax_labels
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import flatten_tree, to_flax, unflatten_tree
from maavss_tpu_torch.exp import checkpoint as ckpt
from maavss_tpu_torch.train.fused_adam import SGD, FusedAdam
from maavss_tpu_torch.train.setup import FUSION_SUBNETS, build_fusion_state
from maavss_tpu_torch.train.state import (
    cosine_decay_schedule,
    make_optimizer,
    trainable_labels,
)
from tests.test_torch_workers import share_cores

share_cores()

LR, STEPS, RTOL, ATOL = 1e-2, 5, 1e-6, 1e-9
# leaf name (the port's) -> shape; "lstm" and "fc1" are the trainable
# prefixes of the masked cases
SHAPES = {"lstm.fwd.w_h": (8, 32), "fc1.weight": (6, 10), "fc1.bias": (6,),
          "stft_encoder.Conv_0.weight": (4, 2, 5, 5),
          "phasegram_encoder.Conv_0.bias": (3,)}
TRAIN = ("lstm", "fc1")


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _optax_run(name, masked, schedule):
    """optax's parameters and moments after STEPS steps (a flax-like tree:
    the port's names split on '.')."""
    params = unflatten_tree({k.replace(".", "/"): jnp.asarray(v)
                             for k, v in _tree(0).items()})
    lr = (optax.cosine_decay_schedule(LR, 4, alpha=0.1) if schedule
          else LR)
    tx = jax_make_optimizer(lr, name, trainable=TRAIN if masked else None,
                            params=params)
    state = tx.init(params)
    for i in range(STEPS):
        grads = unflatten_tree({k.replace(".", "/"): jnp.asarray(v * 1e-2)
                                for k, v in _tree(10 + i).items()})
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return flatten_tree(jax.tree_util.tree_map(np.asarray, params)), state


def _port_run(name, masked, schedule):
    tensors = {k: torch.from_numpy(v.copy()) for k, v in _tree(0).items()}
    lr = cosine_decay_schedule(LR, 4, alpha=0.1) if schedule else LR
    opt = make_optimizer(list(tensors.items()), lr, name,
                         trainable=TRAIN if masked else None)
    for i in range(STEPS):
        for k, t in tensors.items():
            t.grad = torch.from_numpy(_tree(10 + i)[k] * np.float32(1e-2))
        opt.step()
    return tensors, opt


def _adam_moments(state):
    """(mu, nu) flattened, MaskedNode leaves dropped, of the one
    ScaleByAdamState in an optax state."""
    found = []

    def walk(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, tuple):
            for v in node:
                walk(v)

    walk(state)
    assert len(found) == 1

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out.update(flat(v, path))
            elif not isinstance(v, optax.MaskedNode):
                out[path] = np.asarray(v)
        return out

    return flat(found[0].mu), flat(found[0].nu)


@pytest.mark.parametrize("name, masked, schedule", [
    ("adam", True, False), ("sgd", False, False), ("sgd", True, False),
    ("adamw", False, False), ("adamw", True, False), ("sgd", False, True),
    ("adamw", True, True),
])
def test_optimizer_tracks_optax(name, masked, schedule):
    want, state = _optax_run(name, masked, schedule)
    got, opt = _port_run(name, masked, schedule)
    assert opt.count == STEPS
    start = _tree(0)
    for k, t in got.items():
        frozen = masked and not k.startswith(TRAIN)
        if frozen:
            np.testing.assert_array_equal(t.numpy(), start[k], err_msg=k)
        np.testing.assert_allclose(t.numpy(), want[k.replace(".", "/")],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    if name == "sgd":
        assert all(m is None for m in opt.m + opt.v)
        assert isinstance(opt, SGD)
        return
    mu, nu = _adam_moments(state)
    names = list(got)
    for col, want_col in ((opt.m, mu), (opt.v, nu)):
        kept = {n: t for n, t in zip(names, col) if t is not None}
        assert set(kept) == {n for n in names
                             if not masked or n.startswith(TRAIN)}
        assert {k.replace(".", "/") for k in kept} == set(want_col)
        for n, t in kept.items():
            np.testing.assert_allclose(t.numpy(), want_col[n.replace(
                ".", "/")], rtol=RTOL, atol=ATOL, err_msg=n)


def test_frozen_leaf_keeps_its_bits_and_no_moments():
    tensors, opt = _port_run("adam", True, False)
    assert isinstance(opt, FusedAdam)
    for (k, t), m, v, train in zip(tensors.items(), opt.m, opt.v,
                                   opt.trainable):
        assert train == k.startswith(TRAIN)
        if not train:
            assert m is None and v is None
            assert np.array_equal(t.numpy(), _tree(0)[k])
    with pytest.raises(ValueError, match="freezes every"):
        make_optimizer([("x.w", torch.zeros(2))], LR, trainable=["fc"])


def test_trainable_labels_match_jax():
    cfg = RunConfig(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                    p_size=16, latent_chan=8, fc_size=256)
    model, state = build_fusion_state(cfg, 2, "cpu",
                                      torch.Generator().manual_seed(0),
                                      trainable=FUSION_SUBNETS)
    params, _ = to_flax(model.state_dict())
    want = flatten_tree(jax_labels(params, FUSION_SUBNETS))
    got = trainable_labels([n for n, _ in model.named_parameters()],
                           FUSION_SUBNETS)
    names = [n for n, _ in model.named_parameters()]
    assert len(want) == len(names)
    for n, g in zip(names, got):
        assert (want[n.replace(".", "/").replace("/weight", "/kernel")
                     .replace("BatchNorm_0/kernel", "BatchNorm_0/scale")]
                == "train") == g, n
    assert state.tx.trainable == got
    assert sum(got) and not all(got)


def _staged_state(cfg):
    return build_fusion_state(cfg, 2, "cpu", torch.Generator().manual_seed(0),
                              trainable=FUSION_SUBNETS)[1]


def test_staged_checkpoint_keeps_trainable_moments_and_resumes(tmp_path):
    cfg = RunConfig(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                    p_size=16, latent_chan=8, fc_size=256)
    state = _staged_state(cfg)
    names = [n for n, _ in state.model.named_parameters()]
    for p, m in zip(state.model.parameters(), state.tx.m):
        p.grad = torch.full_like(p, 0.5)
    state.apply_gradients()
    path = ckpt.save_checkpoint(str(tmp_path), "staged", state, epoch=1)
    saved = torch.load(path, weights_only=True)
    trained = {n for n, t in zip(names, state.tx.trainable) if t}
    assert set(saved["opt"]["m"]) == set(saved["opt"]["v"]) == trained
    other = _staged_state(cfg)
    other, epoch = ckpt.load_checkpoint(str(tmp_path), other, auto=False,
                                        path=path, load_opt=True)
    assert epoch == 1 and other.tx.count == 1
    for a, b in zip(state.tx.m + state.tx.v, other.tx.m + other.tx.v):
        assert (a is None and b is None) or torch.equal(a, b)
    for (n, a), b in zip(state.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), n


def test_staged_jax_checkpoint_loads(tmp_path, monkeypatch):
    """A JAX checkpoint of a staged state (optax.multi_transform: the
    frozen leaves' moments are MaskedNodes) restores into the port's
    staged state: the trainable leaves' moments and the count."""
    from maavss_tpu.config import RunConfig as JaxRunConfig
    from maavss_tpu.exp.checkpoint import save_checkpoint as jax_save
    from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
    from maavss_tpu.train.state import create_train_state as jax_state

    monkeypatch.setenv("MAAVSS_CKPT_BACKEND", "pkl")
    geometry = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                    p_size=16, latent_chan=8, fc_size=256)
    cfg_j = JaxRunConfig(**geometry)
    t_stft = cfg_j.hops_per_frame * cfg_j.num_frames
    model_j = JaxFusion(stft_shape=(2, 2, t_stft, 32),
                        pgram_shape=(2, 1, 4, 256), latent_channels=8,
                        fc_size=256, pgenc_kernel="xla")
    variables = model_j.init(jax.random.PRNGKey(0),
                             jnp.zeros(model_j.stft_shape),
                             jnp.zeros(model_j.pgram_shape),
                             method=model_j.init_all)
    tx = jax_make_optimizer(1e-3, "adam", trainable=FUSION_SUBNETS,
                            params=variables["params"])
    state_j = jax_state(variables, tx)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.25),
                                   state_j.params)
    state_j = state_j.apply_gradients(grads=grads)
    jax_save(str(tmp_path), "staged-jax", state_j, epoch=2)
    mu, _ = _adam_moments(state_j.opt_state)

    state = _staged_state(RunConfig(**geometry))
    state, epoch = ckpt.load_checkpoint(str(tmp_path), state, auto=True,
                                        load_opt=True)
    assert epoch == 2 and state.tx.count == 1 and state.step == 1
    names = [n for n, _ in state.model.named_parameters()]
    kept = {n: t for n, t in zip(names, state.tx.m) if t is not None}
    assert len(kept) == len(mu) > 0
    got = flatten_tree(to_flax(kept)[0])
    for path, want in mu.items():
        np.testing.assert_array_equal(got[path], want, err_msg=path)
