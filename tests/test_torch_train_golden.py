"""The JAX training golden that ties the port's train step on the card to
the reference: tests/fixtures/torch_port_train_golden.npz.

It holds the trajectory of the JAX `make_fusion_step` at the small geometry
of tests/test_parity_training.py:54-56 (batch 4, lr 1e-3, noise_scalar 0):
3 steps, scan windows, mode 2. The weights are a seeded numpy recipe
(`convert.random_flax_tree`: leaf paths, shapes, seed and per-leaf sums, as
torch_port_golden.npz); the batch is `synthetic_av_batch(seed=11)` with
broadband frame noise (numpy seed 99, scale 0.1; see
tests/test_torch_train_step.py). It stores the per-step losses and, per
leaf of the final params and batch_stats, the sum and the sum of absolute
values. The conv biases that feed a train-mode BatchNorm (true gradient 0,
autodiff noise turned into +-lr updates; see test_torch_train_step.py) and
the running means of those BatchNorms, which follow them, are left out and
listed under `bn_fed`. chip_smoke.py's train_golden phase runs the port's
kernels on it, on a machine without jax. Regenerate with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_train_golden.py

Tolerances: losses relative 1e-5 on the CPU (mode 2 tracks to ~1e-6 over 4
steps, test_torch_train_step.py); leaf sums 1e-4 of the leaf's absolute sum
(one Adam step moves an element by up to lr; the sums are over up to 0.3 M
elements).
"""

import json
import os

import numpy as np

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch as jax_synthetic
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.train.state import create_train_state, make_optimizer
from maavss_tpu.train.steps import make_fusion_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    random_flax_tree,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.data.synthetic import synthetic_av_batch
from maavss_tpu_torch.train.setup import build_fusion_state
from maavss_tpu_torch.train.steps import make_fusion_step
from tests.test_torch_workers import share_cores

share_cores()

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "torch_port_train_golden.npz")
GEOMETRY = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
                batch_size=4, noise_scalar=0.0)
SEED, STEPS, MODE = 2024, 3, 2
BATCH = dict(batch_seed=11, frames_noise_seed=99, frames_noise=0.1)


def _jax_model(cfg):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFusion(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla")


def golden_batch(cfg, meta, synthetic=synthetic_av_batch):
    batch = synthetic(cfg, cfg.batch_size, seed=meta["batch_seed"])
    noise = np.random.default_rng(meta["frames_noise_seed"]).standard_normal(
        batch["frames"].shape).astype(np.float32)
    batch["frames"] = np.clip(batch["frames"] + meta["frames_noise"] * noise,
                              0.0, 1.0)
    return batch


def _bn_fed_paths(cfg):
    """Flattened flax paths of the conv biases that feed a BatchNorm and of
    those BatchNorms' running means."""
    model, _ = build_fusion_state(RunConfig(**GEOMETRY), cfg.batch_size,
                                  "cpu")
    paths = []
    for stack, mod in model.named_children():
        for conv, bn in getattr(mod, "names", ()):
            if bn is not None:
                paths += [f"params/{stack}/{conv}/bias",
                          f"batch_stats/{stack}/{bn}/BatchNorm_0/mean"]
    return sorted(paths)


def _sums(flat, left_out):
    return {k: [float(v.astype(np.float64).sum()),
                float(np.abs(v.astype(np.float64)).sum())]
            for k, v in flat.items() if k not in left_out}


def _jax_run(meta):
    cfg = JaxRunConfig(**meta["cfg"])
    model = _jax_model(cfg)
    tree = unflatten_tree(random_flax_tree(
        {k: tuple(v) for k, v in meta["shapes"].items()}, meta["seed"]))
    state = create_train_state(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]},
        make_optimizer(cfg.learning_rate, "adam"))
    step = jax_make_step(model, cfg, window_mode="scan")
    batch = jax.tree_util.tree_map(
        jnp.asarray, golden_batch(cfg, meta, jax_synthetic))
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0),
                        jnp.int32(meta["mode"]))
        losses.append(float(m["loss"]))
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    return losses, flat


def make_golden(path: str = GOLDEN) -> None:
    cfg = JaxRunConfig(**GEOMETRY)
    model = _jax_model(cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros(model.stft_shape),
                           jnp.zeros(model.pgram_shape), method=model.init_all)
    shapes = {k: list(v.shape) for k, v in flatten_tree(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}).items()}
    flat = random_flax_tree(shapes, SEED)
    meta = {"cfg": GEOMETRY, "seed": SEED, "shapes": shapes,
            "checksums": {k: float(v.astype(np.float64).sum())
                          for k, v in flat.items()},
            "mode": MODE, "window_mode": "scan", **BATCH,
            "bn_fed": _bn_fed_paths(cfg)}
    losses, final = _jax_run(meta)
    meta.update(losses=losses, sums=_sums(final, set(meta["bn_fed"])))
    np.savez_compressed(path, meta=json.dumps(meta))


def _load():
    with np.load(GOLDEN) as z:
        return json.loads(str(z["meta"]))


def test_golden_recipe_regenerates():
    meta = _load()
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    assert set(flat) == set(meta["checksums"])
    for k, total in meta["checksums"].items():
        assert np.isclose(flat[k].astype(np.float64).sum(), total,
                          rtol=1e-6, atol=1e-6), k
    assert set(meta["bn_fed"]) == set(_bn_fed_paths(
        JaxRunConfig(**meta["cfg"])))
    assert set(meta["sums"]) == set(flat) - set(meta["bn_fed"])
    assert os.path.getsize(GOLDEN) < 200_000


def test_golden_matches_jax_train_step():
    """The fixture is still what the JAX reference computes (fp32, CPU)."""
    meta = _load()
    losses, final = _jax_run(meta)
    np.testing.assert_allclose(losses, meta["losses"], rtol=1e-6)
    for path, (total, abs_total) in meta["sums"].items():
        assert abs(final[path].astype(np.float64).sum() - total) <= (
            1e-6 * abs_total + 1e-9), path


def test_port_matches_golden_on_cpu():
    """The port's plain path on the fixture, with the fused-layer stack
    (the path the card runs) and the same tolerances as chip_smoke.py's
    train_golden phase."""
    meta = _load()
    tree = unflatten_tree(random_flax_tree(
        {k: tuple(v) for k, v in meta["shapes"].items()}, meta["seed"]))
    cfg = RunConfig(**meta["cfg"]).replace(pgenc_kernel="pallas")
    model, state = build_fusion_state(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    step = make_fusion_step(model, cfg, device="cpu")
    batch = golden_batch(cfg, meta)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch, meta["mode"])
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, meta["losses"], rtol=1e-5)
    params, stats = to_flax(model.state_dict())
    got = flatten_tree({"params": params, "batch_stats": stats})
    for path, (total, abs_total) in meta["sums"].items():
        assert abs(got[path].astype(np.float64).sum() - total) <= (
            1e-4 * abs_total + 1e-7), path


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    make_golden()
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
