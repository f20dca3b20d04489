"""The JAX frames golden that ties the port's frames path on the card to the
reference: tests/fixtures/torch_port_frames_golden.npz.

It holds, at the small geometry of tests/test_torch_frames_step.py
(framesize 24, num_frames 2, num_seq 2, fft 64, latent 8, batch 4, lr 1e-3,
noise_scalar 0) with MAAVSS_S2D_MIN_HW=8, so that the encoder's stages 0 and
1 take the fused epilogue (on the JAX side MAAVSS_CONV3D=s2d and
MAAVSS_EPILOGUE=fused, the Pallas kernels):

- the weights as a seeded numpy recipe (`convert.random_flax_tree`: leaf
  paths, shapes, seed and per-leaf sums, as torch_port_golden.npz);
- the JAX frames separator's audio_out on those weights (eval mode) for the
  golden batch: `synthetic_av_batch(seed=7, frame_size=24)` with broadband
  frame noise (numpy seed 98, scale 0.1);
- 3 JAX `make_frames_step` losses in mode 2 from those weights, and per leaf
  of the final params and batch_stats the sum and the sum of absolute
  values.

chip_smoke.py's frames_golden phase runs the port's kernels on it (K5 in
training, K1 in both), on a machine without jax. Regenerate with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_frames_golden.py

Tolerances, here on the CPU: audio relative L2 1e-4; losses relative 1e-5;
leaf sums 1e-4 of the leaf's absolute sum (one Adam step moves an element
by up to lr).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch as jax_synthetic
from maavss_tpu.models.fusion_frames import AVFusionFramesModel as JaxFrames
from maavss_tpu.train.infer import make_frames_separator as jax_separator
from maavss_tpu.train.state import create_train_state, make_optimizer
from maavss_tpu.train.steps import make_frames_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    random_flax_tree,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.data.synthetic import synthetic_av_batch
from maavss_tpu_torch.train.infer import make_frames_separator
from maavss_tpu_torch.train.setup import build_frames_state
from maavss_tpu_torch.train.steps import make_frames_step
from tests.test_torch_workers import share_cores

share_cores()

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "torch_port_frames_golden.npz")
GEOMETRY = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
                framesize=24, learning_rate=1e-3, batch_size=4,
                noise_scalar=0.0)
LATENT, SEED, STEPS, MODE, MIN_HW = 8, 2025, 3, 2, 8
BATCH = dict(batch_seed=7, frames_noise_seed=98, frames_noise=0.1)
ENV = dict(MAAVSS_CONV3D="s2d", MAAVSS_EPILOGUE="fused",
           MAAVSS_S2D_MIN_HW=str(MIN_HW))


def _jax_model(cfg):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFrames(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2 + 1),
        frame_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.framesize,
                     cfg.framesize),
        hops_per_frame=cfg.hops_per_frame, latent_channels=LATENT)


def golden_batch(cfg, meta, synthetic=synthetic_av_batch):
    batch = synthetic(cfg, cfg.batch_size, seed=meta["batch_seed"],
                      frame_size=cfg.framesize)
    noise = np.random.default_rng(meta["frames_noise_seed"]).standard_normal(
        batch["frames"].shape).astype(np.float32)
    batch["frames"] = np.clip(batch["frames"] + meta["frames_noise"] * noise,
                              0.0, 1.0)
    return batch


def _sums(flat):
    return {k: [float(v.astype(np.float64).sum()),
                float(np.abs(v.astype(np.float64)).sum())]
            for k, v in flat.items()}


def _jax_run(meta):
    """(audio_out, losses, final flat tree) of the JAX reference; the
    environment must select the fused epilogue while it traces."""
    cfg = JaxRunConfig(**meta["cfg"])
    model = _jax_model(cfg)
    tree = unflatten_tree(random_flax_tree(
        {k: tuple(v) for k, v in meta["shapes"].items()}, meta["seed"]))
    state = create_train_state(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]},
        make_optimizer(cfg.learning_rate, "adam"))
    batch = jax.tree_util.tree_map(
        jnp.asarray, golden_batch(cfg, meta, jax_synthetic))
    audio_out = np.asarray(jax_separator(model, cfg)(
        state, batch, jax.random.PRNGKey(0))["audio_out"])
    step = jax_make_step(model, cfg)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0),
                        jnp.int32(meta["mode"]))
        losses.append(float(m["loss"]))
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    return audio_out, losses, flat


def make_golden(path: str = GOLDEN) -> None:
    for k, v in ENV.items():
        os.environ[k] = v
    cfg = JaxRunConfig(**GEOMETRY)
    model = _jax_model(cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros(model.stft_shape),
                           jnp.zeros(model.frame_shape),
                           method=model.init_all)
    shapes = {k: list(v.shape) for k, v in flatten_tree(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}).items()}
    flat = random_flax_tree(shapes, SEED)
    meta = {"cfg": GEOMETRY, "latent": LATENT, "s2d_min_hw": MIN_HW,
            "seed": SEED, "shapes": shapes,
            "checksums": {k: float(v.astype(np.float64).sum())
                          for k, v in flat.items()},
            "mode": MODE, **BATCH}
    audio_out, losses, final = _jax_run(meta)
    meta.update(losses=losses, sums=_sums(final))
    np.savez_compressed(path, meta=json.dumps(meta), audio_out=audio_out)


def _load():
    with np.load(GOLDEN) as z:
        return json.loads(str(z["meta"])), z["audio_out"]


@pytest.fixture
def fused_env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


def test_golden_recipe_regenerates():
    meta, audio_out = _load()
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    assert set(flat) == set(meta["checksums"]) == set(meta["sums"])
    for k, total in meta["checksums"].items():
        assert np.isclose(flat[k].astype(np.float64).sum(), total,
                          rtol=1e-6, atol=1e-6), k
    assert audio_out.ndim == 2 and np.all(np.isfinite(audio_out))
    assert os.path.getsize(GOLDEN) < 200_000


def test_golden_matches_jax(fused_env):
    """The fixture is still what the JAX reference computes (fp32, CPU)."""
    meta, audio_out = _load()
    got_audio, losses, final = _jax_run(meta)
    np.testing.assert_allclose(got_audio, audio_out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses, meta["losses"], rtol=1e-6)
    for path, (total, abs_total) in meta["sums"].items():
        assert abs(final[path].astype(np.float64).sum() - total) <= (
            1e-6 * abs_total + 1e-9), path


def test_port_matches_golden_on_cpu(fused_env):
    """The port's plain path on the fixture, with the tolerances of
    chip_smoke.py's frames_golden phase."""
    meta, audio_out = _load()
    tree = unflatten_tree(random_flax_tree(
        {k: tuple(v) for k, v in meta["shapes"].items()}, meta["seed"]))
    cfg = RunConfig(**meta["cfg"])
    model, state = build_frames_state(cfg, cfg.batch_size,
                                      latent_channels=meta["latent"],
                                      device="cpu")
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    batch = {k: torch.from_numpy(v) for k, v in golden_batch(cfg,
                                                             meta).items()}
    got = make_frames_separator(model, cfg)(batch)["audio_out"].numpy()
    assert got.shape == audio_out.shape
    assert (np.linalg.norm(got - audio_out)
            / np.linalg.norm(audio_out)) <= 1e-4
    step = make_frames_step(model, cfg, device="cpu")
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch, meta["mode"])
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, meta["losses"], rtol=1e-5)
    params, stats = to_flax(model.state_dict())
    got_flat = flatten_tree({"params": params, "batch_stats": stats})
    for path, (total, abs_total) in meta["sums"].items():
        assert abs(got_flat[path].astype(np.float64).sum() - total) <= (
            1e-4 * abs_total + 1e-7), path


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    make_golden()
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
