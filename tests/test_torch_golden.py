"""The JAX golden fixture that ties the PyTorch port's GPU run to the
reference: tests/fixtures/torch_port_golden.npz.

It holds a small-geometry fusion model's weights as a seeded numpy recipe
(`convert.random_flax_tree`: leaf paths, shapes, seed and per-leaf sums; the
values themselves would be several MB), serving inputs, and the JAX serving
function's `audio_out` on them. `chip_smoke.py` runs the port's CUDA kernels
on it, on a machine without jax. Regenerate with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_golden.py
"""

import json
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.exp.export import make_serving_fn as jax_serving_fn
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    random_flax_tree,
    unflatten_tree,
)
from maavss_tpu_torch.exp.export import make_serving_fn, random_serving_inputs
from maavss_tpu_torch.train.setup import build_fusion
from tests.test_torch_workers import share_cores

share_cores()

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "torch_port_golden.npz")
GEOMETRY = dict(num_frames=4, num_seq=4, fft_len=64, p_size=16,
                latent_chan=8, fc_size=256, batch_size=2)
SEED = 1234


def _jax_model(cfg):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFusion(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla")


def _load():
    with np.load(GOLDEN) as z:
        meta = json.loads(str(z["meta"]))
        return meta, z["audio"], z["visual"], z["audio_out"]


def _weights(meta):
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    tree = unflatten_tree(flat)
    return flat, tree["params"], tree["batch_stats"]


def make_golden(path: str = GOLDEN) -> None:
    cfg = JaxRunConfig(**GEOMETRY)
    model = _jax_model(cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros(model.stft_shape),
                           jnp.zeros(model.pgram_shape), method=model.init_all)
    shapes = {k: list(v.shape) for k, v in flatten_tree(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}).items()}
    flat = random_flax_tree(shapes, SEED)
    tree = unflatten_tree(flat)
    audio, _ = random_serving_inputs(RunConfig(**GEOMETRY), cfg.batch_size)
    t_total = cfg.num_frames + cfg.num_seq
    visual = np.random.default_rng(1).uniform(
        0, 1, (cfg.batch_size, t_total, cfg.p_size, cfg.p_size)).astype(
            np.float32)
    out = np.asarray(jax_serving_fn(model, cfg)(
        tree["params"], tree["batch_stats"], audio, visual))
    meta = {"cfg": GEOMETRY, "seed": SEED, "shapes": shapes,
            "checksums": {k: float(v.astype(np.float64).sum())
                          for k, v in flat.items()}}
    np.savez_compressed(path, meta=json.dumps(meta), audio=audio,
                        visual=visual, audio_out=out)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_golden_weights_regenerate_from_recipe():
    meta, *_ = _load()
    flat, _, _ = _weights(meta)
    assert set(flat) == set(meta["checksums"])
    for k, total in meta["checksums"].items():
        assert np.isclose(flat[k].astype(np.float64).sum(), total,
                          rtol=1e-6, atol=1e-6), k


def test_golden_matches_jax_serving_fn():
    """The fixture is still what the JAX reference computes (fp32, CPU)."""
    meta, audio, visual, want = _load()
    _, params, batch_stats = _weights(meta)
    cfg = JaxRunConfig(**meta["cfg"])
    got = np.asarray(jax_serving_fn(_jax_model(cfg), cfg)(
        params, batch_stats, audio, visual))
    assert _rel_l2(got, want) < 1e-5


def test_port_matches_golden_on_cpu():
    """The port's plain path on the fixture: relative L2 < 1e-4, the same
    bound chip_smoke.py holds the CUDA kernels to."""
    meta, audio, visual, want = _load()
    _, params, batch_stats = _weights(meta)
    cfg = RunConfig(**meta["cfg"])
    model = build_fusion(cfg, audio.shape[0], "cpu")
    model.load_state_dict(from_flax(params, batch_stats))
    got = make_serving_fn(model, cfg)(torch.from_numpy(audio),
                                      torch.from_numpy(visual)).numpy()
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert _rel_l2(got, want) < 1e-4


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    make_golden()
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
