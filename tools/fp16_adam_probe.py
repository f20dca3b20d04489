#!/usr/bin/env python
"""What the JAX package's Adam does to its fp16 leaves under --dtype
float16, on the CPU: the reference-side fault that the port reproduces
(ROADMAP queue 3).

    python tools/fp16_adam_probe.py

The LSTM's w_i and w_h are parameters of the compute dtype
(maavss_tpu/models/layers.py:693-697), so under float16 they, and Adam's
moments of them, are fp16. eps = 1e-8 rounds to 0 in fp16 and
(1 - b2) g^2 underflows to 0, so m_hat / (sqrt(v_hat) + eps) divides by 0.

Its runs, at tests/test_torch_fp16.py's geometries and inputs:
- the fusion step (full encode on float16 rows, batch 4, lr 1e-4), two
  steps, with optax.adam and with --opt_kernel pallas's Adam: the losses,
  the gradient norm, and after each step the leaves with non-finite
  elements and their counts;
- the STFT and phasegram autoencoder regimes (tests/test_torch_regimes.py's
  geometry, lr 1e-3), three steps each, fp16 and fp32: the losses, and the
  non-finite leaves after the last step (the LSTM is unused there: g = 0,
  so 0/0).
"""

from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _nonfinite(tree):
    """({flat path: non-finite elements}, total) of a params tree."""
    from maavss_tpu_torch.convert import flatten_tree

    bad = {}
    for k, a in flatten_tree(tree).items():
        n = int(np.size(a) - np.isfinite(np.asarray(a, np.float32)).sum())
        if n:
            bad[k] = n
    return bad, sum(bad.values())


def _state(tree, dtype, lr, kernel):
    from maavss_tpu.train.state import create_train_state, make_optimizer
    from tests.test_torch_fp16 import _lstm_f16

    v = _lstm_f16(tree, dtype)
    return create_train_state(
        {"params": v["params"], "batch_stats": v["batch_stats"]},
        make_optimizer(lr, "adam", kernel=kernel))


def fusion_runs():
    import jax
    import jax.numpy as jnp

    from maavss_tpu.config import RunConfig
    from maavss_tpu.train.steps import make_fusion_step
    from tests.test_torch_bf16 import FUSION, JAX_ENV, _env
    from tests.test_torch_fp16 import _jax_fusion, _rows_batch, fusion_weights

    cfg = RunConfig(**FUSION)
    batch = {k: jnp.asarray(a) for k, a in _rows_batch().items()}
    for kernel in ("xla", "pallas"):
        for dtype in ("float16", "float32"):
            with _env(JAX_ENV):
                step = make_fusion_step(_jax_fusion(cfg, dtype), cfg)
                state = _state(fusion_weights(), dtype, cfg.learning_rate,
                               kernel)
                for i in range(2):
                    state, m = step(state, batch, jax.random.PRNGKey(0),
                                    jnp.int32(2))
                    bad, total = _nonfinite(jax.tree_util.tree_map(
                        np.asarray, state.params))
                    adam = "optax" if kernel == "xla" else "pallas"
                    print(f"fusion adam={adam} {dtype} step {i + 1}: "
                          f"loss {float(m['loss']):.6g}"
                          f" grad_norm {float(m['grad_norm']):.4g};"
                          f" {len(bad)} leaves, {total} elements non-finite"
                          + (f": {bad}" if 0 < len(bad) <= 8 else ""))


def autoencoder_runs():
    import jax
    import jax.numpy as jnp

    from maavss_tpu.config import RunConfig
    from maavss_tpu.models.fusion import AVFusionModel
    from maavss_tpu.train import steps
    from tests.test_torch_bf16 import JAX_ENV, _env
    from tests.test_torch_fp16 import AE_GEOMETRY, AE_STEPS, _shapes, weights
    from tests.test_torch_regimes import _batch

    cfg = RunConfig(**AE_GEOMETRY)
    batches = [_batch(cfg, 11 + i) for i in range(AE_STEPS)]
    t_stft = cfg.hops_per_frame * cfg.num_frames
    for kind, make in (("audio AE", steps.make_audio_ae_step),
                       ("visual AE", steps.make_visual_ae_step)):
        for dtype in ("float16", "float32"):
            model = AVFusionModel(
                stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
                pgram_shape=(cfg.batch_size, 1, cfg.num_frames,
                             cfg.p_size ** 2),
                latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
                pgenc_kernel="xla", dtype=jnp.dtype(dtype))
            shapes = jax.eval_shape(lambda: model.init(
                jax.random.PRNGKey(0), jnp.zeros(model.stft_shape),
                jnp.zeros(model.pgram_shape), method=model.init_all))
            tree = weights(_shapes({"params": shapes["params"],
                                    "batch_stats": shapes["batch_stats"]}),
                           seed=3)
            with _env(JAX_ENV):
                step = make(model, cfg)
                state = _state(tree, dtype, cfg.learning_rate, "xla")
                losses = []
                for b in batches:
                    state, m = step(state, jax.tree_util.tree_map(
                        jnp.asarray, b), jax.random.PRNGKey(0), jnp.int32(2))
                    losses.append(round(float(m["loss"]), 6))
            bad, total = _nonfinite(jax.tree_util.tree_map(np.asarray,
                                                           state.params))
            print(f"{kind} {dtype}: losses {losses}; after step {AE_STEPS}"
                  f" {len(bad)} leaves, {total} elements non-finite"
                  + (f": {bad}" if bad else ""))


def main() -> None:
    fusion_runs()
    autoencoder_runs()


if __name__ == "__main__":
    main()
