#!/usr/bin/env python
"""How far the JAX package's (2, 2)-mesh fusion step, and the port's
data x tensor parallel step, are from the JAX package's one-device step:
the gradient (an SGD step at lr 1, whose update is the gradient) and
BatchNorm's running statistics, module by module, on the CPU.

    python tools/mesh_grad_probe.py

JAX runs on 8 virtual CPU devices ((2, 2) and (1, 1) meshes, as
`__graft_entry__.dryrun_multichip` builds them); the port on 4 spawned
gloo ranks (tests/torch_parallel_ranks.py:jax_step_rank), both from one
flax init and one global batch (the small geometry of
tests/test_torch_parallel_jax.py, noise_scalar 0). One line a top-level
module: the relative L2 of its gradient against the one-device step's,
for the (2, 2) JAX step and for the port; then the same for each
BatchNorm's running statistics. The BN-fed conv biases (rounding noise
around a true 0) are left out.
"""

from __future__ import annotations

import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _jax_run(jax, model, cfg, variables, batch, shape):
    import jax.numpy as jnp

    from maavss_tpu.parallel.mesh import make_mesh, shard_batch, shard_state
    from maavss_tpu.train.state import create_train_state, make_optimizer
    from maavss_tpu.train.steps import make_fusion_step
    from maavss_tpu_torch.convert import from_flax

    mesh = make_mesh(data=shape[0], model=shape[1],
                     devices=jax.devices()[:shape[0] * shape[1]])
    state = create_train_state(variables, make_optimizer(1.0, "sgd"))
    state, sshard = shard_state(mesh, state)
    step = make_fusion_step(model, cfg, mesh=mesh, state_shardings=sshard)
    state, _ = step(state, shard_batch(mesh, batch), jax.random.PRNGKey(0),
                    jnp.int32(2))
    out = from_flax(jax.tree_util.tree_map(np.asarray, state.params),
                    jax.tree_util.tree_map(np.asarray, state.batch_stats))
    return {k: v.numpy() for k, v in out.items()}


def main() -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from maavss_tpu.config import RunConfig
    from maavss_tpu.data.synthetic import synthetic_av_batch
    from maavss_tpu.models.fusion import AVFusionModel
    from maavss_tpu_torch.convert import from_flax, save_npz
    from tests import torch_parallel_ranks as ranks

    geometry = dict(ranks.SMALL, batch_size=4, noise_scalar=0.0)
    cfg = RunConfig(**geometry)
    t_stft = cfg.hops_per_frame * cfg.num_frames
    model = AVFusionModel(
        stft_shape=(4, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(4, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla")
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros(model.stft_shape),
        jnp.zeros(model.pgram_shape), method=model.init_all))
    batch = synthetic_av_batch(cfg, 4, seed=11)
    noise = np.random.default_rng(99).standard_normal(
        batch["frames"].shape).astype(np.float32)
    batch["frames"] = np.clip(batch["frames"] + 0.1 * noise, 0.0, 1.0)
    with tempfile.TemporaryDirectory() as tmp:
        npz, bpath = os.path.join(tmp, "w.npz"), os.path.join(tmp, "b.npz")
        save_npz(npz, variables["params"], variables["batch_stats"])
        np.savez(bpath, **batch)
        handle = ranks.start(ranks.jax_step_rank, 4, npz, bpath,
                             dict(geometry, pgenc_kernel="pallas"))
        runs = {shape: _jax_run(jax, model, cfg, variables, batch, shape)
                for shape in ((1, 1), (2, 2))}
        port = ranks.finish(handle)
    init = {k: v.numpy() for k, v in from_flax(variables["params"]).items()}
    one, two = runs[(1, 1)], runs[(2, 2)]
    fed = set(port["bn_fed"])

    def rel(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)

    print(f"{'module':20s} {'jax (2,2)':>10s} {'port dpxtp':>11s}  "
          "gradient vs the one-device step, relative L2")
    for mod in sorted({k.split(".", 1)[0] for k in init}):
        keys = [k for k in sorted(init)
                if k.split(".", 1)[0] == mod and k not in fed]
        g1 = np.concatenate([(init[k] - one[k]).ravel() for k in keys])
        if not np.any(g1):
            continue
        g2 = np.concatenate([(init[k] - two[k]).ravel() for k in keys])
        gp = np.concatenate([port["grads"][k].numpy().ravel() for k in keys])
        print(f"{mod:20s} {rel(g2, g1):10.3e} {rel(gp, g1):11.3e}")
    print("BatchNorm running statistics vs the one-device step, relative L2")
    for k in sorted(set(one) - set(init)):
        if k.split(".", 1)[0].endswith("decoder"):
            continue
        print(f"{k:55s} {rel(two[k], one[k]):10.3e} "
              f"{rel(port['state'][k].numpy(), one[k]):11.3e}")


if __name__ == "__main__":
    main()
