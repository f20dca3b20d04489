#!/usr/bin/env python
"""Sharded train steps and the separator on gloo ranks, each held to the
one-process run of the port: the counterpart of
`__graft_entry__.dryrun_multichip` (its eight blocks, to its standard).

    python tools/dryrun_multichip_torch.py [--world 4] [--device cpu]
        [--blocks NAME ...]

spawns `--world` ranks (one process each, `torch.distributed` over gloo,
one thread each); every rank runs every block on its rows of the global
batch under the block's (data, model) mesh, through the entry points a
run calls (`build_fusion_state`, `apply_mesh_model`, `shard_batch`,
`make_fusion_step` / `make_frames_step`, `make_separator`); rank 0
gathers the whole state. Meanwhile this process runs each block in one
process on the whole batch. Every block is held to that run with SGD:

- the loss within 1e-4 relative, every parameter within rtol 5e-4, atol
  1e-6;
- and, beyond the JAX dryrun's standard, the step's gradient (the last
  step's, averaged over the data group, each leaf joined whole) leaf for
  leaf within 1e-3 of the one-process gradient in relative L2 (`grad_gate`):
  one SGD step at lr 1e-3 moves a parameter by less than rtol 5e-4 of
  itself (an update near the parameter's last place, whose rounding a
  comparison of updates would read), so the parameter gate alone passes a
  missing gradient all-reduce. A conv bias that feeds a train-mode
  BatchNorm has the true gradient 0 and a computed one of rounding noise,
  so it is held by its difference against its layer's largest gradient
  instead, at the same 1e-3;
- the separator's audio within rtol 5e-4, atol 1e-5, its SI-SDR within
  1e-3.

The blocks: fusion dp x tp (the phasegram encoder's K2 route, whose
statistics take the split route), fusion dp x tp with K = 2 stacked steps
(--steps_per_dispatch), fusion dp with --microbatch 2 (each chunk the
global rows JAX's chunk holds), fusion dp x tp --fusion_encode full,
fusion dp x tp --noise_schedule, the separator under dp x tp (full
encode), and the frames family, --frames_encode full, dp and dp x tp
(MAAVSS_S2D_MIN_HW=8: stages 0 and 1 take K5, whose reductions take the
split route). On the CPU every kernel runs its plain version.

`--device cuda` puts the ranks on the card, one card a rank, over NCCL
(a host with fewer cards than ranks raises: NCCL refuses two ranks on one
card, and gloo's CUDA collectives cannot be captured for the K = 2
block's graph). Exit 0 and `dryrun_multichip_torch ok` when every block
passes.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BLOCKS = ("fusion_dpxtp", "fusion_dpxtp_k2", "fusion_dp_microbatch",
          "fusion_dpxtp_full", "fusion_dpxtp_noise", "separator_dpxtp",
          "frames_dp", "frames_dpxtp")
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 5e-4, 1e-6
AUDIO_RTOL, AUDIO_ATOL = 5e-4, 1e-5
SDR_TOL = 1e-3
GRAD_RTOL = 1e-3
FUSION = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
              p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3)
FRAMES = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
              p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
              framesize=24, frames_encode="full")
FRAMES_MIN_HW = "8"  # stages 0 and 1 of a 24-pixel frame take K5


def block_plan(name: str, world: int):
    """(config overrides, (data, model), K, global batch) of a block at a
    world of `world` ranks: model 2 where the world is even (the JAX
    dryrun's n_model), the dp blocks over every rank, a global batch of 2
    rows a rank."""
    model = 2 if world % 2 == 0 else 1
    dpxtp, dp = (world // model, model), (world, 1)
    batch = 2 * world
    plans = {
        "fusion_dpxtp": (dict(FUSION, pgenc_kernel="pallas"), dpxtp, 1),
        "fusion_dpxtp_k2": (dict(FUSION), dpxtp, 2),
        "fusion_dp_microbatch": (dict(FUSION, microbatch=2), dp, 1),
        "fusion_dpxtp_full": (dict(FUSION, fusion_encode="full",
                                   pgenc_kernel="pallas"), dpxtp, 1),
        "fusion_dpxtp_noise": (dict(FUSION, noise_schedule="linear:0.3:0.0"),
                               dpxtp, 1),
        "separator_dpxtp": (dict(FUSION, fusion_encode="full"), dpxtp, 1),
        "frames_dp": (dict(FRAMES), dp, 1),
        "frames_dpxtp": (dict(FRAMES), dpxtp, 1),
    }
    over, shape, k = plans[name]
    return over, shape, k, batch


@contextlib.contextmanager
def _env(key: str, value: Optional[str]):
    before = os.environ.get(key)
    if value is not None:
        os.environ[key] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = before


def _batch(name: str, cfg, batch: int, k: int):
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.train.setup import stack_batches

    if name.startswith("frames"):
        return synthetic_av_batch(cfg, batch, seed=1,
                                  frame_size=cfg.framesize)
    raw = synthetic_av_batch(cfg, batch, seed=0)
    if k == 1:
        return raw
    return stack_batches([raw, synthetic_av_batch(cfg, batch, seed=3)])


def run_block(name: str, world: int, device: str = "cpu",
              mesh=None) -> Dict[str, object]:
    """One block in this process: under `mesh` (this rank's share of it),
    or without one on the whole batch. Returns {'loss': float, 'params':
    {name: whole tensor}} (every rank gathers; rank 0's is the answer), or
    for the separator {'audio', 'si_sdr'} of the global batch."""
    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.parallel.distributed import host_local_to_global
    from maavss_tpu_torch.parallel.mesh import gather_named, shard_batch
    from maavss_tpu_torch.train.infer import make_separator
    from maavss_tpu_torch.train.setup import (
        apply_mesh_model,
        build_frames_model,
        build_fusion,
    )
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_fusion_step, make_frames_step

    over, (data, model_ax), k, batch = block_plan(name, world)
    shape = (dict(mesh_data=data, mesh_model=model_ax) if mesh is not None
              else {})
    cfg = RunConfig(**over, batch_size=batch, **shape)
    frames = name.startswith("frames")
    with _env("MAAVSS_S2D_MIN_HW", FRAMES_MIN_HW if frames else None):
        init = torch.Generator().manual_seed(0)
        if frames:
            model = build_frames_model(cfg, batch, cfg.framesize, 8, device,
                                       init)
        else:
            model = build_fusion(cfg, batch, device, init)
        state = create_train_state(model, cfg, device, "sgd")
        apply_mesh_model(cfg, mesh, state)
        raw = shard_batch(_batch(name, cfg, batch, k), stacked=k > 1,
                          microbatch=cfg.microbatch, mesh=mesh)
        gen = torch.Generator(device=device).manual_seed(0)
        if name.startswith("separator"):
            batch_t = {key: torch.as_tensor(v).to(device)
                       for key, v in raw.items()}
            out = make_separator(model, cfg)(batch_t, gen)
            whole = host_local_to_global(
                {"audio": out["audio_out"], "si_sdr": out["si_sdr"]}, mesh)
            return {key: v.detach().cpu() for key, v in whole.items()}
        factory = make_frames_step if frames else make_fusion_step
        step = factory(model, cfg, device=device, k_steps=k)
        state, metrics = step(state, raw, 2, gen)
        loss = metrics["loss"]
        loss = float(loss[-1] if loss.ndim else loss)
        params = gather_named(mesh, model, dict(model.named_parameters()))
        grads = gather_named(mesh, model, {
            key: p.grad if p.grad is not None else torch.zeros_like(p)
            for key, p in model.named_parameters()})
        return {"loss": loss,
                "params": {key: v.detach().cpu() for key, v in params.items()},
                "grads": {key: v.detach().cpu() for key, v in grads.items()},
                "fed": bn_fed_biases(model)}


def bn_fed_biases(model: torch.nn.Module) -> List[str]:
    """Parameter names of every conv bias of `model` that feeds a
    BatchNorm (models/layers.py:ConvStack.bn_fed_biases)."""
    from maavss_tpu_torch.models.layers import ConvStack

    return [f"{path}.{leaf}" for path, mod in model.named_modules()
            if isinstance(mod, ConvStack) for leaf in mod.bn_fed_biases()]


def grad_gate(name: str, got: Dict[str, torch.Tensor],
              want: Dict[str, torch.Tensor], fed=(), rtol: float = GRAD_RTOL,
              loose: Tuple[str, float] = ("", 0.0)) -> Dict[str, object]:
    """Hold each leaf's gradient `got[k]` to `want[k]`: relative L2 within
    `rtol` (`loose[1]` for the leaves whose names start with a non-empty
    `loose[0]`); a BN-fed bias (`fed`), whose gradient is rounding noise
    around 0, by its largest difference against `rtol` of the largest
    gradient of its layer (the leaves beside it). Raises AssertionError
    naming every leaf past its gate; returns the worst leaf's relative L2
    and name, and the worst BN-fed bias's ratio."""
    fed = set(fed)
    assert set(got) == set(want), f"{name}: gradient leaves differ"
    worst = {"grad_worst_rel_l2": 0.0, "grad_worst_leaf": None,
             "grad_worst_bn_fed_bias": 0.0}
    bad = []
    for key in sorted(want):
        g, ref = got[key].double(), want[key].double()
        diff = float((g - ref).norm())
        if key in fed:
            layer = key.rsplit(".", 1)[0] + "."
            scale = max(float(v.abs().max()) for k, v in want.items()
                        if k.startswith(layer) and v.numel())
            d = float((g - ref).abs().max())
            ratio = d / scale if scale else (0.0 if d == 0 else float("inf"))
            worst["grad_worst_bn_fed_bias"] = max(
                worst["grad_worst_bn_fed_bias"], ratio)
            if not ratio <= rtol:
                bad.append(f"{key} (BN-fed bias) differs by {d:.3e}, "
                           f"{ratio:.3e} of its layer's largest gradient")
            continue
        norm = float(ref.norm())
        rel = 0.0 if diff == 0 else (diff / norm if norm else float("inf"))
        limit = loose[1] if loose[0] and key.startswith(loose[0]) else rtol
        if rel > worst["grad_worst_rel_l2"]:
            worst["grad_worst_rel_l2"], worst["grad_worst_leaf"] = rel, key
        if not rel <= limit:
            bad.append(f"{key} rel L2 {rel:.3e} > {limit}")
    assert not bad, (f"{name}: the sharded step's gradient differs from the "
                     "one-process gradient: " + "; ".join(bad))
    return worst


def check(name: str, got: Dict, want: Dict) -> Tuple[float, float]:
    """Raise AssertionError unless the sharded run `got` matches the
    one-process run `want` to the dryrun's standard; returns the loss's
    and the worst leaf gradient's relative difference (0, 0 for the
    separator)."""
    if "audio" in want:
        audio, ref = got["audio"].numpy(), want["audio"].numpy()
        assert np.all(np.isfinite(audio)), f"{name}: non-finite audio"
        np.testing.assert_allclose(audio, ref, rtol=AUDIO_RTOL,
                                   atol=AUDIO_ATOL, err_msg=name)
        np.testing.assert_allclose(got["si_sdr"].numpy(),
                                   want["si_sdr"].numpy(), rtol=SDR_TOL,
                                   atol=SDR_TOL, err_msg=name)
        return 0.0, 0.0
    loss, ref = got["loss"], want["loss"]
    assert np.isfinite(loss), f"{name}: loss not finite: {loss}"
    rel = abs(loss - ref) / max(abs(ref), 1e-12)
    assert rel < LOSS_RTOL, (f"{name}: sharded loss {loss} != one-process "
                             f"loss {ref} (rel {rel:.2e})")
    assert set(got["params"]) == set(want["params"]), name
    for key, ref_p in want["params"].items():
        np.testing.assert_allclose(got["params"][key].float().numpy(),
                                   ref_p.float().numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=f"{name}: {key}")
    worst = grad_gate(name, got["grads"], want["grads"], want["fed"])
    return rel, worst["grad_worst_rel_l2"]


def _rank(rank: int, world: int, port: int, device: str, names: List[str],
          out_dir: str) -> None:
    """One spawned rank: join the group, run every block under its mesh,
    rank 0 saves each block's gathered result."""
    import torch.distributed as dist

    from maavss_tpu_torch.parallel.mesh import make_mesh, use_mesh

    torch.set_num_threads(1)
    dev = device
    if device == "cuda":
        dev = f"cuda:{rank}"
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        for name in names:
            _, (data, model), _, _ = block_plan(name, world)
            mesh = make_mesh(data, model, set_current=False)
            with use_mesh(mesh):
                out = run_block(name, world, dev, mesh)
            if rank == 0:
                torch.save(out, os.path.join(out_dir, f"{name}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun(world: int = 4, device: str = "cpu",
           names: Optional[List[str]] = None, timeout: float = 600.0
           ) -> Dict[str, Dict[str, Dict]]:
    """Spawn the ranks, run the one-process blocks meanwhile, join;
    -> {block: {'sharded': ..., 'anchor': ...}} (not yet checked)."""
    import torch.multiprocessing as mp

    names = list(names or BLOCKS)
    unknown = set(names) - set(BLOCKS)
    if unknown:
        raise SystemExit(f"unknown blocks {sorted(unknown)} ({BLOCKS})")
    if device == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(
            f"--device cuda needs a card a rank over NCCL: {world} ranks, "
            f"{torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank, args=(world, _free_port(), device, names, out_dir),
            nprocs=world, join=False, start_method="spawn")
        anchor_dev = "cuda:0" if device == "cuda" else "cpu"
        anchors = {name: run_block(name, world, anchor_dev)
                   for name in names}
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise RuntimeError(f"dryrun ranks did not finish in "
                                   f"{timeout} s")
        return {name: {"sharded": torch.load(os.path.join(out_dir,
                                                          f"{name}.pt")),
                       "anchor": anchors[name]} for name in names}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    p.add_argument("--blocks", nargs="*", default=None)
    args = p.parse_args(argv)
    results = dryrun(args.world, args.device, args.blocks)
    for name, r in results.items():
        rel, grel = check(name, r["sharded"], r["anchor"])
        print(f"dryrun_multichip_torch {name} ok (world {args.world}, loss "
              f"rel {rel:.2e}, worst leaf gradient rel {grel:.2e})")
    print("dryrun_multichip_torch ok")


if __name__ == "__main__":
    main()
