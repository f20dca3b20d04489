"""The rank bodies of tests/test_torch_parallel*.py: functions that spawned
gloo ranks run (this module imports no jax, so that a rank starts in a
few seconds), and `spawn`, which runs one over `world` ranks and returns
what rank 0 saved."""

from __future__ import annotations

import os
import socket
import tempfile

import numpy as np
import torch

SMALL = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
             p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, port, out, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        result = fn(rank, world, *args)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = 300.0):
    """Run fn(rank, world, *args) on `world` spawned gloo ranks (one thread
    each); returns rank 0's result. A rank that raises fails the call
    with its traceback."""
    return finish(start(fn, world, *args), timeout)


def start(fn, world: int, *args):
    """`spawn` without waiting: (context, output path, temporary
    directory); `finish` joins and loads."""
    import torch.multiprocessing as mp

    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "rank0.pt")
    ctx = mp.start_processes(_entry, args=(fn, world, _free_port(), out,
                                           args),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out, tmp


def finish(handle, timeout: float = 300.0):
    ctx, out, tmp = handle
    try:
        while not ctx.join(timeout=timeout):
            pass
        return torch.load(out, weights_only=False)
    finally:
        tmp.cleanup()


# ---------------------------------------------------------------- bodies


def _whole(mesh, model, tensors):
    from maavss_tpu_torch.parallel.mesh import gather_named

    return {k: v.detach().cpu().clone()
            for k, v in gather_named(mesh, model, tensors).items()}


def jax_step_rank(rank, world, npz_path, batch_path, cfg_kw):
    """(test b) One SGD fusion step from converted flax weights on a
    (2, 2) mesh; rank 0 returns the loss and the whole state."""
    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.convert import from_flax, load_npz
    from maavss_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from maavss_tpu_torch.train.setup import apply_mesh_model, build_fusion
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_fusion_step

    cfg = RunConfig(**cfg_kw, mesh_data=2, mesh_model=2)
    mesh = make_mesh(2, 2)
    model = build_fusion(cfg, cfg.batch_size, "cpu")
    params, stats = load_npz(npz_path)
    model.load_state_dict(from_flax(params, stats))
    state = create_train_state(model, cfg, "cpu", "sgd")
    apply_mesh_model(cfg, mesh, state)
    batch = dict(np.load(batch_path))
    step = make_fusion_step(model, cfg, device="cpu")
    state, m = step(state, shard_batch(batch, mesh=mesh), 2)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    return {"loss": float(m["loss"]),
            "state": _whole(mesh, model, model.state_dict()),
            "grads": _whole(mesh, model, grads),
            "bn_fed": model.bn_fed_biases()}


def checkpoint_rank(rank, world, cp_dir):
    """(test f) An Adam step under a (2, 2) mesh, its checkpoint (rank 0
    writes the whole state), and a resume into a fresh sharded state that
    must give every rank its shards back bit for bit; rank 0 returns the
    whole parameters and moments."""
    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.exp.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from maavss_tpu_torch.parallel.distributed import barrier
    from maavss_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from maavss_tpu_torch.train.setup import (
        apply_mesh_model,
        build_fusion_state,
    )
    from maavss_tpu_torch.train.steps import make_fusion_step

    cfg = RunConfig(**SMALL, batch_size=4, mesh_data=2, mesh_model=2)
    mesh = make_mesh(2, 2)

    def fresh():
        model, state = build_fusion_state(
            cfg, 4, "cpu", torch.Generator().manual_seed(0))
        apply_mesh_model(cfg, mesh, state)
        return model, state

    model, state = fresh()
    step = make_fusion_step(model, cfg, device="cpu")
    batch = shard_batch(synthetic_av_batch(cfg, 4, seed=5), mesh=mesh)
    state, _ = step(state, batch, 2, torch.Generator().manual_seed(0))
    save_checkpoint(cp_dir, "run", state, epoch=1, loss=0.5)
    barrier()
    model2, state2 = fresh()
    load_checkpoint(cp_dir, state2, auto=True, load_opt=True)
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 model2.state_dict().items()):
        if not torch.equal(a, b):
            raise AssertionError(f"rank {rank}: resumed {name} differs")
    for col, col2 in ((state.tx.m, state2.tx.m), (state.tx.v, state2.tx.v)):
        for a, b in zip(col, col2):
            if not torch.equal(a, b):
                raise AssertionError(f"rank {rank}: a resumed moment differs")
    if state2.tx.count != state.tx.count or state2.step != state.step:
        raise AssertionError("resumed count or step differs")
    names = [n for n, _ in model.named_parameters()]
    return {"params": _whole(mesh, model, dict(model.named_parameters())),
            "buffers": {k: v.clone() for k, v in model.named_buffers()},
            "m": _whole(mesh, model, dict(zip(names, state.tx.m))),
            "v": _whole(mesh, model, dict(zip(names, state.tx.v))),
            "count": state.tx.count, "step": state.step}


def microbatch_batch(cfg):
    """A global batch of 8 whose second half is 5x louder: the --microbatch
    2 chunks' BatchNorm statistics differ clearly from those of any other
    split of the rows."""
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch

    raw = synthetic_av_batch(cfg, 8, seed=2)
    raw["audio"][4:] *= 5.0
    return raw


def split_layers_rank(rank, world, inputs):
    """(test d, e, g) At world 2: K2's and K5's split routes and
    TorchBatchNorm's global statistics on this rank's half of the rows,
    their outputs and gradients joined over the ranks; the microbatch
    step with interleaved and with contiguous rows; the refusals of a
    mesh that is not the world."""
    from maavss_tpu_torch.models.layers import TorchBatchNorm
    from maavss_tpu_torch.ops.cuda_epilogue import fused_bn_pool_leaky
    from maavss_tpu_torch.ops.cuda_pgenc import (
        pgenc_layer_train,
        pgenc_split_plain,
    )
    from maavss_tpu_torch.parallel.collectives import combine, gather
    from maavss_tpu_torch.parallel.mesh import make_mesh

    out = {}
    try:
        make_mesh(2, 2)
    except ValueError as e:
        out["mesh_refused"] = str(e)
    mesh = make_mesh(2, 1)

    def rows(t, dim):
        n = t.shape[dim] // world
        return t.narrow(dim, rank * n, n).contiguous()

    def joined(t, dim):
        return torch.cat(list(gather(t.detach().contiguous()).unbind(0)),
                         dim=dim)

    # K2-train's split route, through the differentiable layer
    x, w2, cbias, gamma, beta, dy = (torch.from_numpy(a)
                                     for a in inputs["k2"])
    xl = rows(x, 1).requires_grad_(True)
    params = [t.clone().requires_grad_(True) for t in (w2, cbias, gamma,
                                                       beta)]
    y, mu, var = pgenc_layer_train(xl, *params, split=True)
    (y * rows(dy, 1)).sum().backward()
    (py, pmu, pvar, _), pg = pgenc_split_plain(
        xl.detach(), w2, cbias, gamma, beta, rows(dy, 1))
    for a, b in zip((y, mu, var, xl.grad, params[0].grad, params[3].grad),
                    (py, pmu, pvar, pg[0], pg[1], pg[4])):
        if not torch.equal(a.detach(), b):
            raise AssertionError("pgenc_split_plain != the layer's route")
    out["k2"] = {"y": joined(y, 1), "mu": mu.detach(), "var": var.detach(),
                 "dx": joined(xl.grad, 1),
                 "dw2": combine(params[0].grad), "dgamma":
                 combine(params[2].grad), "dbeta": combine(params[3].grad)}

    # K5's split route (fused_bn_pool_leaky on the CPU: its plain version)
    y5, g5, gam5, bet5, a_mu, a_var = (torch.from_numpy(a)
                                       for a in inputs["k5"])
    yl = rows(y5, 0).requires_grad_(True)
    p5 = [t.clone().requires_grad_(True) for t in (gam5, bet5)]
    o5, m5, v5 = fused_bn_pool_leaky(yl, *p5, split=True)
    ((o5 * rows(g5, 0)).sum() + (m5 * a_mu).sum() / world
     + (v5 * a_var).sum() / world).backward()
    out["k5"] = {"out": joined(o5, 0), "mu": m5.detach(), "var": v5.detach(),
                 "dy": joined(yl.grad, 0), "dgamma": combine(p5[0].grad),
                 "dbeta": combine(p5[1].grad)}

    # TorchBatchNorm in train mode
    xb, gb = (torch.from_numpy(a) for a in inputs["bn"])
    bn = TorchBatchNorm(xb.shape[1]).train()
    xbl = rows(xb, 0).requires_grad_(True)
    (bn(xbl) * rows(gb, 0)).sum().backward()
    out["bn"] = {"dx": joined(xbl.grad, 0),
                 "running_mean": bn.BatchNorm_0.running_mean.clone(),
                 "running_var": bn.BatchNorm_0.running_var.clone(),
                 "dweight": combine(bn.BatchNorm_0.weight.grad)}

    # --microbatch 2: interleaved rows (shard_batch) and contiguous ones
    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.parallel.mesh import shard_batch
    from maavss_tpu_torch.train.setup import build_fusion_state
    from maavss_tpu_torch.train.steps import make_fusion_step

    cfg = RunConfig(**SMALL, batch_size=8, microbatch=2, noise_scalar=0.0,
                    mesh_data=2)
    raw = microbatch_batch(cfg)
    runs = {}
    for label, mb in (("interleaved", 2), ("contiguous", 1)):
        model, state = build_fusion_state(
            cfg, 8, "cpu", torch.Generator().manual_seed(0),
            optimizer="sgd")
        step = make_fusion_step(model, cfg, device="cpu")
        _, m = step(state, shard_batch(raw, microbatch=mb, mesh=mesh), 2)
        runs[label] = (float(m["loss"]),
                       {k: v.detach().clone()
                        for k, v in model.named_parameters()})
    out["microbatch"] = runs
    return out
