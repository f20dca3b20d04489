"""Data and tensor parallelism of the port (maavss_tpu_torch/parallel/):
the shape rule against the JAX package's `state_shardings`, the eight
blocks of tools/dryrun_multichip_torch.py (gloo ranks against the
one-process run), the split K2 and K5 routes and the global-batch
BatchNorm at world 2 against the one-process layers, the --microbatch
row interleave (a contiguous cut fails), the refusals of a mesh that is
not the world, and the split launches against their plain versions on
the card (skipped here). The ranks' bodies are in
tests/torch_parallel_ranks.py; tests/test_torch_parallel_jax.py holds the
4-rank step against the JAX package's (2, 2)-mesh step and the sharded
checkpoint."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.models.fusion_frames import AVFusionFramesModel as JaxFrames
from maavss_tpu.parallel import mesh as jax_mesh
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import flatten_tree, from_flax
from maavss_tpu_torch.models.layers import TorchBatchNorm
from maavss_tpu_torch.ops import cuda_epilogue as ep
from maavss_tpu_torch.ops import cuda_pgenc as pg
from maavss_tpu_torch.parallel import distributed
from maavss_tpu_torch.parallel import mesh as port_mesh
from maavss_tpu_torch.train.setup import (
    apply_mesh_model,
    build_fusion_state,
    check_supported,
    default_mesh,
)
from maavss_tpu_torch.train.steps import make_fusion_step
from tests import torch_parallel_ranks as ranks
from tests.test_torch_workers import share_cores
from tools import dryrun_multichip_torch as dryrun
from tools import fit_torch

share_cores()


# ------------------------------------------------------- (a) the rule


def _flax_fusion(batch=2):
    t_stft = 4 * 4
    return JaxFusion(stft_shape=(batch, 2, t_stft, 32),
                     pgram_shape=(batch, 1, 4, 256), latent_channels=8,
                     fc_size=256)


def _flax_frames(batch=2):
    return JaxFrames(stft_shape=(batch, 2, 8, 33),
                     frame_shape=(batch, 1, 2, 24, 24), hops_per_frame=4,
                     latent_channels=8)


def _split_paths(params, n_model):
    """Flax paths the JAX package's `state_shardings` puts on 'model' over
    a (1, n_model) mesh of the virtual CPU devices."""
    mesh = jax_mesh.make_mesh(1, n_model, devices=jax.devices()[:n_model])
    sh = jax.tree_util.tree_leaves_with_path(
        jax_mesh.state_shardings(mesh, params))
    return {"/".join(k.key for k in path) for path, s in sh
            if any(ax == jax_mesh.MODEL_AXIS for ax in s.spec)}


def _port_names(params):
    """{flax path: torch name} through `from_flax`: each leaf tagged with
    its index, read back after the conversion (transposes and flips keep
    the values)."""
    flat = flatten_tree(params)
    paths = sorted(flat)
    tagged = {p: np.full(flat[p].shape, i, np.float32)
              for i, p in enumerate(paths)}
    from maavss_tpu_torch.convert import unflatten_tree

    conv = from_flax(unflatten_tree(tagged))
    return {paths[int(v.reshape(-1)[0])]: k for k, v in conv.items()}


@pytest.mark.parametrize("family", ["fusion", "frames"])
@pytest.mark.parametrize("n_model", [2, 4])
def test_shape_rule_picks_the_jax_model_leaves(family, n_model):
    model = _flax_fusion() if family == "fusion" else _flax_frames()
    shapes = model.stft_shape, (model.pgram_shape if family == "fusion"
                                else model.frame_shape)
    variables = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros(shapes[0]),
                           jnp.zeros(shapes[1]), method=model.init_all))
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), variables["params"])
    want = _split_paths(params, n_model)
    names = _port_names(params)
    conv = from_flax(params)
    got = {p for p, name in names.items()
           if port_mesh.model_shard_dim(name, tuple(conv[name].shape),
                                        n_model) is not None}
    assert want and got == want
    # torch's layouts: a Dense weight on dim 0, the LSTM's on dim 1
    for p in want:
        dim = port_mesh.model_shard_dim(names[p], tuple(conv[names[p]].shape),
                                        n_model)
        assert dim == (1 if p.rsplit("/", 1)[-1] in ("w_i", "w_h") else 0)


# ------------------------------------------------ (c) the dryrun blocks


@pytest.fixture(scope="module")
def dryrun_results():
    return dryrun.dryrun(world=4, device="cpu")


@pytest.mark.parametrize("block", dryrun.BLOCKS)
def test_dryrun_block_matches_one_process(dryrun_results, block):
    r = dryrun_results[block]
    rel, grel = dryrun.check(block, r["sharded"], r["anchor"])
    assert rel < dryrun.LOSS_RTOL and grel < dryrun.GRAD_RTOL


# -------------------------------------- (d, e, g) world-2 split routes


def _split_inputs():
    rng = np.random.default_rng(7)
    f = np.float32
    c, co, r, s = 3, 5, 12, 16
    k2 = (rng.standard_normal((c, r, s)).astype(f),
          (0.3 * rng.standard_normal((co, 9 * c))).astype(f),
          rng.standard_normal(co).astype(f),
          (1.0 + 0.2 * rng.standard_normal(co)).astype(f),
          (0.1 * rng.standard_normal(co)).astype(f),
          rng.standard_normal((co, r, s // 2)).astype(f))
    b, ch, t, h, w = 4, 3, 2, 6, 8
    k5 = (rng.standard_normal((b, ch, t, h, w)).astype(f),
          rng.standard_normal((b, ch, t, h // 2, w // 2)).astype(f),
          np.array([1.2, -0.7, 0.5], f), np.array([0.1, 0.0, -0.2], f),
          rng.standard_normal(ch).astype(f), rng.standard_normal(ch).astype(f))
    bn = (rng.standard_normal((4, 3, 5, 6)).astype(f),
          rng.standard_normal((4, 3, 5, 6)).astype(f))
    return {"k2": k2, "k5": k5, "bn": bn}


@pytest.fixture(scope="module")
def world2():
    return ranks.spawn(ranks.split_layers_rank, 2, _split_inputs())


def _close(a, b, what, rtol=1e-5, atol=1e-6):
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=what)


def test_k2_split_route_matches_one_process_layer(world2):
    x, w2, cbias, gamma, beta, dy = (torch.from_numpy(a)
                                     for a in _split_inputs()["k2"])
    leaves = [t.clone().requires_grad_(True) for t in (x, w2, cbias, gamma,
                                                       beta)]
    y, mu, var = pg.pgenc_layer_train(*leaves)
    (y * dy).sum().backward()
    got = world2["k2"]
    for key, want in (("y", y), ("mu", mu), ("var", var),
                      ("dx", leaves[0].grad), ("dw2", leaves[1].grad),
                      ("dgamma", leaves[3].grad), ("dbeta", leaves[4].grad)):
        _close(got[key], want.detach(), key)


def test_k5_split_route_matches_one_process_tail(world2):
    y, g, gamma, beta, a_mu, a_var = (torch.from_numpy(a)
                                      for a in _split_inputs()["k5"])
    yl = y.clone().requires_grad_(True)
    p = [t.clone().requires_grad_(True) for t in (gamma, beta)]
    out, mu, var = ep.fused_bn_pool_leaky(yl, *p)
    ((out * g).sum() + (mu * a_mu).sum() + (var * a_var).sum()).backward()
    got = world2["k5"]
    for key, want in (("out", out), ("mu", mu), ("var", var),
                      ("dy", yl.grad), ("dgamma", p[0].grad),
                      ("dbeta", p[1].grad)):
        _close(got[key], want.detach(), key)


def test_batchnorm_takes_global_statistics(world2):
    xb, gb = (torch.from_numpy(a) for a in _split_inputs()["bn"])
    bn = TorchBatchNorm(xb.shape[1]).train()
    x = xb.clone().requires_grad_(True)
    (bn(x) * gb).sum().backward()
    got = world2["bn"]
    _close(got["dx"], x.grad, "dx")
    _close(got["dweight"], bn.BatchNorm_0.weight.grad, "dweight")
    _close(got["running_mean"], bn.BatchNorm_0.running_mean, "mean")
    _close(got["running_var"], bn.BatchNorm_0.running_var, "var")


def test_microbatch_chunks_are_the_global_chunks(world2):
    """Rank d's chunk c is its share of global rows [c*B/mb, (c+1)*B/mb):
    the step on interleaved rows is the one-process step; on a contiguous
    cut the chunks' BatchNorm statistics differ and so does the update."""
    assert list(port_mesh.rank_rows(8, 2, 0, 2)) == [0, 1, 4, 5]
    assert list(port_mesh.rank_rows(8, 2, 1, 2)) == [2, 3, 6, 7]
    cfg = RunConfig(**ranks.SMALL, batch_size=8, microbatch=2,
                    noise_scalar=0.0)
    model, state = build_fusion_state(cfg, 8, "cpu",
                                      torch.Generator().manual_seed(0),
                                      optimizer="sgd")
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    _, m = make_fusion_step(model, cfg, device="cpu")(
        state, ranks.microbatch_batch(cfg), 2)
    want = float(m["loss"])
    names = sorted(init)

    def update(params):
        return torch.cat([(params[k].detach() - init[k]).double()
                          .reshape(-1) for k in names])

    ref = update(dict(model.named_parameters()))
    rel = {}
    for label, (loss, params) in world2["microbatch"].items():
        rel[label] = float((update(params) - ref).norm() / ref.norm())
    assert abs(world2["microbatch"]["interleaved"][0] - want) / want < 1e-4
    assert rel["interleaved"] < 1e-3, rel
    assert rel["contiguous"] > 1e-2, rel


def test_a_mesh_that_is_not_the_world_raises(world2):
    assert "needs 4 ranks, the world has 2" in world2["mesh_refused"]
    cfg = RunConfig(**ranks.SMALL, mesh_model=2)
    with pytest.raises(ValueError, match="the world has 1"):
        check_supported(cfg, train=True)
    with pytest.raises(ValueError, match="the world has 1"):
        default_mesh(cfg)
    with pytest.raises(ValueError, match="the world has 1"):
        build_fusion_state(cfg, 2, "cpu")
    with pytest.raises(ValueError, match="the world has 1"):
        port_mesh.make_mesh(2, 1)
    assert port_mesh.make_mesh(-1, 1) is None  # one process: no mesh


def test_fit_torch_mesh_model_without_a_world_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="--mesh_data / --mesh_model"):
        fit_torch.main(["--device", "cpu", "--data_path", "synthetic",
                        "--mesh_model", "2", "-e", "1", "-s", "1", "-b",
                        "2"])
    assert not os.path.exists(tmp_path / "runs")


def test_graphs_over_gloo_raise_and_cpu_k_steps_run():
    """A K-step dispatch on CUDA tensors under a gloo group raises naming
    M11 (graphs over gloo); on CPU tensors it runs its K steps eagerly
    (tools/dryrun_multichip_torch.py's K = 2 block)."""
    from maavss_tpu_torch.train.cuda_graph import KStep

    class _Gloo:
        backend = "gloo"

    with port_mesh.use_mesh(_Gloo()):
        kstep = KStep(lambda *a, **k: None, 2, "cuda:0", False, 0.0)
        with pytest.raises(NotImplementedError, match="graphs over gloo"):
            kstep(None, {"audio": torch.zeros(2, 1)}, 2)


# --------------------------------------- (h) the split launches on a card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py's parallel phase holds every "
                    "split launch against its plain version on the card")


def _two_rank_inputs(device, dtype):
    x, w2, cbias, gamma, beta, dy = (torch.from_numpy(a).to(device)
                                     for a in _split_inputs()["k2"])
    y, g, gamma5, beta5, a_mu, a_var = (torch.from_numpy(a).to(device)
                                        for a in _split_inputs()["k5"])
    k2 = (x.to(dtype), w2.to(dtype), cbias, gamma, beta, dy.to(dtype))
    k5 = (y.to(dtype), gamma5, beta5, g.to(dtype), a_mu, a_var)
    return k2, k5


def _two_rank_checks(device, dtype, kernels=("k2", "k5")):
    """chip_smoke.py's two-rank checks of the split launches (two slots of
    partials, rank 1's slot offset and row stride, the own-slot dgamma and
    dbeta), at the k2_train gates; on CPU tensors every launch is its plain
    version."""
    import chip_smoke

    fp32 = dtype == torch.float32
    tol = (2e-5, 1e-4) if fp32 else (2.0 ** -7, 2.0 ** -7)
    k2, k5 = _two_rank_inputs(device, dtype)
    if "k2" in kernels:
        chip_smoke._k2_two_ranks(*k2, *tol, f"{device} {dtype}")
    if "k5" in kernels:
        chip_smoke._k5_two_ranks(*k5, f"{device} {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_slot_plain_routes_join_to_one_process(dtype):
    _two_rank_checks("cpu", dtype)


def test_process_batch_slice_is_shard_batch_rows():
    class _Mesh:
        data, model = 2, 1

    rows = np.arange(8)[:, None] * np.ones((1, 3))
    for d in range(2):
        mesh = _Mesh()
        mesh.d = d
        for mb in (1, 2):
            got = distributed.process_batch_slice(8, mb, mesh)
            want = port_mesh.shard_batch({"x": rows}, microbatch=mb,
                                         mesh=mesh)["x"][:, 0]
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(distributed.process_batch_slice(6),
                                  np.arange(6))


def test_apply_mesh_model_refuses_a_mesh_cfg_did_not_ask_for():
    cfg = RunConfig(**ranks.SMALL, mesh_model=2)
    model, state = build_fusion_state(RunConfig(**ranks.SMALL), 2, "cpu",
                                      optimizer="sgd")
    with pytest.raises(ValueError, match="--mesh_model 2 but the mesh has 1"):
        apply_mesh_model(cfg, None, state)
    assert apply_mesh_model(RunConfig(**ranks.SMALL), None, state) == (
        state, {})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_split_launches_match_plain_on_card(dtype):
    _cuda()
    _two_rank_checks("cuda", dtype, ("k2",))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_split_launches_match_plain_on_card(dtype):
    _cuda()
    _two_rank_checks("cuda", dtype, ("k5",))
