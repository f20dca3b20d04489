"""The port's fused phasegram-encoder layer (ops/cuda_pgenc.py) and its
kernel stack (models/layers.KernelConvStack1x9) against the JAX package:
`fused_conv_bn_tanh_eval` in interpret mode with non-trivial running stats,
and flax's ConvStack in eval mode on converted weights. fp32; tolerance
2e-5 absolute on tanh outputs (conv summation order differs).

Also the tile plan of the K2 forward kernels (`pgenc_plan`, pure Python):
at the fusion flagship's 10 encoder layers at every R the system runs and
at the ragged shapes of chip_smoke's k2_gate, every output lies in exactly
one tile, the block fits the card, and the cooperative grid is within the
resident blocks it is given; bad shapes raise before any launch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.models.layers import ConvStack as JaxConvStack
from maavss_tpu.models.shape_plan import ConvSpec
from maavss_tpu.ops.pallas_pgenc import fused_conv_bn_tanh_eval
from maavss_tpu_torch.convert import from_flax
from maavss_tpu_torch.models.layers import ConvStack, KernelConvStack1x9
from maavss_tpu_torch.models.shape_plan import ConvSpec as PortConvSpec
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.models.shape_plan import plan_phasegram_encoder
from maavss_tpu_torch.ops.cuda_pgenc import (
    _SMEM_LIMIT,
    MAX_THREADS,
    PgencPlan,
    pgenc_layer,
    pgenc_layer_plain,
    pgenc_plan,
    plan_of,
    train_grid,
)
from tests.test_torch_workers import share_cores

share_cores()

ATOL = 2e-5
# the fusion flagship's encoder layers (C, Co, S); R = batch * frames rows:
# 64 and 256 (scan and vectorized windows at batch 8), 2048 and 8192
# (bench.py's batch 256)
FLAGSHIP = ((1, 2, 4096), (2, 4, 2048), (4, 8, 1024), (8, 16, 512),
            (16, 32, 256), (32, 64, 128), (64, 64, 64), (64, 64, 32),
            (64, 64, 16), (64, 64, 8))
ROWS = (64, 256, 2048, 8192)
# chip_smoke.py's k2_gate: C = 3 -> Co = 5 at ragged R and S
GATE = tuple((3, 5, s, r) for r in (1, 3, 17, 2048, 8192)
             for s in (2, 6, 4098))


def _layer_inputs(c, co, r, s, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, r, s)).astype(np.float32)
    w2 = (rng.standard_normal((co, 9 * c)) / (3 * np.sqrt(c))).astype(np.float32)
    cbias, beta, mean = (rng.standard_normal(co).astype(np.float32) * 0.1
                         for _ in range(3))
    gamma = (1.0 + 0.2 * rng.standard_normal(co)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, co).astype(np.float32)
    return x, w2, (cbias, gamma, beta, mean, var)


@pytest.mark.parametrize("c,co,s", [(1, 2, 64), (4, 8, 16), (8, 8, 8)])
def test_plain_layer_matches_pallas_interpret(c, co, s):
    x, w2, vecs = _layer_inputs(c, co, 6, s)
    got = pgenc_layer_plain(torch.from_numpy(x), torch.from_numpy(w2),
                            *map(torch.from_numpy, vecs))
    want = fused_conv_bn_tanh_eval("dense", jnp.asarray(x), jnp.asarray(w2),
                                   *map(jnp.asarray, vecs))
    assert got.shape == (co, 6, s // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_odd_width_raises_like_jax():
    x, w2, vecs = _layer_inputs(2, 2, 3, 9)
    with pytest.raises(ValueError, match="even lane width"):
        pgenc_layer(torch.from_numpy(x), torch.from_numpy(w2),
                    *map(torch.from_numpy, vecs))
    with pytest.raises(ValueError, match="even lane width"):
        fused_conv_bn_tanh_eval("dense", jnp.asarray(x), jnp.asarray(w2),
                                *map(jnp.asarray, vecs))


def _specs(cls):
    return (cls(1, 2, (1, 9), (1, 2), (0, 4), act="tanh"),
            cls(2, 4, (1, 9), (1, 2), (0, 4), act="tanh"),
            cls(4, 8, (1, 9), (1, 2), (0, 4), act="tanh"))


@pytest.fixture(scope="module")
def flax_stack():
    """A 3-layer flax ConvStack with running stats moved off their init by
    one train pass (pattern of tests/test_pallas_pgenc.py:68)."""
    x = np.random.default_rng(3).standard_normal((2, 1, 4, 64)).astype(
        np.float32)
    module = JaxConvStack(_specs(ConvSpec))
    variables = module.init(jax.random.PRNGKey(1), jnp.asarray(x))
    _, mut = module.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    variables = {"params": variables["params"],
                 "batch_stats": mut["batch_stats"]}
    want = np.asarray(module.apply(variables, jnp.asarray(x), train=False))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    return x, params, stats, want


@pytest.mark.parametrize("cls", [KernelConvStack1x9, ConvStack])
def test_stack_matches_flax_convstack(flax_stack, cls):
    x, params, stats, want = flax_stack
    port = cls(_specs(PortConvSpec)).eval()
    port.load_state_dict(from_flax(params, stats), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 4, 8)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_kernel_stack_w2_column_order(flax_stack):
    """w2 derived from the torch conv weight == layers.py:205-207 on the flax
    kernel."""
    _, params, stats, _ = flax_stack
    port = KernelConvStack1x9(_specs(PortConvSpec))
    port.load_state_dict(from_flax(params, stats))
    for i, spec in enumerate(port.specs):
        w = port.get_submodule(f"Conv_{i}").weight.detach()
        w2 = w[:, :, 0, :].permute(0, 2, 1).reshape(spec.out_ch,
                                                    9 * spec.in_ch)
        kernel = params[f"Conv_{i}"]["kernel"]  # [1, 9, Cin, Cout]
        want = kernel[0].reshape(9 * spec.in_ch, spec.out_ch).T
        np.testing.assert_array_equal(w2.numpy(), want)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    x, w2, vecs = _layer_inputs(4, 8, 64, 256)
    args = [torch.from_numpy(a).cuda() for a in (x, w2) + vecs]
    torch.testing.assert_close(pgenc_layer(*args, backend="kernel"),
                               pgenc_layer_plain(*args), atol=ATOL, rtol=0)


def tile_origins(plan: PgencPlan, r: int, s: int):
    """(c0, r0, s0) of every tile, in tile order, as pgenc_conv.cuh:tile_at
    numbers them (channel block first)."""
    n_sb = -(-(s // 2) // plan.bs)
    t = np.arange(plan.tiles, dtype=np.int64)
    cb, p = t // plan.per_cb, t % plan.per_cb
    return cb * plan.bc, (p // n_sb) * plan.br, (p % n_sb) * plan.bs


def test_flagship_layers_are_the_planned_encoder():
    cfg = RunConfig()
    specs, _ = plan_phasegram_encoder(
        (8, 1, cfg.num_frames, cfg.p_size ** 2), cfg.latent_chan, cfg.fc_size)
    widths = [cfg.p_size ** 2 >> i for i in range(len(specs))]
    assert tuple((sp.in_ch, sp.out_ch, w)
                 for sp, w in zip(specs, widths)) == FLAGSHIP


@pytest.mark.parametrize(
    "c,co,s,r", [(c, co, s, r) for c, co, s in FLAGSHIP for r in ROWS]
    + list(GATE))
def test_tile_plan_covers_every_output_once(c, co, s, r):
    """The tiles cut each axis (output channels, rows, positions) into
    blocks of the plan's size from 0, the last one reaching past the end,
    and every combination of blocks is exactly one tile: so every output
    lies in exactly one tile. The block fits the card, and the train
    forward's grid gives every block a run of tiles and every tile one
    block."""
    plan = pgenc_plan(c, r, s, co)
    assert plan == plan_of(c, r, s, co, *plan[:5])
    assert 32 <= plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    assert plan.smem <= _SMEM_LIMIT
    c0, r0, s0 = tile_origins(plan, r, s)
    blocks = []
    for starts, size, extent in ((c0, plan.bc, co), (r0, plan.br, r),
                                 (s0, plan.bs, s // 2)):
        first = np.unique(starts)
        assert np.array_equal(first, np.arange(len(first)) * size)
        assert first[-1] < extent <= first[-1] + size
        blocks.append(len(first))
    key = (c0 // plan.bc * blocks[1] + r0 // plan.br) * blocks[2] + (
        s0 // plan.bs)
    assert plan.tiles == np.prod(blocks)
    assert np.array_equal(np.sort(key), np.arange(plan.tiles))
    for resident in (132, 264, 1056):
        grid = train_grid(plan, resident)
        assert 1 <= grid <= min(resident, plan.tiles)
        runs = np.arange(grid + 1, dtype=np.int64) * plan.tiles // grid
        assert (np.diff(runs) >= 1).all() and runs[-1] == plan.tiles


def test_tile_plan_pinned_at_the_flagship_layers():
    """The plans PERF.md's per-layer chip measurements were taken at, R =
    64: (tc, bc, br, bs, g) for layers 0-9, 128 tiles each."""
    want = ((2, 2, 8, 128, 1), (4, 4, 4, 128, 1), (4, 8, 2, 128, 2),
            (4, 16, 1, 128, 2), (4, 16, 1, 128, 2), (4, 16, 2, 64, 2),
            (4, 8, 4, 32, 4), (4, 8, 4, 16, 8), (4, 8, 4, 8, 16),
            (4, 8, 4, 4, 32))
    plans = [pgenc_plan(c, 64, s, co) for c, co, s in FLAGSHIP]
    assert tuple(tuple(p[:5]) for p in plans) == want
    assert {p.tiles for p in plans} == {128}


@pytest.mark.parametrize("c,r,s,co", [(2, 4, 9, 2), (2, 4, 0, 2),
                                      (0, 4, 8, 2), (2, 0, 8, 2),
                                      (2, 4, 8, 0), (4096, 4, 8, 4)])
def test_tile_plan_refuses_bad_shapes(c, r, s, co):
    """An odd or empty width, an empty axis, or an input so wide that its
    smallest tile's stage does not fit the shared memory."""
    with pytest.raises(ValueError):
        pgenc_plan(c, r, s, co)


@pytest.mark.parametrize("tc,bc,br,bs,g", [(3, 6, 1, 4, 1), (4, 2, 1, 4, 1),
                                           (4, 64, 1, 4, 1),
                                           (4, 8, 3, 4, 1), (4, 8, 1, 6, 1),
                                           (4, 8, 1, 4, 16),
                                           (4, 16, 64, 16, 1)])
def test_plan_of_refuses_plans_the_kernels_do_not_take(tc, bc, br, bs, g):
    """tc not 2 or 4, bc not a multiple of tc or over MAX_BC, br or bs not
    a power of 2, more groups than input channels, more than MAX_THREADS
    threads."""
    with pytest.raises(ValueError):
        plan_of(8, 64, 256, 16, tc, bc, br, bs, g)
    with pytest.raises(ValueError, match="no block"):
        train_grid(PgencPlan(4, 8, 1, 4, 1, 32, 1024, 1, 1), 0)


def _gate_inputs(c, co, r, s, dtype, seed=5):
    x, w2, vecs = _layer_inputs(c, co, r, s, seed)
    dev = [torch.from_numpy(a).cuda() for a in (x, w2) + vecs]
    return [dev[0].to(dtype), dev[1].to(dtype)] + dev[2:]


def _at_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that starts one element into its storage."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("r", [64, 8192])
def test_kernel_contract_on_card(r):
    """Two calls give the same bits; x and w2 one element into their
    storage (the 4-byte copies) give the aligned call's bits; one call
    captured in a CUDA graph and replayed three times gives them too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode); "
                    "chip_smoke.py holds the same contract on the card")
    args = _gate_inputs(64, 64, r, 16, torch.float32)
    first = pgenc_layer(*args, backend="kernel")
    assert torch.equal(pgenc_layer(*args, backend="kernel"), first)
    shifted = [_at_offset(args[0]), _at_offset(args[1])] + args[2:]
    assert torch.equal(pgenc_layer(*shifted, backend="kernel"), first)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pgenc_layer(*args, backend="kernel")
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_ragged_shapes_on_card(dtype):
    """k2_gate's shapes against the plain version: 1e-5 absolute fp32,
    2^-7 bf16 (one bf16 rounding of y)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode); "
                    "chip_smoke.py's k2_gate runs these shapes")
    atol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for c, co, s, r in GATE:
        args = _gate_inputs(c, co, r, s, dtype)
        torch.testing.assert_close(
            pgenc_layer(*args, backend="kernel").float(),
            pgenc_layer_plain(*args).float(), atol=atol, rtol=0)
