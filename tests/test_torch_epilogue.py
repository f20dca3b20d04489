"""The port's fused BN + 2x2 max pool + LeakyReLU epilogue
(maavss_tpu_torch/ops/cuda_epilogue.py: the plain forward and explicit
backward, and the autograd Function around them) against the JAX package's
`fused_bn_phasemax_leaky` in interpret mode, on the same numpy inputs.

The port reads the conv output as NCDHW [B, C, T, H, W]; JAX reads it
space-to-depth folded, [B, T, H/2, W/2, 4C] with channel ph*C + c, ph =
2*py + px (layers.space_to_depth_2x2). The tests map one onto the other.

Tolerances are those of tests/test_pallas_epilogue.py:64-99: out and var
1e-5, mu 1e-6; the VJP (dy, dgamma, dbeta, with cotangents on out, mu and
var) rtol 2e-4, atol 2e-5. C in {16, 32}, the frames encoder's stage-0 and
stage-1 widths, with a third of gamma negative (the min branch).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.models.layers import space_to_depth_2x2
from maavss_tpu.ops import pallas_epilogue as jax_ep
from maavss_tpu.ops.pallas_epilogue import fused_bn_phasemax_leaky
from maavss_tpu_torch.ops.cuda_epilogue import (
    apply_plan,
    epilogue_apply,
    epilogue_apply_plain,
    epilogue_bwd_dy,
    epilogue_bwd_dy_plain,
    epilogue_bwd_reduce,
    epilogue_bwd_reduce_plain,
    epilogue_stats,
    epilogue_stats_plain,
    fused_bn_pool_leaky,
    fused_bn_pool_leaky_plain,
)
from tests.test_torch_workers import share_cores

share_cores()

SHAPE = (2, 3, 8, 12)  # B, T, H, W


def _inputs(c, seed, ties=False):
    rng = np.random.default_rng(seed)
    b, t, h, w = SHAPE
    y = rng.standard_normal((b, c, t, h, w)) * 0.7
    if ties:
        # a coarse grid: about a third of the 2x2 windows hold their max or
        # min more than once, so the gradient's routing decides the result
        y = np.round(y * 2.0) / 2.0
    g = rng.standard_normal(c) * 0.8
    g[: c // 3] = -np.abs(g[: c // 3]) - 0.1
    beta = rng.standard_normal(c) * 0.3
    return (y.astype(np.float32), g.astype(np.float32),
            beta.astype(np.float32))


def _to_jax(y):
    """NCDHW [B, C, T, H, W] -> JAX's phase-major [B, T, H/2, W/2, 4C]."""
    return space_to_depth_2x2(jnp.moveaxis(jnp.asarray(y), 1, -1))


def _from_jax_pooled(o):
    """[B, T, H/2, W/2, C] -> [B, C, T, H/2, W/2]."""
    return np.moveaxis(np.asarray(o), -1, 1)


def _from_jax_full(d):
    """Inverse of `_to_jax` on a gradient: [B, T, H/2, W/2, 4C] -> NCDHW."""
    b, t, h2, w2, c4 = d.shape
    c = c4 // 4
    d = np.asarray(d).reshape(b, t, h2, w2, 2, 2, c)
    d = d.transpose(0, 6, 1, 2, 4, 3, 5)  # b c t h2 py w2 px
    return d.reshape(b, c, t, 2 * h2, 2 * w2)


@pytest.mark.parametrize("c", [16, 32])
def test_forward_matches_jax(c):
    y, gamma, beta = _inputs(c, seed=c)
    out_j, mu_j, var_j = fused_bn_phasemax_leaky(_to_jax(y), gamma, beta)
    out, mu, var = fused_bn_pool_leaky(*map(torch.from_numpy,
                                            (y, gamma, beta)))
    np.testing.assert_allclose(mu.numpy(), mu_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), var_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), _from_jax_pooled(out_j),
                               rtol=1e-5, atol=1e-5)


def _vjp_case(c, seed, ties):
    y, gamma, beta = _inputs(c, seed, ties)
    b, t, h, w = SHAPE
    rng = np.random.default_rng(99 + seed)
    w_out = rng.standard_normal((b, c, t, h // 2, w // 2)).astype(np.float32)
    w_mu, w_var = (rng.standard_normal(c).astype(np.float32) for _ in range(2))

    def loss_j(yj, gm, bt):
        out, mu, var = fused_bn_phasemax_leaky(yj, gm, bt)
        return (jnp.sum(out * jnp.moveaxis(jnp.asarray(w_out), 1, -1))
                + jnp.sum(mu * w_mu) + jnp.sum(var * w_var))

    want = jax.grad(loss_j, argnums=(0, 1, 2))(_to_jax(y), gamma, beta)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (y, gamma, beta)]
    out, mu, var = fused_bn_pool_leaky(*leaves)
    (torch.sum(out * torch.from_numpy(w_out))
     + torch.sum(mu * torch.from_numpy(w_mu))
     + torch.sum(var * torch.from_numpy(w_var))).backward()
    got = [leaf.grad.numpy() for leaf in leaves]
    return got, [_from_jax_full(want[0]), np.asarray(want[1]),
                 np.asarray(want[2])], y


@pytest.mark.parametrize("c", [16, 32])
def test_full_vjp_matches_jax(c):
    got, want, _ = _vjp_case(c, seed=10 + c, ties=False)
    for a, b, name in zip(got, want, ("dy", "dgamma", "dbeta")):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=name)


def test_exact_ties_route_like_jax():
    """With about a third of the windows tied, the gradient of each window
    reaches the same (first-matching) phase in both packages."""
    got, want, y = _vjp_case(16, seed=3, ties=True)
    y4 = y.reshape(y.shape[:3] + (y.shape[3] // 2, 2, y.shape[4] // 2, 2))
    m = y4.max(axis=(4, 6), keepdims=True)
    assert ((y4 == m).sum(axis=(4, 6)) > 1).mean() > 0.2  # ties are common
    for a, b, name in zip(got, want, ("dy", "dgamma", "dbeta")):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=name)


def test_explicit_backward_matches_autograd_of_plain_forward():
    """Without ties, the explicit backward equals autograd through the plain
    forward (BN statistics with their own gradients, max/min pooling)."""
    y, gamma, beta = _inputs(16, seed=5)
    leaves = [torch.from_numpy(a).double().requires_grad_(True)
              for a in (y, gamma, beta)]
    rng = np.random.default_rng(6)
    w_out = torch.from_numpy(rng.standard_normal(
        (2, 16, 3, 4, 6)).astype(np.float32))

    def unfused(yy, gm, bt):
        mu = yy.mean(dim=(0, 2, 3, 4))
        var = (yy * yy).mean(dim=(0, 2, 3, 4)) - mu * mu
        z = ((yy - mu.view(1, -1, 1, 1, 1)) * torch.rsqrt(var + 1e-5).view(
            1, -1, 1, 1, 1) * gm.view(1, -1, 1, 1, 1) + bt.view(1, -1, 1, 1, 1))
        pooled = torch.nn.functional.max_pool3d(z, (1, 2, 2))
        return torch.nn.functional.leaky_relu(pooled, 0.01), mu, var

    out, mu, var = unfused(*leaves)
    (torch.sum(out * w_out.double()) + mu.sum() + 2.0 * var.sum()).backward()
    want = [leaf.grad.float() for leaf in leaves]
    leaves32 = [torch.from_numpy(a).requires_grad_(True)
                for a in (y, gamma, beta)]
    out32, mu32, var32 = fused_bn_pool_leaky(*leaves32)
    (torch.sum(out32 * w_out) + mu32.sum() + 2.0 * var32.sum()).backward()
    torch.testing.assert_close(out32, out.float(), rtol=1e-5, atol=1e-5)
    for leaf, w in zip(leaves32, want):
        torch.testing.assert_close(leaf.grad, w, rtol=2e-4, atol=2e-5)


def test_wrappers_take_plain_versions_on_cpu():
    y, gamma, beta = map(torch.from_numpy, _inputs(16, seed=7))
    counters = (epilogue_stats, epilogue_apply, epilogue_bwd_reduce,
                epilogue_bwd_dy)
    for c in counters:
        c.launches = 0
    mu, var, rstd = epilogue_stats(y)
    for a, b in zip((mu, var, rstd), epilogue_stats_plain(y)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    out, sel = epilogue_apply(y, gamma, beta, mu, rstd)
    g = torch.ones_like(out)
    z = torch.zeros(16)
    red = epilogue_bwd_reduce(g, sel, gamma, beta, mu, rstd, z, z)
    for a, b in zip(red, epilogue_bwd_reduce_plain(g, sel, gamma, beta, mu,
                                                   rstd, z, z)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dy = epilogue_bwd_dy(y, g, sel, gamma, beta, mu, rstd, red[2])
    torch.testing.assert_close(dy, epilogue_bwd_dy_plain(
        y, g, sel, gamma, beta, mu, rstd, red[2]), rtol=0, atol=0)
    assert [c.launches for c in counters] == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="even"):
        epilogue_stats(y[..., :11])


def test_plain_function_is_the_cpu_path():
    """`fused_bn_pool_leaky_plain`, the reference the kernels are held
    against on the card, is what `fused_bn_pool_leaky` runs on the CPU:
    the same outputs and gradients, bit for bit."""
    y, gamma, beta = _inputs(32, seed=9)
    results = []
    for fn in (fused_bn_pool_leaky, fused_bn_pool_leaky_plain):
        leaves = [torch.from_numpy(a).requires_grad_(True)
                  for a in (y, gamma, beta)]
        out, mu, var = fn(*leaves)
        (out.sum() + mu.sum() - var.sum()).backward()
        results.append([out, mu, var] + [t.grad for t in leaves])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_epilogue_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs this comparison on the card")
    y, gamma, beta = (torch.from_numpy(a).cuda()
                      for a in _inputs(32, seed=8, ties=True))
    mu, var, rstd = epilogue_stats(y)
    for a, b in zip((mu, var, rstd), epilogue_stats_plain(y)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    out, sel = epilogue_apply(y, gamma, beta, mu, rstd)
    out_p, sel_p = epilogue_apply_plain(y, gamma, beta, mu, rstd)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sel, sel_p, rtol=0, atol=0)
    g = torch.randn_like(out)
    gm, gv = torch.randn_like(mu), torch.randn_like(mu)
    red = epilogue_bwd_reduce(g, sel, gamma, beta, mu, rstd, gm, gv)
    red_p = epilogue_bwd_reduce_plain(g, sel, gamma, beta, mu, rstd, gm, gv)
    for a, b in zip(red, red_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    dy = epilogue_bwd_dy(y, g, sel, gamma, beta, mu, rstd, red_p[2])
    dy_p = epilogue_bwd_dy_plain(y, g, sel, gamma, beta, mu, rstd, red_p[2])
    torch.testing.assert_close(dy, dy_p, rtol=1e-5, atol=1e-5)


def _at_offset(t):
    """A contiguous copy of t that starts one element into its storage."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
def test_epilogue_kernels_take_unaligned_y_on_card():
    """A y one float into its storage (not 8- or 16-byte aligned) takes the
    stats, apply and bwd dy kernels' 4-byte loads instead of faulting: the
    same gates against the plain versions as the aligned test, and apply
    and dy (elementwise) give the aligned call's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs this comparison on the card")
    y, gamma, beta = (torch.from_numpy(a).cuda()
                      for a in _inputs(32, seed=9))
    yo = _at_offset(y)
    assert yo.data_ptr() % 8 != 0
    mu, var, rstd = epilogue_stats(yo)
    for a, b in zip((mu, var, rstd), epilogue_stats_plain(yo)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    out, sel = epilogue_apply(yo, gamma, beta, mu, rstd)
    out_p, sel_p = epilogue_apply_plain(yo, gamma, beta, mu, rstd)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sel, sel_p, rtol=0, atol=0)
    for a, b in zip((out, sel), epilogue_apply(y, gamma, beta, mu, rstd)):
        assert torch.equal(a, b)
    g = torch.randn_like(out)
    k = epilogue_bwd_reduce_plain(g, sel, gamma, beta, mu, rstd,
                                  torch.randn_like(mu), torch.randn_like(mu))[2]
    dy = epilogue_bwd_dy(yo, g, sel, gamma, beta, mu, rstd, k)
    dy_p = epilogue_bwd_dy_plain(yo, g, sel, gamma, beta, mu, rstd, k)
    torch.testing.assert_close(dy, dy_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(dy, epilogue_bwd_dy(y, g, sel, gamma, beta, mu, rstd,
                                           k))


# ------------------------------------------------ apply's plan, edge shapes

FLAGSHIP = [(8, 16, 8, 256, 256), (8, 32, 8, 128, 128)]  # stages 0 and 1


def _covered(shape, plan):
    """How many times the vector plan's threads take each pooled window of
    a plane, walking the kernel's loops (apply_vec_kernel) over the plane's
    blocks (grid.x is one plane each)."""
    h2, w2 = shape[3] // 2, shape[4] // 2
    hits = np.zeros((h2, w2), np.int64)
    bx, by = plan.block
    for row0 in range(0, plan.grid[1] * plan.band, plan.band):
        for ty in range(by):
            rows = range(row0 + ty, min(h2, row0 + plan.band), by)
            for tx in range(bx):
                for q in range(tx, w2 // 4, bx):
                    for r in rows:
                        hits[r, 4 * q:4 * q + 4] += 1
    return hits


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", FLAGSHIP + [(2, 3, 2, 2, 16),
                                              (2, 1, 2, 6, 16),
                                              (3, 5, 2, 4, 24),
                                              (1, 2, 1, 6, 2056)],
                         ids=["stage0", "stage1", "h2", "c1", "w24",
                              "w2056"])
def test_apply_plan_vector_path(shape, itemsize):
    """W/2 a multiple of 4 and every pointer aligned: the vector path, one
    block row of planes, blocks of at most 256 threads, and every window
    taken exactly once."""
    plan = apply_plan(shape, itemsize, 4096, 8192, 256)
    b, c, t, h, w = shape
    assert plan.windows == 4
    assert plan.grid[0] == b * c * t and plan.grid[1] <= 65535
    assert plan.block[0] * plan.block[1] <= 256
    assert plan.grid[1] * plan.band >= h // 2 > (plan.grid[1] - 1) * plan.band
    assert (_covered(shape, plan) == 1).all()


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("w", [2, 6, 18, 130])
def test_apply_plan_scalar_where_w2_is_not_a_multiple_of_4(w, itemsize):
    shape = (2, 3, 2, 6, w)
    plan = apply_plan(shape, itemsize, 4096, 8192, 256)
    assert plan.windows == 1 and plan.pairs
    assert plan.block == (256, 1) and plan.grid[1] == 1
    assert plan.grid[0] * 256 >= 2 * 3 * 2 * 3 * (w // 2)


@pytest.mark.parametrize("itemsize,y,out,sel,pairs", [
    (4, 4100, 8192, 256, False), (2, 4098, 8192, 256, False),
    (4, 4104, 8192, 256, True), (2, 4100, 8192, 256, True),
    (4, 4096, 8196, 256, True), (2, 4096, 8192, 258, True)],
    ids=["fp32_y_odd", "bf16_y_odd", "fp32_y_8B", "bf16_y_4B",
         "fp32_out_off", "bf16_sel_off"])
def test_apply_plan_scalar_off_alignment(itemsize, y, out, sel, pairs):
    """y off 16 bytes, or out or sel off 4 values, at the flagship's stage
    0: the scalar path, its pair loads only where y is aligned to two
    values."""
    plan = apply_plan(FLAGSHIP[0], itemsize, y, out, sel)
    assert plan.windows == 1 and plan.pairs == pairs


EDGE = (2, 3, 2, 6, 18)  # B, C, T, H, W: W/2 = 9, the scalar path's shape


def _edge_inputs():
    _, gamma, beta = _inputs(3, seed=21)
    rng = np.random.default_rng(22)
    b, c, t, h, w = EDGE
    y = (rng.standard_normal(EDGE) * 0.7).astype(np.float32)
    g_out = rng.standard_normal((b, c, t, h // 2, w // 2)).astype(np.float32)
    g_mu, g_var = (rng.standard_normal(c).astype(np.float32)
                   for _ in range(2))
    return y, gamma, beta, g_out, g_mu, g_var


@functools.lru_cache(maxsize=1)
def _jax_edge():
    """{"float32" | "bfloat16": (mu, rstd, out, sel, dgamma, dbeta)} of the
    JAX K5 (its stats, apply and backward pallas_calls, interpret mode) at
    EDGE, both IO dtypes in one jitted call; out and sel in the port's
    NCDHW layout."""
    y, gamma, beta, g_out, g_mu, g_var = _edge_inputs()
    b, c, t, h, w = EDGE

    def one(yy, gg):
        yr = _to_jax(yy).reshape(-1, 4 * c)
        mu, var = jax_ep._stats(yr, c)
        rstd = jax.lax.rsqrt(var + 1e-5)
        out, sel = jax_ep._apply(yr, mu, rstd, gamma, beta, c)
        _, dgamma, dbeta = jax_ep._fused_bwd(
            (yr, sel, mu, rstd, gamma, beta),
            (jnp.moveaxis(gg, 1, -1).reshape(-1, c), g_mu, g_var))
        return mu, rstd, out, sel, dgamma, dbeta

    def run(y32, g32):
        return {"float32": one(y32, g32),
                "bfloat16": one(y32.astype(jnp.bfloat16),
                                g32.astype(jnp.bfloat16))}

    res = jax.jit(run)(jnp.asarray(y), jnp.asarray(g_out))
    pooled = (b, t, h // 2, w // 2, c)
    return {k: tuple(np.asarray(a.astype(jnp.float32)) for a in v[:2])
            + tuple(_from_jax_pooled(a.astype(jnp.float32).reshape(pooled))
                    for a in v[2:4])
            + tuple(np.asarray(a) for a in v[4:])
            for k, v in res.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_apply_and_bwd_reduce_plain_match_jax_at_edge(dtype):
    """epilogue_apply_plain and epilogue_bwd_reduce_plain against the JAX
    kernels at EDGE (W/2 = 9), fed JAX's mu and rstd: sel exact, out at
    1e-5 (fp32) or one bf16 rounding, dgamma and dbeta at 1e-5 and k as
    _fused_bwd forms it."""
    y, gamma, beta, g_out, g_mu, g_var = _edge_inputs()
    mu, rstd, out_j, sel_j, dgamma_j, dbeta_j = _jax_edge()[
        str(dtype).split(".")[1]]
    t = torch.tensor
    yy, gg = t(y).to(dtype), t(g_out).to(dtype)
    out, sel = epilogue_apply_plain(yy, t(gamma), t(beta), t(mu), t(rstd))
    assert out.dtype == sel.dtype == dtype
    np.testing.assert_array_equal(sel.float().numpy(), sel_j)
    np.testing.assert_allclose(out.float().numpy(), out_j,
                               rtol=1e-5 if dtype == torch.float32
                               else 2.0 ** -7, atol=1e-6)
    dgamma, dbeta, k = epilogue_bwd_reduce_plain(
        gg, sel, t(gamma), t(beta), t(mu), t(rstd), t(g_mu), t(g_var))
    np.testing.assert_allclose(dgamma.numpy(), dgamma_j, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dbeta.numpy(), dbeta_j, rtol=1e-5, atol=1e-6)
    n = 4 * sel.numel() / sel.shape[1]
    np.testing.assert_allclose(k.numpy(), np.stack([
        gamma * dbeta_j / n, gamma * dgamma_j / n,
        g_mu / n - 2 * g_var * mu / n, 2 * g_var / n]), rtol=1e-5, atol=1e-7)


EDGE_CARD = [(2, 3, 2, 6, 2), (2, 3, 2, 6, 6), EDGE, (2, 3, 2, 6, 130),
             (2, 3, 2, 2, 16), (2, 1, 2, 6, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("odd", [False, True], ids=["aligned", "odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", EDGE_CARD,
                         ids=["w2", "w6", "w18", "w130", "h2", "c1"])
def test_apply_and_bwd_reduce_kernels_at_edges_on_card(shape, dtype, odd):
    """apply and bwd reduce at the edge shapes, y and g aligned or one
    element into their storage: sel exact, out within 1e-5 (one bf16
    rounding), dgamma, dbeta and k within 1e-4; two bwd reduce calls give
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py's K5 phases run these shapes on "
                    "the card")
    rng = np.random.default_rng(23)
    c = shape[1]
    y = torch.from_numpy((rng.standard_normal(shape) * 0.7).astype(
        np.float32)).cuda().to(dtype)
    g = torch.from_numpy(rng.standard_normal(
        shape[:3] + (shape[3] // 2, shape[4] // 2)).astype(
            np.float32)).cuda().to(dtype)
    if odd:
        y, g = _at_offset(y), _at_offset(g)
    gamma, beta, g_mu, g_var = (torch.from_numpy(rng.standard_normal(c)
                                                 .astype(np.float32)).cuda()
                                for _ in range(4))
    mu, _, rstd = epilogue_stats(y)
    out, sel = epilogue_apply(y, gamma, beta, mu, rstd)
    out_p, sel_p = epilogue_apply_plain(y, gamma, beta, mu, rstd)
    assert torch.equal(sel, sel_p)
    torch.testing.assert_close(out.float(), out_p.float(), atol=1e-6,
                               rtol=1e-5 if dtype == torch.float32
                               else 2.0 ** -7)
    args = (g, sel, gamma, beta, mu, rstd, g_mu, g_var)
    red = epilogue_bwd_reduce(*args)
    for a, b in zip(red, epilogue_bwd_reduce_plain(*args)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    for a, b in zip(red, epilogue_bwd_reduce(*args)):
        assert torch.equal(a, b)
