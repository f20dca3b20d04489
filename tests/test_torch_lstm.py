"""The port's LSTM recurrence (ops/cuda_lstm.py), its BPTT and BiLSTM
against the JAX package: the Pallas kernel `_forward` and `pallas_lstm`'s
custom VJP in interpret mode, and flax's lax.scan LSTM
(maavss_tpu/models/layers.py:722-737) under jax.grad, both directions,
fp32, on the same numpy inputs. Tolerance 1e-5 absolute (h and c are O(1);
only the summation order of h @ w_h differs), relative to the largest entry
for the weight gradients (sums over B*T terms)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.models.layers import BiLSTM as JaxBiLSTM
from maavss_tpu.ops.pallas_lstm import _forward as pallas_forward
from maavss_tpu.ops.pallas_lstm import pallas_lstm
from maavss_tpu_torch.models.layers import BiLSTM, lstm_backend
from maavss_tpu_torch.ops.cuda_lstm import (
    CLUSTER,
    CLUSTERS_AT_ONCE,
    H_MAX,
    SMEM_MAX,
    lstm_bidir,
    lstm_geometry,
    lstm_recurrence,
    lstm_recurrence_bwd,
    lstm_recurrence_bwd_plain,
    lstm_recurrence_plain,
)
from tests.test_torch_workers import share_cores

share_cores()

ATOL = 1e-5
B, T, D, H = 2, 5, 24, 256  # H is the fusion model's fixed 256


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    w_h = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return xw, w_h


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_recurrence_matches_pallas_interpret(reverse):
    xw, w_h = _inputs()
    ys, cs, _ = lstm_recurrence_plain(torch.from_numpy(xw),
                                      torch.from_numpy(w_h), reverse=reverse)
    # the JAX kernel is time-major and forward only; the reverse direction
    # is the flip around it (layers.py:704-705,718-719)
    xw_tm = np.swapaxes(xw, 0, 1)
    if reverse:
        xw_tm = xw_tm[::-1]
    ys_j, cs_j = pallas_forward(jnp.asarray(np.ascontiguousarray(xw_tm)),
                                jnp.asarray(w_h))
    ys_j, cs_j = np.asarray(ys_j), np.asarray(cs_j)
    if reverse:
        ys_j, cs_j = ys_j[::-1], cs_j[::-1]
    np.testing.assert_allclose(ys.numpy(), np.swapaxes(ys_j, 0, 1), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(cs.numpy(), np.swapaxes(cs_j, 0, 1), atol=ATOL,
                               rtol=0)


def test_bilstm_matches_flax_scan():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    module = JaxBiLSTM(H)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAAVSS_LSTM", "scan")
        want = np.asarray(module.apply(variables, jnp.asarray(x)))
    port = BiLSTM(D, H)
    with torch.no_grad():
        for name in ("fwd", "bwd"):
            getattr(port, name).w_i.copy_(torch.tensor(params[name]["w_i"]))
            getattr(port, name).w_h.copy_(torch.tensor(params[name]["w_h"]))
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_forward_saves_gate_activations(reverse):
    """The saved acts are sigmoid/tanh(xw + h_prev @ w_h) with h_prev the
    forward's own ys of the step before (0 at its first step)."""
    xw, w_h = (torch.from_numpy(a) for a in _inputs(8))
    ys, _, acts = lstm_recurrence_plain(xw, w_h, reverse)
    assert acts.dtype == torch.float32 and acts.shape == (B, T, 4 * H)
    for t in range(T):
        tp = t + 1 if reverse else t - 1
        h_prev = ys[:, tp] if 0 <= tp < T else torch.zeros(B, H)
        i, f, g, o = (xw[:, t] + h_prev @ w_h).chunk(4, dim=-1)
        want = torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o)], dim=-1)
        torch.testing.assert_close(acts[:, t], want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 32, 256])
def test_geometry_fits_the_card(b, dtype):
    """At the system's H = 256: every CTA's shared memory under the 227 KB
    a block may use, one cluster per (direction, rows), every batch row
    covered; at B <= 32 every CTA on an SM of its own (132 SMs)."""
    geo = lstm_geometry(b, 256, dtype)
    assert max(geo.fwd_smem, geo.bwd_smem) <= SMEM_MAX == 227 * 1024
    assert geo.rows in (1, 2, 4, 8) and CLUSTER == 16
    assert geo.groups == -(-b // geo.rows)
    # the forward's 16*U = H threads and the backward's H, U = H / 16
    # units a CTA: 64 KB of w_h columns, rows padded by 4 floats
    assert geo.fwd_smem >= 256 * (64 + 4) * 4 and geo.bwd_smem >= 256 * 68 * 4
    if b <= 32:
        assert 2 * geo.groups * CLUSTER <= 132


@pytest.mark.parametrize("b,rows", [(1, 1), (3, 1), (4, 2), (6, 2), (8, 4),
                                    (9, 4), (12, 4), (13, 8), (24, 8),
                                    (32, 8), (256, 8)])
def test_geometry_rows_per_batch(b, rows):
    """Rows per cluster at H = 256, two directions: the fewest whose
    clusters the card runs side by side (7 on an H100 SXM, one CTA an SM),
    8 beyond that. chip_smoke.py and the card tests below hold each of the
    four kernel instantiations."""
    assert CLUSTERS_AT_ONCE == 7
    geo = lstm_geometry(b, 256)
    assert (geo.rows, geo.groups) == (rows, -(-b // rows))
    if b <= 24:
        assert 2 * geo.groups <= CLUSTERS_AT_ONCE
    # one direction, or a card that runs more clusters at once, takes
    # fewer rows a cluster
    assert lstm_geometry(b, 256, n_dir=1).rows <= rows
    assert lstm_geometry(b, 256, clusters=16).rows <= rows


def test_geometry_limits():
    """H up to H_MAX = 448 fits (fewer rows per cluster there); above it,
    or off a multiple of 32, the helper raises with the limit, and a dtype
    other than float32, bfloat16 and float16 raises (the three IO types
    share one geometry: w_h's slices are fp32 in shared memory). The
    kernels never take the plain version instead."""
    geo = lstm_geometry(32, H_MAX)
    assert max(geo.fwd_smem, geo.bwd_smem) <= SMEM_MAX and geo.rows < 8
    for h in (H_MAX + 32, 512, 100, 16):
        with pytest.raises(ValueError, match=str(H_MAX)):
            lstm_geometry(8, h)
    assert lstm_geometry(8, 256, torch.float16) == lstm_geometry(8, 256) \
        == lstm_geometry(8, 256, torch.bfloat16)
    with pytest.raises(TypeError):
        lstm_geometry(8, 256, torch.float64)


def test_forward_saves_gate_activations_only_for_a_gradient():
    """`save_acts=False` returns None for acts and the same ys and cs;
    lstm_bidir asks for them only where grad mode is on and an input
    requires a gradient, and gives the same ys either way."""
    xw, w_h = (torch.from_numpy(a) for a in _inputs(9))
    (ys, cs, acts), = lstm_recurrence([xw], [w_h], [True], save_acts=False)
    want = lstm_recurrence_plain(xw, w_h, True)
    assert acts is None
    torch.testing.assert_close(ys, want[0], atol=0, rtol=0)
    torch.testing.assert_close(cs, want[1], atol=0, rtol=0)
    with torch.no_grad():
        eval_ys = lstm_bidir(xw, xw, w_h, w_h)
    w_g = w_h.clone().requires_grad_(True)
    train_ys = lstm_bidir(xw, xw, w_g, w_g)
    for a, b in zip(eval_ys, train_ys):
        torch.testing.assert_close(a, b.detach(), atol=0, rtol=0)
    assert train_ys[0].grad_fn is not None and eval_ys[0].grad_fn is None


def test_backend_gate():
    x = torch.zeros(1)
    assert lstm_backend(x) in ("scan", "kernel")
    assert lstm_backend(x, "auto") == "scan"  # a CPU tensor
    assert lstm_backend(x, "kernel") == "kernel"
    with pytest.raises(ValueError):
        lstm_backend(x, "pallas")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    xw, w_h = _inputs(2)
    xws = [torch.from_numpy(xw).cuda()] * 2
    whs = [torch.from_numpy(w_h).cuda()] * 2
    got = lstm_recurrence(xws, whs, [False, True], backend="kernel")
    for (ys, cs, acts), rev in zip(got, (False, True)):
        ys_p, cs_p, acts_p = lstm_recurrence_plain(xws[0], whs[0], rev)
        torch.testing.assert_close(ys, ys_p, atol=ATOL, rtol=0)
        torch.testing.assert_close(cs, cs_p, atol=ATOL, rtol=0)
        torch.testing.assert_close(acts, acts_p, atol=ATOL, rtol=0)


def _card_inputs(b, t_len, dtype, seed, h=H):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xws = [torch.randn(b, t_len, 4 * h, device="cuda", generator=g).to(dtype)
           for _ in range(2)]
    whs = [(torch.randn(h, 4 * h, device="cuda", generator=g) / 16).to(dtype)
           for _ in range(2)]
    dys = [torch.randn(b, t_len, h, device="cuda", generator=g).to(dtype)
           for _ in range(2)]
    return xws, whs, dys


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t_len,h", [(8, 8, 256), (32, 8, 256),
                                       (8, 16, 256), (256, 8, 256),
                                       (2, 8, 256), (4, 8, 256),
                                       (8, 8, 448), (12, 8, 96)])
def test_cluster_kernels_at_card_shapes(b, t_len, h, dtype):
    """Both kernels at the main path's shapes (fusion B 8 and 32, frames'
    T 16, bench.py's B 256: four and eight rows per cluster), at B 2 and 4
    (one and two rows, so every instantiation is held), at the largest H
    and at an H whose slice is loaded one value at a time, against the
    plain versions at chip_smoke's tolerances; two calls of each give the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs this comparison on the card")
    xws, whs, dys = _card_inputs(b, t_len, dtype, b + t_len, h)
    rev = [False, True]
    fp32 = dtype == torch.float32
    tol = 1e-5 if fp32 else 2.0 ** -7
    fwd = lstm_recurrence(xws, whs, rev, backend="kernel")
    again = lstm_recurrence(xws, whs, rev, backend="kernel")
    for k in range(2):
        want = lstm_recurrence_plain(xws[k], whs[k], rev[k])
        for got, rep, ref in zip(fwd[k], again[k], want):
            assert torch.equal(got, rep)
            torch.testing.assert_close(got.float(), ref.float(), atol=1e-5,
                                       rtol=tol)
    args = ([f[2] for f in fwd], whs, [f[0] for f in fwd],
            [f[1] for f in fwd], dys, rev)
    bwd = lstm_recurrence_bwd(*args, backend="kernel")
    again = lstm_recurrence_bwd(*args, backend="kernel")
    for k in range(2):
        want = lstm_recurrence_bwd_plain(*(a[k] for a in args))
        for got, rep, ref, rel in zip(bwd[k], again[k], want,
                                      (1e-5, 1e-4) if fp32 else (tol, tol)):
            assert torch.equal(got, rep)
            scale = ref.abs().max().item()
            atol = 1e-5 if fp32 and rel == 1e-5 else rel * scale
            torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                       rtol=rel)


def _bwd_inputs(seed=3):
    rng = np.random.default_rng(seed)
    xw, w_h = _inputs(seed)
    dys = rng.standard_normal((B, T, H)).astype(np.float32)
    return xw, w_h, dys


def _jax_vjp(xw, w_h, dys, reverse):
    """jax.vjp of the Pallas LSTM (interpret) in the port's batch-major
    layout; the reverse direction is flip / vjp / flip as
    maavss_tpu/models/layers.py:704-705,718-719 runs it."""
    def f(xw_bm, wh):
        xw_tm = jnp.swapaxes(xw_bm, 0, 1)
        if reverse:
            xw_tm = jnp.flip(xw_tm, 0)
        ys = pallas_lstm(xw_tm, wh)
        if reverse:
            ys = jnp.flip(ys, 0)
        return jnp.swapaxes(ys, 0, 1)

    _, vjp = jax.vjp(f, jnp.asarray(xw), jnp.asarray(w_h))
    return [np.asarray(g) for g in vjp(jnp.asarray(dys))]


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_bptt_matches_pallas_vjp(reverse):
    """The explicit BPTT against jax.vjp of `pallas_lstm`; dW_h is a sum of
    B*T terms, so it is held to 1e-5 of its largest entry."""
    xw, w_h, dys = _bwd_inputs()
    dxw_j, dwh_j = _jax_vjp(xw, w_h, dys, reverse)
    ys, cs, acts = lstm_recurrence_plain(torch.from_numpy(xw),
                                         torch.from_numpy(w_h), reverse)
    dxw, dwh = lstm_recurrence_bwd_plain(
        acts, torch.from_numpy(w_h), ys, cs, torch.from_numpy(dys), reverse)
    np.testing.assert_allclose(dxw.numpy(), dxw_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dwh.numpy(), dwh_j,
                               atol=ATOL * np.abs(dwh_j).max(), rtol=0)


def test_function_backward_matches_pallas_vjp():
    """`lstm_bidir` on CPU tensors (the autograd Function with its plain
    bodies): both directions, gradients in argument order."""
    xw, w_h, dys = _bwd_inputs(4)
    xw_b, w_hb, dys_b = _bwd_inputs(5)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (xw, xw_b, w_h, w_hb)]
    lstm_recurrence_bwd.launches = 0
    ys_f, ys_b = lstm_bidir(*leaves)
    torch.autograd.backward([ys_f, ys_b], [torch.from_numpy(dys),
                                           torch.from_numpy(dys_b)])
    assert lstm_recurrence_bwd.launches == 0  # plain bodies on the CPU
    for (x_, wh_, d_), rev, (gx, gw) in (
            ((xw, w_h, dys), False, (leaves[0], leaves[2])),
            ((xw_b, w_hb, dys_b), True, (leaves[1], leaves[3]))):
        dxw_j, dwh_j = _jax_vjp(x_, wh_, d_, rev)
        np.testing.assert_allclose(gx.grad.numpy(), dxw_j, atol=ATOL, rtol=0)
        np.testing.assert_allclose(gw.grad.numpy(), dwh_j,
                                   atol=ATOL * np.abs(dwh_j).max(), rtol=0)


def test_bilstm_grads_match_flax_scan():
    """BiLSTM's gradients (x, w_i and w_h of both directions) against
    jax.grad through flax's scan LSTM, with the port's per-step loop under
    autograd ('scan') and with the autograd Function (its plain bodies on
    the CPU)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    cot = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    module = JaxBiLSTM(H)
    variables = module.init(jax.random.PRNGKey(2), jnp.asarray(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAAVSS_LSTM", "scan")
        g_params, g_x = jax.grad(
            lambda p, xin: jnp.sum(module.apply({"params": p}, xin)
                                   * jnp.asarray(cot)),
            argnums=(0, 1))(variables["params"], jnp.asarray(x))
    g_params = jax.tree_util.tree_map(np.asarray, g_params)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    port = BiLSTM(D, H, backend="scan")
    with torch.no_grad():
        for name in ("fwd", "bwd"):
            getattr(port, name).w_i.copy_(torch.tensor(params[name]["w_i"]))
            getattr(port, name).w_h.copy_(torch.tensor(params[name]["w_h"]))
    for path in ("scan", "function"):
        port.zero_grad(set_to_none=True)
        xin = torch.from_numpy(x).requires_grad_(True)
        if path == "scan":
            out = port(xin)
        else:  # the kernel path's Function, on CPU tensors
            ys_f, ys_b = lstm_bidir(xin @ port.fwd.w_i, xin @ port.bwd.w_i,
                                    port.fwd.w_h, port.bwd.w_h)
            out = torch.cat([ys_f, ys_b], dim=-1)
        (out * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(xin.grad.numpy(), np.asarray(g_x),
                                   atol=ATOL, rtol=0, err_msg=path)
        for name in ("fwd", "bwd"):
            for leaf in ("w_i", "w_h"):
                want = g_params[name][leaf]
                got = getattr(getattr(port, name), leaf).grad.numpy()
                np.testing.assert_allclose(
                    got, want, atol=ATOL * np.abs(want).max(), rtol=0,
                    err_msg=f"{path} {name}.{leaf}")


@pytest.mark.cuda
def test_bwd_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    xw, w_h, dys = _bwd_inputs(7)
    xws = [torch.from_numpy(xw).cuda()] * 2
    whs = [torch.from_numpy(w_h).cuda()] * 2
    dyss = [torch.from_numpy(dys).cuda()] * 2
    fwd = lstm_recurrence(xws, whs, [False, True], backend="kernel")
    got = lstm_recurrence_bwd([f[2] for f in fwd], whs, [f[0] for f in fwd],
                              [f[1] for f in fwd], dyss, [False, True],
                              backend="kernel")
    for (dxw, dwh), (ys, cs, acts), rev in zip(got, fwd, (False, True)):
        dxw_p, dwh_p = lstm_recurrence_bwd_plain(acts, whs[0], ys, cs,
                                                 dyss[0], rev)
        torch.testing.assert_close(dxw, dxw_p, atol=ATOL, rtol=1e-5)
        torch.testing.assert_close(dwh, dwh_p, atol=1e-4 * dwh_p.abs().max(),
                                   rtol=1e-4)
