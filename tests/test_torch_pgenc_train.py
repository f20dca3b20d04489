"""The port's train-mode phasegram-encoder layer (ops/cuda_pgenc.py: the
plain forward and backward, and the autograd Function around them) and the
train-mode stacks (KernelConvStack1x9 and ConvStack in `.train()`) against
the JAX package, on the same numpy inputs:

- `fused_conv_bn_tanh_train` and its custom VJP in interpret mode;
- flax's ConvStack(train=True) on converted weights: outputs, updated
  running statistics and gradients.

fp32. Tolerances: 2e-5 absolute on tanh outputs (conv and statistics sums in
another order); batch statistics and gradients 1e-4 relative to each
tensor's largest entry (sums over up to R*S/2 terms). The conv bias's
gradient is exactly 0 from the fused layer (the JAX kernel's too); flax's
autodiff returns float noise there (a few 1e-6 here), so the stacks'
conv-bias gradients are held to 1e-4 of the same layer's largest kernel
gradient instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.models.layers import ConvStack as JaxConvStack
from maavss_tpu.models.shape_plan import ConvSpec
from maavss_tpu.ops.pallas_pgenc import fused_conv_bn_tanh_train
from maavss_tpu_torch.convert import flatten_tree, from_flax, to_flax
from maavss_tpu_torch.models.layers import ConvStack, KernelConvStack1x9
from maavss_tpu_torch.models.shape_plan import ConvSpec as PortConvSpec
from maavss_tpu_torch.ops.cuda_pgenc import (
    _resident_blocks,
    _train_launch,
    pgenc_bwd,
    pgenc_bwd_plain,
    pgenc_layer_train,
    pgenc_plan,
    pgenc_train,
    pgenc_train_plain,
)
from tests.test_torch_workers import share_cores

share_cores()

ATOL = 2e-5
GRAD_RTOL = 1e-4


def _inputs(c, co, r, s, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, r, s)).astype(np.float32)
    w2 = (rng.standard_normal((co, 9 * c)) / (3 * np.sqrt(c))).astype(
        np.float32)
    cbias, beta = (rng.standard_normal(co).astype(np.float32) * 0.1
                   for _ in range(2))
    gamma = (1.0 + 0.2 * rng.standard_normal(co)).astype(np.float32)
    dy = rng.standard_normal((co, r, s // 2)).astype(np.float32)
    return x, w2, (cbias, gamma, beta), dy


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=GRAD_RTOL * scale, rtol=0,
                               err_msg=what)


def _jax_vjp(x, w2, vecs, dy):
    (y, mu, var), vjp = jax.vjp(
        lambda *a: fused_conv_bn_tanh_train("dense", *a),
        jnp.asarray(x), jnp.asarray(w2), *map(jnp.asarray, vecs))
    grads = vjp((jnp.asarray(dy), jnp.zeros_like(mu), jnp.zeros_like(var)))
    return (y, mu, var), grads


@pytest.mark.parametrize("c,co,s", [(1, 2, 64), (4, 8, 16), (8, 8, 8)])
def test_plain_train_layer_matches_pallas_interpret(c, co, s):
    x, w2, vecs, dy = _inputs(c, co, 6, s)
    (y_j, mu_j, var_j), grads_j = _jax_vjp(x, w2, vecs, dy)
    t = [torch.from_numpy(a) for a in (x, w2) + vecs]
    y, mu, var, yc = pgenc_train_plain(*t)
    assert y.shape == yc.shape == (co, 6, s // 2)
    assert yc.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=ATOL, rtol=0)
    _close(mu.numpy(), mu_j, "mu")
    _close(var.numpy(), var_j, "var")
    # the backward from the forward's yc, as the fused layer saves it
    grads = pgenc_bwd_plain(t[0], t[1], yc, *t[3:], mu, var,
                            torch.from_numpy(dy))
    for name, g, gj in zip(("dx", "dw2", "dcbias", "dgamma", "dbeta"), grads,
                           grads_j):
        _close(g.numpy(), gj, name)
    assert not grads[2].any() and not np.asarray(grads_j[2]).any()


@pytest.mark.parametrize("c,co,s", [(1, 2, 64), (4, 8, 16)])
def test_function_backward_matches_pallas_vjp(c, co, s):
    """The autograd Function on CPU tensors (its plain bodies): saved
    tensors, gradient order, mu/var without gradient, dcbias exactly 0."""
    x, w2, vecs, dy = _inputs(c, co, 6, s, seed=1)
    (y_j, _, _), grads_j = _jax_vjp(x, w2, vecs, dy)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w2) + vecs]
    y, mu, var = pgenc_layer_train(*leaves)
    assert not mu.requires_grad and not var.requires_grad
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=ATOL,
                               rtol=0)
    y.backward(torch.from_numpy(dy))
    for name, leaf, gj in zip(("dx", "dw2", "dcbias", "dgamma", "dbeta"),
                              leaves, grads_j):
        _close(leaf.grad.numpy(), gj, name)
    assert torch.count_nonzero(leaves[2].grad) == 0


def test_wrappers_take_plain_path_on_cpu():
    x, w2, vecs, dy = _inputs(2, 4, 5, 16, seed=2)
    t = [torch.from_numpy(a) for a in (x, w2) + vecs]
    pgenc_train.launches = pgenc_bwd.launches = 0
    got = pgenc_train(*t)
    for a, b in zip(got, pgenc_train_plain(*t)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    y, mu, var, yc = got
    args = (t[0], t[1], yc, *t[3:], mu, var, torch.from_numpy(dy))
    g = pgenc_bwd(*args)
    for a, b in zip(g, pgenc_bwd_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert pgenc_train.launches == 0 and pgenc_bwd.launches == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        pgenc_train(*t, backend="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        pgenc_bwd(*args, backend="kernel")


def test_double_backward_repeats_and_keeps_yc():
    """Under retain_graph a second backward through the fused layer gives
    the same gradients bit for bit: the saved yc is read, never written."""
    x, w2, vecs, dy = _inputs(2, 4, 5, 16, seed=4)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w2) + vecs]
    y, _, _ = pgenc_layer_train(*leaves)
    d = torch.from_numpy(dy)
    first = torch.autograd.grad(y, leaves, d, retain_graph=True)
    second = torch.autograd.grad(y, leaves, d)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.count_nonzero(first[2]) == 0


def test_odd_width_raises_like_jax():
    x, w2, vecs, _ = _inputs(2, 2, 3, 9)
    with pytest.raises(ValueError, match="even lane width"):
        pgenc_layer_train(*[torch.from_numpy(a) for a in (x, w2) + vecs])
    with pytest.raises(ValueError, match="even lane width"):
        fused_conv_bn_tanh_train("dense", jnp.asarray(x), jnp.asarray(w2),
                                 *map(jnp.asarray, vecs))


def _specs(cls):
    return (cls(1, 2, (1, 9), (1, 2), (0, 4), act="tanh"),
            cls(2, 4, (1, 9), (1, 2), (0, 4), act="tanh"),
            cls(4, 8, (1, 9), (1, 2), (0, 4), act="tanh"))


@pytest.fixture(scope="module")
def flax_train():
    """flax ConvStack(train=True): output, updated batch_stats, and the
    gradients of sum(out * cot) w.r.t. the params and the input."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 4, 64)).astype(np.float32)
    cot = rng.standard_normal((2, 8, 4, 8)).astype(np.float32)
    module = JaxConvStack(_specs(ConvSpec))
    variables = module.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # move the running stats and the BN affine off their init
    _, mut = module.apply(variables, jnp.asarray(x) * 0.5 + 0.1, train=True,
                          mutable=["batch_stats"])
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)),
        variables["params"])

    def loss(params, xin):
        out, m = module.apply({"params": params,
                               "batch_stats": mut["batch_stats"]}, xin,
                              train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, m["batch_stats"])

    (_, (out, stats)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tree = jax.tree_util.tree_map(np.asarray, {
        "params": params, "batch_stats": mut["batch_stats"],
        "out": out, "new_stats": stats, "g_params": g_params})
    return x, cot, tree, np.asarray(g_x)


@pytest.mark.parametrize("cls", [KernelConvStack1x9, ConvStack])
def test_train_stack_matches_flax(flax_train, cls):
    x, cot, tree, g_x = flax_train
    port = cls(_specs(PortConvSpec)).train()
    port.load_state_dict(from_flax(tree["params"], tree["batch_stats"]),
                         strict=True)
    xin = torch.from_numpy(x).requires_grad_(True)
    out = port(xin)
    np.testing.assert_allclose(out.detach().numpy(), tree["out"], atol=ATOL,
                               rtol=0)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(xin.grad.numpy(), g_x, "dx")
    grads = {n: p.grad for n, p in port.named_parameters()}
    g_params, _ = to_flax(grads)
    g_flat, want = flatten_tree(g_params), flatten_tree(tree["g_params"])
    assert set(g_flat) == set(want)
    for path, w in want.items():
        if path.endswith("/bias") and path.startswith("Conv_"):
            # true gradient 0: the fused layer gives 0, autodiff noise
            scale = np.abs(want[path.replace("/bias", "/kernel")]).max()
            np.testing.assert_allclose(g_flat[path], w,
                                       atol=GRAD_RTOL * scale, rtol=0,
                                       err_msg=path)
            if cls is KernelConvStack1x9:
                assert not g_flat[path].any()
            continue
        _close(g_flat[path], w, path)
    _, stats = to_flax(port.state_dict())
    got_stats, want_stats = flatten_tree(stats), flatten_tree(
        tree["new_stats"])
    for path, w in want_stats.items():
        _close(got_stats[path], w, path)


@pytest.mark.cuda
def test_train_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs this comparison on the card")
    x, w2, vecs, dy = _inputs(4, 8, 64, 256)
    t = [torch.from_numpy(a).cuda() for a in (x, w2) + vecs]
    y, mu, var, yc = pgenc_train(*t, backend="kernel")
    for a, b in zip((y, mu, var, yc), pgenc_train_plain(*t)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=1e-4)
    args = (t[0], t[1], yc, *t[3:], mu, var, torch.from_numpy(dy).cuda())
    got = pgenc_bwd(*args, backend="kernel")
    want = pgenc_bwd_plain(*args)
    assert torch.count_nonzero(got[2]) == 0
    for a, b in zip(got, want):
        _close(a.cpu().numpy(), b.cpu().numpy(), "grad")
    # fixed-order sums: a second call gives the same bits
    for a, b in zip(got, pgenc_bwd(*args, backend="kernel")):
        assert torch.equal(a, b)


def _at_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that starts one element into its storage."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_takes_unaligned_views_on_card(dtype):
    """x, w2, yc and dy at an odd offset take the backward's one-value
    copies instead of its 16-byte ones. The copies do not change the sums:
    x and w2 at an offset give the aligned call's bits; with yc and dy too
    (the BN sums then take one value a thread) it still matches the plain
    version at chip_smoke's K2-bwd tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs the aligned comparison")
    x, w2, vecs, dy = _inputs(4, 8, 64, 256)
    t = [torch.from_numpy(a).cuda() for a in (x, w2) + vecs]
    t[0], t[1] = t[0].to(dtype), t[1].to(dtype)
    _, mu, var, yc = pgenc_train(*t, backend="kernel")
    dy = torch.from_numpy(dy).cuda().to(dtype)
    args = [t[0], t[1], yc, *t[3:], mu, var, dy]
    aligned = pgenc_bwd(*args, backend="kernel")
    want = pgenc_bwd_plain(*args)
    for i in (0, 1, 2, 7):  # x, w2, then yc, dy
        args[i] = _at_offset(args[i])
        assert args[i].data_ptr() % 8 != 0
        if i == 1:
            for a, b in zip(pgenc_bwd(*args, backend="kernel"), aligned):
                assert torch.equal(a, b)
    got = pgenc_bwd(*args, backend="kernel")
    assert torch.count_nonzero(got[2]) == 0
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, atol=tol * scale, rtol=tol)


def _card_inputs(c, co, r, s, dtype, seed=6):
    x, w2, vecs, _ = _inputs(c, co, r, s, seed)
    dev = [torch.from_numpy(a).cuda() for a in (x, w2) + vecs]
    return [dev[0].to(dtype), dev[1].to(dtype)] + dev[2:]


@pytest.mark.cuda
@pytest.mark.parametrize("r", [64, 8192])
def test_train_forward_contract_on_card(r):
    """The one-launch forward: two calls give the same bits (y, mu, var,
    yc); x and w2 one element into their storage (the 4-byte copies) give
    the aligned call's bits; one call captured in a CUDA graph and replayed
    three times gives them too (the launch leaves no counter to reset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py holds the same contract")
    args = _card_inputs(64, 64, r, 16, torch.float32)
    first = pgenc_train(*args, backend="kernel")
    shifted = [_at_offset(args[0]), _at_offset(args[1])] + args[2:]
    for again in (pgenc_train(*args, backend="kernel"),
                  pgenc_train(*shifted, backend="kernel")):
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pgenc_train(*args, backend="kernel")
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, first))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_forward_ragged_shapes_on_card(dtype):
    """chip_smoke's k2_gate shapes (C = 3 -> Co = 5, R in {1, 3, 17, 2048,
    8192}, S in {2, 6, 4098}) against the plain version at k2_train's
    tolerances: y 2e-5 fp32 / 2^-7 bf16 absolute, mu and var 1e-5 + 1e-4
    relative, yc 1e-5 of its largest entry + 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py's k2_gate runs these shapes")
    tol = ATOL if dtype == torch.float32 else 2.0 ** -7
    for r in (1, 3, 17, 2048, 8192):
        for s in (2, 6, 4098):
            args = _card_inputs(3, 5, r, s, dtype)
            y, mu, var, yc = pgenc_train(*args, backend="kernel")
            y_r, mu_r, var_r, yc_r = pgenc_train_plain(*args)
            torch.testing.assert_close(y.float(), y_r.float(), atol=tol,
                                       rtol=0)
            for a, b in ((mu, mu_r), (var, var_r)):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
            torch.testing.assert_close(
                yc, yc_r, atol=1e-5 * yc_r.abs().max().item(), rtol=1e-4)


@pytest.mark.cuda
def test_train_forward_refuses_a_grid_over_the_resident_blocks_on_card():
    """A cooperative grid one block over what the card keeps resident
    raises; the forward does not run it another way."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py's k2_gate makes the same check")
    args = _card_inputs(1, 2, 8192, 4096, torch.float32)
    plan = pgenc_plan(1, 8192, 4096, 2)
    resident = _resident_blocks(args[0].device.index, plan.tc, 0,
                                plan.threads, plan.smem)
    assert plan.tiles > resident
    with pytest.raises(RuntimeError, match="cudaError_t"):
        _train_launch(args[0], args[1], args[2:], plan, resident + 1)


def _crossing_grid(tiles, per_cb, limit):
    """The largest prime grid under `limit` and `tiles` in which a block's
    contiguous run of tiles crosses from one channel block (per_cb tiles)
    into the next, as conv_bn_train_kernel splits them."""
    for grid in range(min(limit, tiles) - 1, 1, -1):
        if any(grid % f == 0 for f in range(2, int(grid ** 0.5) + 1)):
            continue
        if any(b * tiles // grid // per_cb
               != ((b + 1) * tiles // grid - 1) // per_cb
               for b in range(grid)):
            return grid
    raise AssertionError(f"no crossing grid under {limit}")


@pytest.mark.cuda
@pytest.mark.parametrize("co", [64, 80])
def test_train_forward_crossing_grid_gives_default_bits_on_card(co):
    """At R = 8192, C = 64, S = 64 (4 or 5 channel blocks), a prime grid
    whose blocks walk from one channel block into the next gives the
    default grid's bits: the sums' order depends on the plan alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py's k2_gate makes the same check")
    args = _card_inputs(64, co, 8192, 64, torch.float32)
    plan = pgenc_plan(64, 8192, 64, co)
    resident = _resident_blocks(args[0].device.index, plan.tc, 0,
                                plan.threads, plan.smem)
    grid = _crossing_grid(plan.tiles, plan.per_cb, resident)
    want = pgenc_train(*args, backend="kernel")
    got = _train_launch(args[0], args[1], args[2:], plan, grid)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
