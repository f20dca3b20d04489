"""The port's Adam (ops/cuda_adam.py's plain formula and the optimizer of
train/fused_adam.py) against the JAX package on the same numpy inputs:

- `adam_leaf_update` (maavss_tpu/ops/pallas_adam.py) for a leaf the Pallas
  kernel takes (>= 16384 elements, interpret mode) and one it leaves to its
  jnp formula, over 3 steps;
- the optimizer over a small parameter tree, one leaf without a gradient,
  against `pallas_adam().fused_apply` and against `optax.adam`.

fp32. Tolerance: 1e-7 absolute + 1e-6 relative on parameters and moments
(the same formula; optax applies -lr after the division, one rounding
apart).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.ops.pallas_adam import adam_leaf_update, pallas_leaf_eligible
from maavss_tpu.train.fused_adam import pallas_adam
from maavss_tpu_torch.ops.cuda_adam import (
    AdamTable,
    adam_multi_tensor,
    adam_update_plain,
    bias_corrections,
)
from maavss_tpu_torch.train.fused_adam import FusedAdam
from maavss_tpu_torch.train.state import make_optimizer
from tests.test_torch_workers import share_cores

share_cores()

ATOL, RTOL = 1e-7, 1e-6
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


@pytest.mark.parametrize("shape", [(128, 256), (7, 5)])
def test_plain_update_matches_adam_leaf_update(shape):
    rng = np.random.default_rng(0)
    p = rng.standard_normal(shape).astype(np.float32)
    m = np.zeros(shape, np.float32)
    v = np.zeros(shape, np.float32)
    assert pallas_leaf_eligible(jnp.asarray(p)) == (p.size >= 16384)
    mj, vj, pj = map(jnp.asarray, (m, v, p))
    mt, vt, pt = map(torch.from_numpy, (m.copy(), v.copy(), p.copy()))
    for count in range(1, 4):
        g = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
        # one pair of bias corrections for both sides: this test holds the
        # update formula; test_bias_corrections_match_fused_adam holds the
        # corrections (1 - 0.999^t magnifies a pow ulp about 1000-fold)
        c1, c2 = bias_corrections(count, B1, B2)
        mj, vj, pj = adam_leaf_update(
            jnp.asarray(g), mj, vj, pj, jnp.float32(c1), jnp.float32(c2),
            lr=LR, b1=B1, b2=B2, eps=EPS)
        adam_update_plain(torch.from_numpy(g), mt, vt, pt, c1, c2, LR, B1, B2,
                          EPS)
        for got, want in ((mt, mj), (vt, vj), (pt, pj)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=RTOL)


def _tree(seed=1):
    rng = np.random.default_rng(seed)
    shapes = {"dense": (64, 300), "bias": (300,), "frozen": (4, 4)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("reference", ["pallas_adam", "optax"])
def test_optimizer_matches_jax(reference):
    """Three steps; 'frozen' has no gradient (.grad None in torch, a zero
    gradient in JAX): its moments stay 0 and it does not move."""
    params = _tree()
    rng = np.random.default_rng(2)
    grads = [{k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
              if k != "frozen" else np.zeros_like(v)
              for k, v in params.items()} for _ in range(3)]
    tx = pallas_adam(LR) if reference == "pallas_adam" else optax.adam(LR)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(pj)
    tensors = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = make_optimizer(list(tensors.values()), LR)
    assert isinstance(opt, FusedAdam) and opt.kernel == "xla"
    for g in grads:
        gj = jax.tree_util.tree_map(jnp.asarray, g)
        if reference == "pallas_adam":
            pj, state = tx.fused_apply(gj, state, pj)
        else:
            updates, state = tx.update(gj, state, pj)
            pj = optax.apply_updates(pj, updates)
        for k, t in tensors.items():
            t.grad = None if k == "frozen" else torch.from_numpy(g[k])
        opt.step()
    assert opt.count == 3
    for k in tensors:
        np.testing.assert_allclose(tensors[k].numpy(), np.asarray(pj[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    np.testing.assert_array_equal(tensors["frozen"].numpy(),
                                  params["frozen"])
    assert not opt.m[2].any() and not opt.v[2].any()


def test_kernel_gate():
    t = [torch.zeros(3, requires_grad=True)]
    assert make_optimizer(t, LR, kernel="auto").kernel == "xla"
    assert make_optimizer(t, LR, kernel="xla").kernel == "xla"
    opt = make_optimizer(t, LR, kernel="pallas")
    assert opt.kernel == "pallas"
    t[0].grad = torch.ones(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        opt.step()  # the kernel on a CPU parameter raises
    with pytest.raises(ValueError):
        make_optimizer(t, LR, kernel="fused")
    for kwargs, item in ((dict(name="sgd"), "sgd"),
                         (dict(name="adamw"), "adamw"),
                         (dict(trainable=["fc1"]), "staged"),
                         (dict(flat=True), "fused_opt")):
        with pytest.raises(NotImplementedError, match=item):
            make_optimizer(t, LR, **kwargs)
    # a schedule builds with every kernel choice: K3 reads the rate from
    # [c1, c2, lr] on the card (tests/test_torch_lr_schedule.py)
    for kernel in ("auto", "xla", "pallas"):
        sched = make_optimizer(t, lambda count: count * 0.0 + LR,
                               kernel=kernel)
        assert sched.schedule is not None and sched.lr is None


def test_multi_tensor_takes_plain_path_on_cpu():
    params = _tree(3)
    ps = [torch.from_numpy(v.copy()) for v in params.values()]
    ref = [torch.from_numpy(v.copy()) for v in params.values()]
    grads = [torch.full_like(p, 0.01) for p in ps[:2]] + [None]
    ms, vs = [torch.zeros_like(p) for p in ps], [torch.zeros_like(p)
                                                 for p in ps]
    mr, vr = [torch.zeros_like(p) for p in ps], [torch.zeros_like(p)
                                                 for p in ps]
    adam_multi_tensor.launches = 0
    adam_multi_tensor(grads, ms, vs, ps, torch.tensor([0.1, 0.001, LR]), B1,
                      B2, EPS)
    for g, m, v, p in zip(grads, mr, vr, ref):
        adam_update_plain(g, m, v, p, 0.1, 0.001, LR, B1, B2, EPS)
    for a, b in zip(ps + ms + vs, ref + mr + vr):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert adam_multi_tensor.launches == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        adam_multi_tensor(grads, ms, vs, ps, torch.tensor([0.1, 0.001, LR]),
                          B1, B2, EPS, backend="kernel")


def test_bias_corrections_match_fused_adam():
    for count in (1, 2, 7, 1000):
        c = jnp.asarray(count, jnp.int32).astype(jnp.float32)
        want = (float(1.0 - B1 ** c), float(1.0 - B2 ** c))
        assert bias_corrections(count, B1, B2) == pytest.approx(want,
                                                                rel=1e-6)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    params = _tree(4)
    ps = [torch.from_numpy(v.copy()).cuda() for v in params.values()]
    ref = [p.clone() for p in ps]
    grads = [torch.randn_like(p) * 1e-2 for p in ps[:2]] + [None]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    mr, vr = [m.clone() for m in ms], [v.clone() for v in vs]
    table = AdamTable(ms, vs, ps)
    for count in (1, 2, 3):
        c1, c2 = bias_corrections(count, B1, B2)
        adam_multi_tensor(grads, ms, vs, ps,
                          torch.tensor([c1, c2, LR]).cuda(), B1, B2, EPS,
                          table=table, backend="kernel")
        for g, m, v, p in zip(grads, mr, vr, ref):
            adam_update_plain(g, m, v, p, c1, c2, LR, B1, B2, EPS)
    for a, b in zip(ps + ms + vs, ref + mr + vr):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
