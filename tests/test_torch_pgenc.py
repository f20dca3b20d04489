"""The port's fused phasegram-encoder layer (ops/cuda_pgenc.py) and its
kernel stack (models/layers.KernelConvStack1x9) against the JAX package:
`fused_conv_bn_tanh_eval` in interpret mode with non-trivial running stats,
and flax's ConvStack in eval mode on converted weights. fp32; tolerance
2e-5 absolute on tanh outputs (conv summation order differs)."""

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
from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer, pgenc_layer_plain

ATOL = 2e-5


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
