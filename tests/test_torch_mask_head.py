"""The fused `--mask_head` audio head (maavss_tpu_torch/ops/cuda_mask_head.py)
against the JAX package: flax `Dense` followed by JAX's `complex_mask_apply`
on its XLA route (maavss_tpu/ops/pallas_kernels.py), on the same numpy
inputs, with the Dense weights carried across by `convert.from_flax`:
forward and VJP in h, W and b at 1e-5 relative L2 (fp32; the head's 16-64
term dot products are summed in another order by XLA than by PyTorch's CPU
BLAS). Two small geometries: the fusion head (a bias; the STFT operand a
window of the clip's STFT) and the frames head (no bias, F odd; the STFT
operand the clip's middle-frame columns). The JAX side computes both in
one jitted function: one compile for the file.

On the CPU `mask_head_apply` runs the plain versions through its autograd
Function, which give F.linear followed by the plain mask product under
autograd bit for bit, and counts no launch; `mask_head_layout`, the
kernels' check, refuses what they cannot read. The `cuda`-marked tests hold
the kernels against the plain version on a card (chip_smoke.py's k4_head
phase holds the same without jax).
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from maavss_tpu.ops import pallas_kernels as pk
from maavss_tpu_torch.convert import from_flax
from maavss_tpu_torch.ops import cuda_complex as cc
from maavss_tpu_torch.ops import cuda_mask_head as cmh
from tests.test_torch_workers import share_cores

share_cores()

TOL = 1e-5
# name: (M, K, clip T, window rows, T, F, bias)
CASES = {
    "fusion": (3, 32, 12, slice(4, 8), 4, 8, True),
    "frames": (2, 32, 8, slice(4, 8), 4, 9, False),
}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """numpy (flax params, h, the clip's STFT, cotangent) of a case."""
    m, k, t_clip, _, t, f, bias = CASES[name]
    seed = 10 * len(name)
    params = {"kernel": _rand((k, 2 * t * f), seed, k ** -0.5)}
    if bias:
        params["bias"] = _rand((2 * t * f,), seed + 1, 0.1)
    return (params, _rand((m, k), seed + 2), _rand((m, 2, t_clip, f),
                                                   seed + 3),
            _rand((m, 2, t, f), seed + 4))


@functools.lru_cache(maxsize=1)
def _jax_results():
    """{case: (out, d_params, d_h)} from flax Dense + JAX's
    complex_mask_apply (XLA route), both cases in one jitted call."""
    names = sorted(CASES)

    def run(all_inputs):
        res = {}
        for name, (params, h, clip, g) in zip(names, all_inputs):
            _, _, _, win, t, f, bias = CASES[name]
            dense = fnn.Dense(2 * t * f, use_bias=bias)
            stft = clip[:, :, win]

            def head(params, h, dense=dense, stft=stft):
                mask = dense.apply({"params": params}, h)
                return pk.complex_mask_apply(stft, mask.reshape(stft.shape))

            out, vjp = jax.vjp(head, params, h)
            res[name] = (out,) + vjp(g)
        return res

    got = jax.jit(run)([jax.tree_util.tree_map(jnp.asarray, _inputs(n))
                        for n in names])
    return jax.tree_util.tree_map(np.asarray, got)


def _port(name, fn=cmh.mask_head_apply, stft_grad=False):
    """(out, d_h, d_weight, d_bias, d_stft, stft) of `fn` on a case's
    inputs, W and b from the flax params through convert.from_flax."""
    params, h, clip, g = _inputs(name)
    win = CASES[name][3]
    sd = from_flax({"a_fc1": params})
    weight = sd["a_fc1.weight"].requires_grad_(True)
    bias = sd.get("a_fc1.bias")
    if bias is not None:
        bias.requires_grad_(True)
    h = torch.from_numpy(h).requires_grad_(True)
    full = torch.from_numpy(clip.copy())
    if stft_grad:
        full.requires_grad_(True)
    stft = full[:, :, win]
    out = fn(h, weight, bias, stft)
    out.backward(torch.from_numpy(g))
    return (out.detach(), h.grad, weight.grad,
            None if bias is None else bias.grad,
            None if not stft_grad else full.grad[:, :, win], stft)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("name", sorted(CASES))
def test_head_matches_flax_dense_and_jax_mask(name):
    """mask_head_apply on the CPU (its plain versions) against flax Dense +
    JAX's complex_mask_apply: the output and the VJP in h, W and b."""
    want_out, want_dp, want_dh = _jax_results()[name]
    out, d_h, d_w, d_b, _, stft = _port(name)
    assert not stft.is_contiguous()  # read in place, as the models do
    assert _rel_l2(out, want_out) <= TOL
    assert _rel_l2(d_h, want_dh) <= TOL
    assert _rel_l2(d_w.numpy().T, want_dp["kernel"]) <= TOL
    if CASES[name][-1]:
        assert _rel_l2(d_b, want_dp["bias"]) <= TOL
    else:
        assert d_b is None and "bias" not in want_dp


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_route_is_the_plain_composition(name):
    """On CPU tensors the autograd Function's plain forward and backward
    give F.linear + the plain mask product under autograd bit for bit, and
    no kernel launch is counted."""
    cmh.mask_head_apply.launches = cmh.mask_head_apply.bwd_launches = 0
    got = _port(name)
    want = _port(name, cmh.mask_head_apply_plain)
    for a, b in zip(got[:4], want[:4]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert (cmh.mask_head_apply.launches,
            cmh.mask_head_apply.bwd_launches) == (0, 0)


def test_stft_gradient_through_the_saved_mask(monkeypatch):
    """Where the STFT needs a gradient the forward keeps the mask and the
    backward takes d_stft = g * conj(mask) through the standalone mask
    product, once; the values are the plain composition's."""
    calls = []
    real = cc.mask_mul

    def spy(a, b, conj=False):
        calls.append(conj)
        return real(a, b, conj)

    monkeypatch.setattr(cc, "mask_mul", spy)
    got = _port("fusion", stft_grad=True)
    assert calls == [True]
    want = _port("fusion", cmh.mask_head_apply_plain, stft_grad=True)
    for a, b in zip(got[:5], want[:5]):
        assert torch.equal(a, b)


def _valid(dtype=torch.float32):
    m, k, t, f = 2, 8, 3, 4
    return (torch.zeros(m, k, dtype=dtype), torch.zeros(2 * t * f, k,
                                                        dtype=dtype),
            torch.zeros(2 * t * f, dtype=dtype),
            torch.zeros(m, 2, t + 2, f, dtype=dtype)[:, :, 1:1 + t])


@pytest.mark.parametrize("case", ["weight_rows", "bias_shape", "h_rows",
                                  "stft_planes"])
def test_wrapper_raises_on_shapes(case):
    h, w, b, s = _valid()
    bad = {"weight_rows": (h, w[:-1], b, s),
           "bias_shape": (h, w, b[:-1], s),
           "h_rows": (h[:1], w, b, s),
           "stft_planes": (h, w, b, torch.zeros(2, 3, 3, 4))}[case]
    with pytest.raises(ValueError):
        cmh.mask_head_apply(*bad)


@pytest.mark.parametrize("case", ["float64", "h_transposed", "k_not_4",
                                  "stft_unreadable", "cpu_device"])
def test_kernel_layout_refusals(case):
    """The kernels' check, run on CPU tensors: it refuses another dtype,
    an h it cannot stream, K not a multiple of 4, an STFT view whose last
    axis is strided, and tensors off CUDA."""
    h, w, b, s = _valid()
    if case == "float64":
        args, err, match = _valid(torch.float64), TypeError, "float32"
    elif case == "h_transposed":
        args = (torch.zeros(8, 2).t(), w, b, s)
        err, match = ValueError, "contiguous"
    elif case == "k_not_4":
        args = (torch.zeros(2, 6), torch.zeros(24, 6), b, s)
        err, match = ValueError, "multiple of 4"
    elif case == "stft_unreadable":
        strided = torch.zeros(2, 2, 4, 3).transpose(-1, -2)  # last axis
        args = (h, w, b, strided)
        err, match = ValueError, "cannot read"
    else:
        args, err, match = (h, w, b, s), ValueError, "CUDA"
    with pytest.raises(err, match=match):
        cmh.mask_head_layout(*args)
    if case == "cpu_device":
        assert cmh.cc._layout(s) is not None


# ------------------------------------------------------------ on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py's k4_head phase runs this "
                    "comparison on the card")


def _on_card(name, fn, stft_grad=False):
    params, h, clip, g = _inputs(name)
    win = CASES[name][3]
    sd = {k: v.cuda().requires_grad_(True)
          for k, v in from_flax({"a_fc1": params}).items()}
    h = torch.from_numpy(h).cuda().requires_grad_(True)
    full = torch.from_numpy(clip.copy()).cuda().requires_grad_(stft_grad)
    out = fn(h, sd["a_fc1.weight"], sd.get("a_fc1.bias"), full[:, :, win])
    out.backward(torch.from_numpy(g).cuda())
    grads = [h.grad, sd["a_fc1.weight"].grad]
    if "a_fc1.bias" in sd:
        grads.append(sd["a_fc1.bias"].grad)
    if stft_grad:
        grads.append(full.grad)
    return [out.detach()] + grads


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_head_kernels_match_plain_on_card(name):
    """Forward and backward kernels against the plain composition at rel
    L2 1e-5, two calls bitwise equal, the forward and backward counted."""
    _card()
    cmh.mask_head_apply.launches = cmh.mask_head_apply.bwd_launches = 0
    got = _on_card(name, cmh.mask_head_apply, stft_grad=True)
    again = _on_card(name, cmh.mask_head_apply, stft_grad=True)
    want = _on_card(name, cmh.mask_head_apply_plain, stft_grad=True)
    assert (cmh.mask_head_apply.launches,
            cmh.mask_head_apply.bwd_launches) == (2, 2)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        assert _rel_l2(a.cpu(), c.cpu()) <= TOL


@pytest.mark.cuda
def test_head_kernel_raises_on_layouts_on_card():
    _card()
    h, w, b, s = (x.cuda() for x in _valid())
    with pytest.raises(TypeError, match="float32"):
        cmh.mask_head_apply(h.double(), w.double(), b.double(), s.double())
    with pytest.raises(ValueError, match="16-byte"):
        cmh.mask_head_apply(torch.zeros(2 * 8 + 1, device="cuda")[1:].view(
            2, 8), w, b, s)
