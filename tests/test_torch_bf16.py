"""The port under --dtype bfloat16 against the JAX package at
dtype=jnp.bfloat16, on the CPU: each module that holds a kernel
(TorchBatchNorm, ConvStack, KernelConvStack1x9, BiLSTM), K5's plain chain,
the fusion forward (window: eval, train and the --mask_head route; full
encode: eval and train), one fusion
(full encode, float16 rows) and one frames train step, the separator; and
the JAX fixture that ties the bf16 path on the card to the reference,
tests/fixtures/torch_port_bf16_golden.npz.

JAX runs its kernels' paths where the card runs the port's kernels:
MAAVSS_LSTM=pallas and the fused-layer phasegram encoder in interpret mode
(op by op in bf16: XLA's CPU runtime cannot run its bf16 x bf16 -> f32
dot as one program), K5 (MAAVSS_CONV3D=s2d, MAAVSS_EPILOGUE=fused,
MAAVSS_S2D_MIN_HW=8) and --opt_kernel pallas's Adam; its jitted steps and
separator use the ConvStack phasegram encoder, and so does the port there.
The port runs the plain versions of its kernels. Inputs are numpy, from
seeds; the weights are one float32 tree whose LSTM leaves are bf16
values, so the bf16 and fp32 runs of both packages start from the same
numbers.

The tolerance: the port's bf16 result is at most `RATIO` times as far
from JAX's bf16 result as JAX's bf16 result is from JAX's fp32 one, in
relative L2, on the same inputs:

    rel_l2(port_bf16, jax_bf16) <= RATIO * rel_l2(jax_bf16, jax_fp32)

RATIO = 0.5 holds every forward value that no train-mode batch statistic
precedes: the port follows flax's mixed precision as XLA runs it
(models/layers.py:dense), so the bf16 modules', K5's and the fusion
model's eval outputs equal JAX's bit for bit, and the separator's audio is
0.002 of the distance off. A train-mode forward takes `TRAIN_RATIO` = 1.0:
its BatchNorms sum their fp32 statistics in another order than XLA, which
flips a bf16 rounding here and there, and the flips grow through the
chain of bf16 roundings (the window forward happens to match bit for bit,
the full-encode forward measured 0.42-0.58).
Gradients take `GRAD_RATIO` = 2.0: XLA's VJPs round inside composite rules
where PyTorch's autograd rounds each backward op once (ROADMAP §3), and
the measured ratios run from 0 (BatchNorm, the phasegram kernel, K5) to
1.6 (one BatchNorm shift of the eval-mode ConvStack); a gradient under
GRAD_RATIO must also be no further from JAX's fp32 one than `ACCURATE` =
1.5 times JAX's bf16 is. The train steps' gradients (Adam's first moment)
measured 0.63 (fusion) and 0.90 (frames), their fp32 leaves' updates 0.75
and 0.87. The steps' losses, means over many bf16 terms, are held within
`LOSS_RTOL` = 5e-4 relative (measured 1.4e-4 to 1.7e-4) and must differ
from the port's fp32 losses. Each case checks that the port's bf16 result
differs from its own fp32 result by at least `DIFFERS` (a tenth) of JAX's
bf16-vs-fp32 distance: it ran in bf16. The bf16 parameters after Adam (the
LSTM's) end within one bf16 ulp of JAX's for at least `BF16_LEAVES_SHARE`
of their elements (measured 99.7 % and 99.9 %: `p - u` in bf16 rounds
back to p for most elements at lr 1e-4) and within 2 lr + 2 ulp for all
(where the two gradients differ near 0, Adam's first step moves each side
up to lr its own way). Conv biases that feed a train-mode BatchNorm have
a true gradient of 0 and rounding noise in its place: left out.

The max pool's tie rule: JAX's reduce_window backward (the unfused
stages) and F.max_pool3d's backward both route a tied window's gradient
to its first element in row-major order, bf16 or fp32, the same rule as
K5's first match in phase order 2*py + px
(test_unfused_pool_ties_route_like_jax).

Regenerate the fixture with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bf16.py
"""

import contextlib
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch as jax_synthetic
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.models.fusion_frames import AVFusionFramesModel as JaxFrames
from maavss_tpu.models.layers import BiLSTM as JaxBiLSTM
from maavss_tpu.models.layers import ConvStack as JaxConvStack
from maavss_tpu.models.layers import PallasConvStack1x9
from maavss_tpu.models.layers import TorchBatchNorm as JaxBN
from maavss_tpu.models.layers import space_to_depth_2x2
from maavss_tpu.ops.pallas_epilogue import fused_bn_phasemax_leaky
from maavss_tpu.ops.phasegram import phasegram_cumsum as jax_cumsum
from maavss_tpu.train.infer import make_separator as jax_make_separator
from maavss_tpu.train.state import create_train_state, make_optimizer
from maavss_tpu.train.steps import make_fusion_step as jax_fusion_step
from maavss_tpu.train.steps import make_frames_step as jax_frames_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    random_flax_tree,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.models.layers import (
    BiLSTM,
    ConvStack,
    KernelConvStack1x9,
    TorchBatchNorm,
)
from maavss_tpu_torch.models.shape_plan import (
    plan_phasegram_encoder,
    plan_stft_encoder_fusion,
)
from maavss_tpu_torch.ops.cuda_epilogue import (
    epilogue_apply,
    epilogue_apply_plain,
    epilogue_bwd_dy,
    epilogue_bwd_dy_plain,
    epilogue_bwd_reduce,
    epilogue_bwd_reduce_plain,
    epilogue_stats,
    epilogue_stats_plain,
    fused_bn_pool_leaky,
)
from maavss_tpu_torch.train.infer import make_separator
from maavss_tpu_torch.train.setup import (
    build_frames_state,
    build_fusion,
    build_fusion_state,
)
from maavss_tpu_torch.train.steps import (
    _fusion_full_geometry,
    _windows,
    make_fusion_step,
    make_frames_step,
)
from tests.test_torch_workers import share_cores

share_cores()

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "torch_port_bf16_golden.npz")
RATIO = 0.5
TRAIN_RATIO = 1.0
GRAD_RATIO = 2.0
ACCURATE = 1.5
LOSS_RTOL = 5e-4
BF16_LEAVES_SHARE = 0.99
DIFFERS = 0.1  # port bf16 vs port fp32, as a share of JAX's bf16-vs-fp32
BF16 = torch.bfloat16
JAX_DT = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
DTYPES = ("bfloat16", "float32")
# the fusion geometry of tests/test_torch_fullenc.py (num_seq 2) and the
# frames geometry of tests/test_torch_frames_step.py
FUSION = dict(num_frames=4, num_seq=2, hops_per_frame=4, fft_len=64,
              p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-4,
              batch_size=4, noise_scalar=0.0, fusion_encode="full",
              pgram_cache=True, pgenc_kernel="xla")
FRAMES = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
              framesize=24, learning_rate=1e-4, batch_size=4,
              noise_scalar=0.0)
FRAMES_LATENT = 8
SEED, MODE = 2026, 2
BATCH = dict(batch_seed=11, frames_noise_seed=99, frames_noise=0.1)
# the JAX package's kernel paths, read while tracing (module docstring)
JAX_ENV = dict(MAAVSS_LSTM="pallas", MAAVSS_CONV3D="s2d",
               MAAVSS_EPILOGUE="fused", MAAVSS_S2D_MIN_HW="8")
PORT_ENV = dict(MAAVSS_S2D_MIN_HW="8")


@contextlib.contextmanager
def _env(values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _round_bf16(x: np.ndarray) -> np.ndarray:
    return np.array(_f32(jnp.asarray(x, jnp.bfloat16)))


def check_ratio(what, port_b, jax_b, jax_f, port_f=None, ratio=None):
    """The bound of the module docstring on flattened results, `ratio`
    (default RATIO) times JAX's bf16-vs-fp32 distance; with `port_f`, also
    that the port's bf16 result is not its fp32 one."""
    ratio = RATIO if ratio is None else ratio
    near, base = _rel(_f32(port_b), _f32(jax_b)), _rel(_f32(jax_b),
                                                       _f32(jax_f))
    if base == 0:  # exact in both dtypes (a BatchNorm-fed bias: 0)
        assert near == 0, (what, near)
        return near, base
    assert near <= ratio * base, (what, near, base)
    if ratio > RATIO:  # as accurate as JAX's bf16 against fp32
        assert _rel(_f32(port_b), _f32(jax_f)) <= ACCURATE * base, what
    if port_f is not None:
        own = _rel(_f32(port_b), _f32(port_f))
        assert own >= DIFFERS * base, (what, own, base)
    return near, base


def _cat(arrays):
    return np.concatenate([_f32(a).ravel() for a in arrays])


# ------------------------------------------------------------------ modules

@functools.lru_cache(maxsize=None)
def _jax_module_fn(kind, dtype, train):
    """(flax module, fn(variables, x, cot) -> (out, (d params, d x))) of a
    JAX module at `dtype`: jitted, one compile per module, dtype and mode,
    except the fused-layer phasegram encoder in bf16, whose interpret-mode
    kernels XLA's CPU runtime cannot compile as one program (a bf16 x bf16
    -> f32 dot) and which therefore runs op by op. The eval-mode phasegram
    kernel has no VJP: its gradients are None."""
    dt = JAX_DT[dtype]
    if kind == "bn":
        module = JaxBN(dtype=dt)

        def apply(v, x):  # NCHW public form, NHWC inside
            out = module.apply(v, jnp.moveaxis(x, 1, -1), train,
                               mutable=["batch_stats"])[0]
            return jnp.moveaxis(out, -1, 1)
    elif kind == "lstm":
        module = JaxBiLSTM(256, dtype=dt)

        def apply(v, x):
            return module.apply(v, x)
    else:
        cls = PallasConvStack1x9 if kind == "pgenc" else JaxConvStack
        module = cls(tuple(_specs(kind)), dtype=dt)

        def apply(v, x):
            return module.apply(v, x, train, mutable=["batch_stats"])[0]

    def fn(v, x, cot):
        if kind == "pgenc" and not train:
            return apply(v, x), None
        out, vjp = jax.vjp(lambda p, xin: apply({**v, "params": p}, xin),
                           v["params"], x)
        return out, vjp(cot.astype(out.dtype))

    eager = kind == "pgenc" and dtype == "bfloat16"
    return module, fn if eager else jax.jit(fn)


def _specs(kind):
    """The fusion STFT encoder's specs at the small geometry, or the
    phasegram encoder's first four layers (its bf16 JAX reference runs op
    by op, `_jax_module_fn`)."""
    pg, pg_hw = plan_phasegram_encoder((4, 1, 4, 256), 8, 256)
    if kind == "pgenc":
        return pg[:4]
    return plan_stft_encoder_fusion((4, 2, 16, 32), pg_hw, 8)[0]


_MODULE_SHAPES = {"bn": (4, 8, 6, 10), "stft": (4, 2, 16, 32),
                  "pgenc": (4, 1, 4, 256), "lstm": (2, 5, 48)}


def _module_variables(kind):
    """A fresh copy of `_module_variables_once(kind)`."""
    return jax.tree_util.tree_map(np.copy, _module_variables_once(kind))


@functools.lru_cache(maxsize=None)
def _module_variables_once(kind):
    """A flax init of the module with every BatchNorm statistic, scale and
    shift and every conv bias random, and the LSTM's leaves bf16 values;
    the init under one jit (the eager init's values, without its truncated
    normal compiled once a kernel shape)."""
    x = jnp.zeros(_MODULE_SHAPES[kind])
    module, _ = _jax_module_fn(kind, "float32", False)
    if kind == "bn":
        x = jnp.moveaxis(x, 1, -1)
    args = (x,) if kind == "lstm" else (x, False)
    with _env(JAX_ENV):
        flat = flatten_tree(jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda key: module.init(key, *args))(jax.random.PRNGKey(1))))
    rng = np.random.default_rng(5)
    for path in sorted(flat):
        if path.endswith(("var", "scale")):
            flat[path] = rng.uniform(0.5, 1.5, flat[path].shape)
        elif path.endswith(("mean", "bias")):
            flat[path] = rng.uniform(-0.2, 0.2, flat[path].shape)
        elif path.endswith(("w_i", "w_h")):
            flat[path] = _round_bf16(flat[path])
        flat[path] = flat[path].astype(np.float32)
    return unflatten_tree(flat)


def _module_case(kind, train):
    """{(package, dtype): (output, [d input, d each parameter])} of one
    module on one seeded input (bf16 values, in the compute dtype) and
    cotangent; the parameters in sorted flax order."""
    x = _round_bf16(np.random.default_rng(3).standard_normal(
        _MODULE_SHAPES[kind]).astype(np.float32))
    variables = _module_variables(kind)
    paths = sorted(flatten_tree(variables["params"]))
    results = {}
    for dtype in DTYPES:
        port = _port_module(kind, dtype, train, variables)
        xt = torch.from_numpy(x).to(port.dtype).requires_grad_(True)
        y = port(xt)
        cot = np.random.default_rng(7).standard_normal(y.shape).astype(
            np.float32)
        y.backward(torch.from_numpy(cot).to(y.dtype))
        flat = flatten_tree(to_flax({n: p.grad for n, p in
                                     port.named_parameters()})[0])
        results[("port", dtype)] = (y, [xt.grad] + [flat[k] for k in paths])
        _, fn = _jax_module_fn(kind, dtype, train)
        v = variables
        if dtype == "bfloat16":  # the LSTM's leaves are bf16 parameters
            v = jax.tree_util.tree_map_with_path(
                lambda p, a: jnp.asarray(a, jnp.bfloat16)
                if jax.tree_util.keystr(p).endswith(("'w_i']", "'w_h']"))
                else a, variables)
        with _env(JAX_ENV):
            out, grads = fn(v, jnp.asarray(x, JAX_DT[dtype]),
                            jnp.asarray(cot))
        if grads is not None:
            g_p, g_x = grads
            flat = flatten_tree(jax.tree_util.tree_map(_f32, g_p))
            grads = [g_x] + [flat[k] for k in paths]
        results[("jax", dtype)] = (out, grads)
    return results


def _port_module(kind, dtype, train, variables):
    dt = {"bfloat16": BF16, "float32": torch.float32}[dtype]
    if kind == "bn":
        port = TorchBatchNorm(_MODULE_SHAPES["bn"][1], dt)
    elif kind == "lstm":
        port = BiLSTM(_MODULE_SHAPES["lstm"][2], 256, backend="scan",
                      dtype=dt)
    elif kind == "pgenc":
        port = KernelConvStack1x9(_specs(kind), dtype=dt)
    else:
        port = ConvStack(_specs(kind), dtype=dt)
    port.load_state_dict(from_flax(variables["params"],
                                   variables.get("batch_stats")))
    port.dtype = dt
    return port.train(train)


MODULE_CASES = [(k, t) for k in ("bn", "stft", "pgenc") for t in (0, 1)] \
    + [("lstm", 1)]


@pytest.mark.parametrize("kind,train", MODULE_CASES,
                         ids=[f"{k}-{'train' if t else 'eval'}"
                              for k, t in MODULE_CASES])
def test_module_bf16_tracks_jax(kind, train):
    """TorchBatchNorm, ConvStack (the fusion STFT encoder's specs) and
    KernelConvStack1x9 (the phasegram encoder's) in eval and train mode,
    and BiLSTM (which has no mode): the output and every gradient (the
    eval-mode phasegram kernel has none), bf16 against JAX's bf16."""
    res = _module_case(kind, bool(train))
    (out_pb, g_pb), (out_jb, g_jb) = res[("port", "bfloat16")], res[
        ("jax", "bfloat16")]
    (out_pf, g_pf), (out_jf, g_jf) = res[("port", "float32")], res[
        ("jax", "float32")]
    assert out_pb.dtype == BF16 and out_jb.dtype == jnp.bfloat16
    check_ratio(f"{kind} out", out_pb, out_jb, out_jf, out_pf)
    if g_jb is None:
        return
    assert len(g_pb) == len(g_jb)
    names = ["x"] + sorted(flatten_tree(_module_variables(kind)["params"]))
    for name, a, b, c, d in zip(names, g_pb, g_jb, g_jf, g_pf):
        if train and kind == "stft" and name.endswith("bias") \
                and name.startswith("Conv_"):
            # feeds a train-mode BatchNorm: true gradient 0, and autodiff's
            # is rounding noise (bf16 JAX's reaches 0.3, its fp32 1e-6)
            continue
        check_ratio(f"{kind} grad {name}", a, b, c, d, GRAD_RATIO)


# ------------------------------------------------------------------- K5

def _k5_inputs(ties):
    rng = np.random.default_rng(11 + ties)
    b, c, t, h, w = 2, 16, 3, 8, 12
    y = rng.standard_normal((b, c, t, h, w)) * 0.7
    if ties:  # bf16 rounds a coarse grid's values to many exact ties
        y = np.round(y * 4.0) / 4.0
    gamma = rng.standard_normal(c) * 0.8
    gamma[: c // 3] = -np.abs(gamma[: c // 3]) - 0.1
    beta = rng.standard_normal(c) * 0.3
    g = rng.standard_normal((b, c, t, h // 2, w // 2))
    return (_round_bf16(y.astype(np.float32)), gamma.astype(np.float32),
            beta.astype(np.float32), g.astype(np.float32))


def _to_phase_major(y):
    """NCDHW [B, C, T, H, W] -> JAX's phase-major [B, T, H/2, W/2, 4C]."""
    return space_to_depth_2x2(jnp.moveaxis(y, 1, -1))


@functools.lru_cache(maxsize=None)
def _jax_k5(dtype):
    def fn(y, gamma, beta, g):
        (out, mu, var), vjp = jax.vjp(
            lambda yy, gm, bt: fused_bn_phasemax_leaky(
                _to_phase_major(yy), gm, bt), y, gamma, beta)
        zeros = jnp.zeros_like(mu)
        g_pm = jnp.moveaxis(g, 1, -1).astype(out.dtype)
        return (out, mu, var), vjp((g_pm, zeros, zeros))
    return jax.jit(fn)


@pytest.mark.parametrize("ties", [False, True], ids=["gaussian", "ties"])
def test_k5_plain_chain_bf16_tracks_jax(ties):
    """K5's plain chain (the four plain versions in the autograd Function)
    in bf16 against `fused_bn_phasemax_leaky` in interpret mode: out, mu,
    var, dy, dgamma and dbeta. With ties, the first tied phase takes the
    gradient on both sides, so dy holds to the same bound."""
    y, gamma, beta, g = _k5_inputs(ties)
    res = {}
    for dtype in DTYPES:
        (out, mu, var), (dy, dgm, dbt) = _jax_k5(dtype)(
            jnp.asarray(y, JAX_DT[dtype]), jnp.asarray(gamma),
            jnp.asarray(beta), jnp.asarray(g))
        res[("jax", dtype)] = (np.moveaxis(_f32(out), -1, 1), mu, var, dy,
                               dgm, dbt)
        dt = BF16 if dtype == "bfloat16" else torch.float32
        leaves = [torch.from_numpy(y).to(dt).requires_grad_(True)] + [
            torch.from_numpy(a).requires_grad_(True) for a in (gamma, beta)]
        out, mu, var = fused_bn_pool_leaky(*leaves)
        assert out.dtype == dt
        out.backward(torch.from_numpy(g).to(dt))
        assert leaves[0].grad.dtype == dt
        res[("port", dtype)] = (out, mu, var) + tuple(t.grad for t in leaves)
    if ties:
        y4 = y.reshape(2, 16, 3, 4, 2, 6, 2)
        tied = ((y4 == y4.max(axis=(4, 6), keepdims=True)).sum(axis=(4, 6))
                > 1).mean()
        assert tied > 0.1, tied
    for i, name in enumerate(("out", "mu", "var", "dy", "dgamma", "dbeta")):
        if name in ("mu", "var"):  # fp32 sums of the same values
            np.testing.assert_allclose(_f32(res[("port", "bfloat16")][i]),
                                       _f32(res[("jax", "bfloat16")][i]),
                                       rtol=1e-5, atol=1e-7)
            continue
        check_ratio(f"K5 {name}", res[("port", "bfloat16")][i],
                    res[("jax", "bfloat16")][i], res[("jax", "float32")][i],
                    res[("port", "float32")][i] if name in ("out", "dy")
                    else None)


def test_unfused_pool_ties_route_like_jax():
    """On the unfused stages JAX's max pool is reduce_window, whose
    backward (select-and-scatter) routes a tied window's gradient to its
    first element in row-major order; F.max_pool3d's backward routes to the
    index its forward kept, the first maximum in the same order. On bf16
    data full of ties the two gradients are equal bit for bit, and equal
    to K5's first-match rule in phase order 2*py + px."""
    y = np.round(np.random.default_rng(4).standard_normal(
        (2, 3, 2, 8, 8)) * 2.0) / 2.0
    w = np.random.default_rng(5).standard_normal((2, 3, 2, 4, 4))
    yj = jnp.moveaxis(jnp.asarray(y, jnp.bfloat16), 1, -1)
    gj = jax.grad(lambda x: jnp.sum(fnn.max_pool(
        x, (1, 2, 2), strides=(1, 2, 2)).astype(jnp.float32)
        * jnp.moveaxis(jnp.asarray(w, jnp.float32), 1, -1)))(yj)
    yt = torch.tensor(y, dtype=BF16, requires_grad=True)
    (torch.nn.functional.max_pool3d(yt, (1, 2, 2)).float()
     * torch.from_numpy(w).float()).sum().backward()
    np.testing.assert_array_equal(yt.grad.float().numpy(),
                                  np.moveaxis(_f32(gj), -1, 1))
    y4 = y.reshape(2, 3, 2, 4, 2, 4, 2).transpose(0, 1, 2, 3, 5, 4, 6)
    y4 = y4.reshape(2, 3, 2, 4, 4, 4)
    tied = (y4 == y4.max(-1, keepdims=True)).sum(-1) > 1
    assert tied.mean() > 0.2
    d4 = yt.grad.float().numpy().reshape(2, 3, 2, 4, 2, 4, 2).transpose(
        0, 1, 2, 3, 5, 4, 6).reshape(2, 3, 2, 4, 4, 4)
    first = np.argmax(y4 == y4.max(-1, keepdims=True), -1)
    assert np.array_equal(np.argmax(d4 != 0, -1)[tied], first[tied])


# ------------------------------------------------------------ the models

def _jax_fusion(cfg, dtype, mask_head=False):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFusion(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla", dtype=JAX_DT[dtype], mask_head=mask_head)


def _jax_frames(cfg, dtype):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFrames(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2 + 1),
        frame_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.framesize,
                     cfg.framesize),
        hops_per_frame=cfg.hops_per_frame, latent_channels=FRAMES_LATENT,
        dtype=JAX_DT[dtype])


@functools.lru_cache(maxsize=None)
def _leaf_shapes(family):
    if family == "fusion":
        cfg = JaxRunConfig(**FUSION)
        model = _jax_fusion(cfg, "float32")
        args = (jnp.zeros(model.stft_shape), jnp.zeros(model.pgram_shape))
    else:
        cfg = JaxRunConfig(**FRAMES)
        model = _jax_frames(cfg, "float32")
        args = (jnp.zeros(model.stft_shape), jnp.zeros(model.frame_shape))
    tree = jax.tree_util.tree_map(
        lambda a: np.empty(a.shape, np.float32), jax.eval_shape(
            lambda: model.init(jax.random.PRNGKey(0), *args,
                               method=model.init_all)))
    return {k: tuple(v.shape) for k, v in flatten_tree(
        {"params": tree["params"],
         "batch_stats": tree["batch_stats"]}).items()}


def weights(family, seed=SEED):
    """The seeded float32 tree (`random_flax_tree`) with the LSTM's leaves
    rounded to bf16: every run starts from these numbers."""
    flat = random_flax_tree(_leaf_shapes(family), seed)
    for k in flat:
        if k.endswith(("w_i", "w_h")):
            flat[k] = _round_bf16(flat[k])
    return unflatten_tree(flat)


def _jax_tree(tree, dtype):
    """The JAX variables of `tree` at `dtype`: bf16 LSTM leaves there."""
    if dtype == "float32":
        return tree
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, jnp.bfloat16)
        if jax.tree_util.keystr(p).endswith(("'w_i']", "'w_h']"))
        else jnp.asarray(a), tree)


def fusion_batch(cfg, meta=BATCH):
    """{'audio', 'frames', 'pgram'}: synthetic frames with broadband noise
    and their float16 phasegram rows (tests/test_torch_fullenc.py's)."""
    batch = jax_synthetic(cfg, cfg.batch_size, seed=meta["batch_seed"])
    noise = np.random.default_rng(meta["frames_noise_seed"]).standard_normal(
        batch["frames"].shape).astype(np.float32)
    frames = np.clip(batch["frames"] + meta["frames_noise"] * noise, 0.0, 1.0)
    rows = np.asarray(jax_cumsum(jnp.asarray(frames)), np.float16)
    return {"audio": batch["audio"], "frames": frames, "pgram": rows}


def _port_fusion(cfg, tree, dtype, train=False):
    cfg = cfg.replace(dtype=dtype)
    if train:
        model, state = build_fusion_state(cfg, cfg.batch_size, "cpu")
    else:
        model, state = build_fusion(cfg, cfg.batch_size, "cpu"), None
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    return cfg, model, state


FORWARDS = [("window", False, False), ("window", True, True),
            ("window", True, False), ("full", True, False),
            ("full", False, False)]


def _full_forward_inputs(cfg, r):
    """(the span's STFT, its phasegram, the windows' STFT [B * ns, ...]) of
    one seeded clip, and the latent windows' geometry."""
    a, nf, ns = cfg.hops_per_frame, cfg.num_frames, cfg.num_seq
    x_full = r.standard_normal((4, 2, (nf + ns) * a, 32)).astype(np.float32)
    pg = r.standard_normal((4, 1, nf + ns - 1, 256)).astype(np.float32)
    wins = np.stack([x_full[:, :, j * a:(j + nf) * a] for j in range(ns)],
                    axis=1).reshape(4 * ns, 2, nf * a, 32)
    return x_full[:, :, :(nf + ns - 1) * a], pg, wins


@pytest.mark.parametrize("encode,train,mask_head", FORWARDS,
                         ids=["eval", "train", "train-mask_head",
                              "full-train", "full-eval"])
def test_fusion_forward_bf16_tracks_jax(encode, train, mask_head):
    """The fusion model's window forward (eval and train mode, and the
    --mask_head route: a bf16 a_fc1, the mask in fp32 through the
    standalone mask product) and its full-encode forward (both encoders
    once over the span, the heads over the B * num_seq latent windows)
    against flax's, every output."""
    cfg = RunConfig(**FUSION).replace(pgenc_kernel="xla",
                                      fusion_encode=encode,
                                      mask_head=mask_head)
    tree = weights("fusion")
    r = np.random.default_rng(5)
    t_stft = cfg.hops_per_frame * cfg.num_frames
    if encode == "full":
        inputs = _full_forward_inputs(cfg, r)
    else:
        inputs = (r.standard_normal((4, 2, t_stft, 32)).astype(np.float32),
                  r.standard_normal((4, 1, 4, 256)).astype(np.float32))
    ns = cfg.num_seq
    res = {}
    for dtype in DTYPES:
        model = _jax_fusion(cfg, dtype, mask_head)
        _, port, _ = _port_fusion(cfg, tree, dtype)
        port.train(train)
        hop_a, hop_v, t_win = _fusion_full_geometry(port, cfg)

        def jax_full(v, a_span, pg, x_wins):
            (lat_a, lat_v), _ = model.apply(
                v, a_span, pg, train, method=model.encode_both,
                mutable=["batch_stats"])

            def wins(full, hop):
                st = jnp.stack([full[:, :, j * hop:j * hop + t_win]
                                for j in range(ns)], axis=1)
                return st.reshape((-1,) + st.shape[2:])
            return model.apply(v, wins(lat_a, hop_a), wins(lat_v, hop_v),
                               x_wins, train, method=model.heads_from_latents,
                               mutable=["batch_stats"])[0]

        def jax_window(v, a, b):
            return model.apply(v, a, b, train, mutable=["batch_stats"])[0]

        with _env(JAX_ENV):
            fn = jax.jit(lambda *args: tuple(o.astype(jnp.float32) for o in (
                jax_full if encode == "full" else jax_window)(*args)))
            res[("jax", dtype)] = fn(_jax_tree(tree, dtype), *inputs)
        args = [torch.from_numpy(x) for x in inputs]
        with torch.no_grad():
            if encode == "full":
                lat_a, lat_v = port.encode_both(*args[:2])
                res[("port", dtype)] = port.heads_from_latents(
                    _windows(lat_a, ns, hop_a, t_win),
                    _windows(lat_v, ns, hop_v, t_win), args[2])
            else:
                res[("port", dtype)] = port(*args)
    for i, name in enumerate(("a", "v", "fused")):
        check_ratio(f"fusion {name}", res[("port", "bfloat16")][i],
                    res[("jax", "bfloat16")][i], res[("jax", "float32")][i],
                    res[("port", "float32")][i],
                    TRAIN_RATIO if train else RATIO)


_JAX_RUNS = {}


def _jax_step_run(family, dtype, tree, batch, steps=1):
    """JAX's step from `tree` at `dtype`: per-step metrics and the state
    after the last step, as flat numpy trees (params, batch_stats, Adam's
    first moment). One compile per family and dtype."""
    key = (family, dtype)
    if key not in _JAX_RUNS:
        # the optimizer is a static field of the state: one object a key,
        # or every run would compile the step again
        if family == "fusion":
            cfg = JaxRunConfig(**FUSION).replace(pgenc_kernel="xla")
            model = _jax_fusion(cfg, dtype)
            make = jax_fusion_step
        else:
            cfg = JaxRunConfig(**FRAMES)
            model = _jax_frames(cfg, dtype)
            make = jax_frames_step
        with _env(JAX_ENV):
            _JAX_RUNS[key] = make(model, cfg), make_optimizer(
                FUSION["learning_rate"], "adam", kernel="pallas")
    step, tx = _JAX_RUNS[key]
    v = _jax_tree(tree, dtype)
    state = create_train_state(
        {"params": v["params"], "batch_stats": v["batch_stats"]}, tx)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    metrics = []
    with _env(JAX_ENV):
        for _ in range(steps):
            state, m = step(state, jbatch, jax.random.PRNGKey(0),
                            jnp.int32(MODE))
            metrics.append({k: float(a) for k, a in m.items()})
    out = flatten_tree(jax.tree_util.tree_map(_f32, {
        "params": state.params, "batch_stats": state.batch_stats,
        "m": state.opt_state.m}))
    return metrics, out


def _port_step_run(family, dtype, tree, batch, steps=1):
    if family == "fusion":
        cfg = RunConfig(**FUSION).replace(pgenc_kernel="xla", dtype=dtype)
        cfg, model, state = _port_fusion(cfg, tree, dtype, train=True)
        step = make_fusion_step(model, cfg, device="cpu")
    else:
        cfg = RunConfig(**FRAMES).replace(dtype=dtype)
        model, state = build_frames_state(cfg, cfg.batch_size,
                                          latent_channels=FRAMES_LATENT,
                                          device="cpu")
        model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
        step = make_frames_step(model, cfg, device="cpu")
    metrics = []
    with _env(PORT_ENV):
        for _ in range(steps):
            state, m = step(state, batch, MODE)
            metrics.append({k: float(a) for k, a in m.items()})
    params, stats = to_flax(model.state_dict())
    names = [n for n, _ in model.named_parameters()]
    mom = to_flax(dict(zip(names, state.tx.m)))[0]
    out = {k: np.array(a) for k, a in flatten_tree(
        {"params": params, "batch_stats": stats, "m": mom}).items()}
    return metrics, out, model


def _bn_fed(family):
    """Flat paths of the conv biases that feed a train-mode BatchNorm."""
    if family != "fusion":
        return set()
    _, model, _ = _port_fusion(RunConfig(**FUSION).replace(
        pgenc_kernel="xla"), weights("fusion"), "float32")
    return {"params/" + n.replace(".", "/") for n in model.bn_fed_biases()}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("family", ["fusion", "frames"])
def test_train_step_bf16_tracks_jax(family):
    """One bf16 train step of each family (fusion: full encode on float16
    rows; frames: window mode with K5 at stages 0 and 1) against JAX's:
    the losses; the gradient through Adam's first moment of every leaf;
    each fp32 leaf's update; the bf16 leaves (the LSTM's) within one bf16
    ulp of JAX's."""
    tree = weights(family)
    if family == "fusion":
        batch = fusion_batch(JaxRunConfig(**FUSION))
        batch = {"audio": batch["audio"], "pgram": batch["pgram"]}
    else:
        batch = fusion_batch(JaxRunConfig(**FRAMES).replace(
            p_size=FRAMES["framesize"]))
        batch = {"audio": batch["audio"], "frames": batch["frames"]}
    runs = {("jax", d): _jax_step_run(family, d, tree, batch)
            for d in DTYPES}
    runs.update({("port", d): _port_step_run(family, d, tree, batch)[:2]
                 for d in DTYPES})
    losses = {k: np.array([m[0][n] for n in ("loss", "a_loss", "v_loss")])
              for k, (m, _) in runs.items()}
    np.testing.assert_allclose(losses[("port", "bfloat16")],
                               losses[("jax", "bfloat16")], rtol=LOSS_RTOL)
    assert not np.array_equal(losses[("port", "bfloat16")],
                              losses[("port", "float32")])
    pb, jb, jf, pf = (runs[k][1] for k in (
        ("port", "bfloat16"), ("jax", "bfloat16"), ("jax", "float32"),
        ("port", "float32")))
    init = flatten_tree(tree)
    fed = _bn_fed(family)  # true gradient 0, rounding noise: left out
    f32_leaves = [k for k in jb if k.startswith("params/") and k not in fed
                  and not k.endswith(("w_i", "w_h"))]
    moments = [k for k in jb if k.startswith("m/")
               and "params/" + k[2:] not in fed]
    check_ratio(f"{family} gradients (Adam's m)",
                _cat(pb[k] for k in moments), _cat(jb[k] for k in moments),
                _cat(jf[k] for k in moments), _cat(pf[k] for k in moments),
                GRAD_RATIO)
    check_ratio(f"{family} fp32 leaves' updates",
                _cat(pb[k] - init[k] for k in f32_leaves),
                _cat(jb[k] - init[k] for k in f32_leaves),
                _cat(jf[k] - init[k] for k in f32_leaves), None, GRAD_RATIO)
    lstm = [k for k in jb if k.startswith("params/")
            and k.endswith(("w_i", "w_h"))]
    assert len(lstm) == 4
    lr = FUSION["learning_rate"]
    for k in lstm:
        ulp = _bf16_ulp(jb[k])
        d = np.abs(pb[k] - jb[k])
        # where the two steps' gradients differ in sign or near zero,
        # Adam's first step moves each side by up to lr its own way
        assert np.mean(d <= ulp) >= BF16_LEAVES_SHARE, (k, np.mean(d <= ulp))
        assert np.all(d <= 2 * lr + 2 * ulp), k
        assert np.array_equal(_round_bf16(pb[k]), pb[k]), k  # bf16 values


_JAX_SEPS = {}


def _jax_separate(dtype, tree, batch):
    """JAX's full-encode separator's audio at `dtype`, compiled once."""
    if dtype not in _JAX_SEPS:
        jcfg = JaxRunConfig(**FUSION)
        with _env(JAX_ENV):
            # one optimizer object (a static field of the state) a dtype
            _JAX_SEPS[dtype] = (jax_make_separator(_jax_fusion(jcfg, dtype),
                                                   jcfg),
                                make_optimizer(FUSION["learning_rate"],
                                               "adam"))
    separate, tx = _JAX_SEPS[dtype]
    v = _jax_tree(tree, dtype)
    state = create_train_state(
        {"params": v["params"], "batch_stats": v["batch_stats"]}, tx)
    with _env(JAX_ENV):
        return np.asarray(separate(
            state, {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.PRNGKey(0))["audio_out"])


def _rows_batch(family="fusion"):
    b = fusion_batch(JaxRunConfig(**FUSION))
    return {"audio": b["audio"], "pgram": b["pgram"]}


def test_fusion_separator_bf16_tracks_jax():
    """The full-encode separator on float16 rows, bf16, against JAX's."""
    cfg = RunConfig(**FUSION)
    tree = weights("fusion")
    batch = _rows_batch()
    res = {}
    for dtype in DTYPES:
        res[("jax", dtype)] = _jax_separate(dtype, tree, batch)
        _, model, _ = _port_fusion(cfg, tree, dtype)
        res[("port", dtype)] = make_separator(model, cfg.replace(
            dtype=dtype))({k: torch.from_numpy(a) for k, a in
                           batch.items()})["audio_out"]
        assert res[("port", dtype)].dtype == torch.float32
    check_ratio("separator audio", res[("port", "bfloat16")],
                res[("jax", "bfloat16")], res[("jax", "float32")],
                res[("port", "float32")])


# ----------------------------------------------------------------- golden

def make_golden(path: str = GOLDEN) -> None:
    """Write the fixture: the weights as a seeded recipe, the batch (audio
    and float16 rows), JAX's full-encode separator audio in bf16 and fp32,
    and JAX's losses over 3 train steps in bf16 and fp32."""
    shapes = _leaf_shapes("fusion")
    tree = weights("fusion")
    batch = _rows_batch()
    meta = {"cfg": dict(FUSION, dtype="bfloat16"), "seed": SEED,
            "shapes": {k: list(v) for k, v in shapes.items()},
            "checksums": {k: float(np.asarray(v, np.float64).sum())
                          for k, v in flatten_tree(tree).items()},
            "mode": MODE, **BATCH}
    audio = {d: _jax_separate(d, tree, batch) for d in DTYPES}
    for d in DTYPES:
        metrics, _ = _jax_step_run("fusion", d, tree, batch, steps=3)
        meta[f"losses_{d}"] = [m["loss"] for m in metrics]
    np.savez_compressed(path, meta=json.dumps(meta), audio=batch["audio"],
                        pgram=batch["pgram"],
                        audio_out=audio["bfloat16"],
                        audio_out_f32=audio["float32"])


def _load_golden():
    with np.load(GOLDEN) as z:
        return json.loads(str(z["meta"])), {k: z[k] for k in z.files
                                            if k != "meta"}


def test_golden_recipe_regenerates():
    meta, arrays = _load_golden()
    flat = flatten_tree(weights("fusion", meta["seed"]))
    assert set(flat) == set(meta["checksums"])
    for k, total in meta["checksums"].items():
        assert np.isclose(np.asarray(flat[k], np.float64).sum(), total,
                          rtol=1e-6, atol=1e-6), k
    assert arrays["pgram"].dtype == np.float16
    assert arrays["audio_out"].shape == arrays["audio"].shape
    assert os.path.getsize(GOLDEN) < 200_000


def test_golden_matches_jax():
    """The fixture is still what the JAX package computes on the CPU."""
    meta, arrays = _load_golden()
    tree, batch = weights("fusion", meta["seed"]), _rows_batch()
    np.testing.assert_array_equal(batch["pgram"], arrays["pgram"])
    for d, key in (("bfloat16", "audio_out"), ("float32", "audio_out_f32")):
        assert _rel(_jax_separate(d, tree, batch), arrays[key]) <= 1e-6, d
        metrics, _ = _jax_step_run("fusion", d, tree, batch, steps=3)
        np.testing.assert_allclose([m["loss"] for m in metrics],
                                   meta[f"losses_{d}"], rtol=1e-6)


def golden_gates(audio_out, losses, meta, arrays):
    """The bf16 golden's gates, shared with chip_smoke.py's bf16_golden:
    the separator's audio within RATIO of JAX's bf16-vs-fp32 distance, the
    3 losses within LOSS_RTOL of JAX's bf16 losses. Returns (audio ratio,
    largest loss difference relative)."""
    near = _rel(audio_out, arrays["audio_out"])
    base = _rel(arrays["audio_out"], arrays["audio_out_f32"])
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                  meta["losses_bfloat16"]))
    assert near <= RATIO * base, (near, base)
    assert rel <= LOSS_RTOL, (losses, meta["losses_bfloat16"])
    return near / base, rel


def test_port_matches_golden_on_cpu():
    """The port's plain path on the fixture, under chip_smoke.py's
    bf16_golden gates."""
    meta, arrays = _load_golden()
    cfg = RunConfig(**meta["cfg"])
    tree = weights("fusion", meta["seed"])
    model, state = build_fusion_state(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    batch = {"audio": torch.from_numpy(arrays["audio"]),
             "pgram": torch.from_numpy(arrays["pgram"])}
    audio = make_separator(model, cfg)(batch)["audio_out"].numpy()
    step = make_fusion_step(model, cfg, device="cpu")
    losses = []
    for _ in range(3):
        state, m = step(state, batch, meta["mode"])
        losses.append(float(m["loss"]))
    golden_gates(audio, losses, meta, arrays)


# ------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py's k5_epilogue_bf16 runs this "
                    "comparison on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True], ids=["gaussian", "ties"])
def test_k5_kernels_bf16_match_plain_on_card(ties):
    """K5's four kernels on bf16 y against their plain versions: sel and
    the tie routing exact, out and dy within one bf16 rounding."""
    _needs_card()
    y, gamma, beta, g = (torch.from_numpy(a).cuda()
                         for a in _k5_inputs(ties))
    y, g = y.to(BF16), g.to(BF16)
    mu, var, rstd = epilogue_stats(y)
    for a, b in zip((mu, var, rstd), epilogue_stats_plain(y)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    out, sel = epilogue_apply(y, gamma, beta, mu, rstd)
    out_p, sel_p = epilogue_apply_plain(y, gamma, beta, mu, rstd)
    assert out.dtype == sel.dtype == BF16
    assert torch.equal(sel, sel_p)
    torch.testing.assert_close(out.float(), out_p.float(), rtol=2 ** -7,
                               atol=0)
    zeros = torch.zeros_like(mu)
    red = epilogue_bwd_reduce(g, sel, gamma, beta, mu, rstd, zeros, zeros)
    red_p = epilogue_bwd_reduce_plain(g, sel, gamma, beta, mu, rstd, zeros,
                                      zeros)
    for a, b in zip(red, red_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    dy = epilogue_bwd_dy(y, g, sel, gamma, beta, mu, rstd, red[2])
    dy_p = epilogue_bwd_dy_plain(y, g, sel, gamma, beta, mu, rstd, red[2])
    assert dy.dtype == BF16
    torch.testing.assert_close(dy.float(), dy_p.float(), rtol=2 ** -7,
                               atol=1e-3 * dy_p.float().abs().max().item())


if __name__ == "__main__":
    make_golden()
    print(f"wrote {GOLDEN}")
