"""The port under --dtype float16 against the JAX package at
dtype=jnp.float16, on the CPU, in tests/test_torch_bf16.py's form: the
modules that hold a kernel (TorchBatchNorm, KernelConvStack1x9, BiLSTM),
K5's plain chain, the fusion forward (eval and train) and the frames
heads' (eval), the separator, the
fusion step's first step with the update that the reference's Adam makes
non-finite, and the audio and visual autoencoder regimes over 3 steps.

JAX runs its kernels' paths where the card runs the port's kernels
(tests/test_torch_bf16.py's JAX_ENV: MAAVSS_LSTM=pallas, the fused-layer
phasegram encoder and K5 in interpret mode, --opt_kernel pallas's Adam);
the port runs the plain versions of its kernels. Inputs are numpy, from
seeds; the weights are one float32 tree whose LSTM leaves are float16
values, so the fp16 and fp32 runs of both packages start from the same
numbers.

The tolerance is test_torch_bf16.py's ratio form:

    rel_l2(port_f16, jax_f16) <= RATIO * rel_l2(jax_f16, jax_f32)

XLA's CPU runtime runs fp16 otherwise than bf16 (the compiled HLO's
converts): it keeps fp16 arithmetic, each operation rounded, and drops no
round trip fp32 -> fp16 -> fp32, so a conv's output rounds before its
BatchNorm and the frames heads' tanh and sigmoid end in fp16
(models/layers.py:excess_precision). With those rules the encoders'
outputs equal JAX's bit for bit. RATIO = 0.5 holds the modules' and K5's
forward values (measured 0 to 0.098: K1's fp32 gates, whose exp and tanh
differ from XLA's in the last fp32 bit, round to another fp16 value in
0.66 % of the LSTM's outputs). A whole model's forward carries those flips
through fc1 and fc2: MODEL_RATIO = 0.75 for the fusion eval forward, the
frames heads and the separator (measured 0.16 to 0.40), TRAIN_RATIO = 1.0
for the train forward (0.55 to 0.67, its BatchNorms summing in another
order too). Gradients take GRAD_RATIO = 2.0 and must be no further from
JAX's fp32 ones than ACCURATE = 1.5 times JAX's fp16 is (check_ratio,
with tests/test_torch_bf16.py's constants; the modules' measured 0 to
0.82, the step's Adam first moment 1.10, its fp32 leaves' updates 0.25).
Each case checks that the port's fp16 result differs from its own fp32
result by at least DIFFERS (a tenth) of JAX's fp16-vs-fp32 distance. The
step's losses are held within LOSS_RTOL = 2e-5 relative of JAX's fp16
losses (measured up to 4.6e-6; fp16 against fp32 moves them 4.7e-5) and
must differ from the port's fp32 losses; the autoencoder regimes' free
runs within AE_LOSS_RTOL = 1e-4 (measured 1.9e-5 to 7.3e-5).

The fault the port reproduces and does not repair (ROADMAP queue 3,
tools/fp16_adam_probe.py): the LSTM's w_i and w_h are fp16 parameters and
Adam's moments and update take their dtype (optax.adam and the Pallas Adam
alike). eps = 1e-8 rounds to 0 in fp16, and v = (1 - b2) g^2 underflows to
0, so the update m_hat / (sqrt(v_hat) + eps) is x/0 or 0/0: after the first
step every element of the four LSTM leaves is non-finite, on both sides,
and nothing else is. In the autoencoder regimes the LSTM is unused (g = 0,
so 0/0) and ends non-finite all the same while the losses train.
"""

import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.models.layers import BiLSTM as JaxBiLSTM
from maavss_tpu.models.layers import PallasConvStack1x9
from maavss_tpu.models.layers import TorchBatchNorm as JaxBN
from maavss_tpu.ops.pallas_epilogue import fused_bn_phasemax_leaky
from maavss_tpu.train import steps as j_steps
from maavss_tpu.train.infer import make_separator as jax_make_separator
from maavss_tpu.train.state import create_train_state, make_optimizer
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    random_flax_tree,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.exp.checkpoint import load_model
from maavss_tpu_torch.models.layers import (
    BiLSTM,
    KernelConvStack1x9,
    TorchBatchNorm,
)
from maavss_tpu_torch.ops.cuda_epilogue import fused_bn_pool_leaky
from maavss_tpu_torch.train import steps
from maavss_tpu_torch.train.infer import make_separator
from maavss_tpu_torch.train.setup import build_fusion, build_fusion_state
from tests.test_torch_bf16 import (
    BATCH,
    FRAMES,
    FRAMES_LATENT,
    FUSION,
    JAX_ENV,
    MODE,
    PORT_ENV,
    _cat,
    _env,
    _f32,
    _leaf_shapes,
    _port_fusion,
    _rel,
    _specs,
    _to_phase_major,
    check_ratio,
    fusion_batch,
)
from tests.test_torch_workers import share_cores

share_cores()

RATIO = 0.5  # check_ratio's default (tests/test_torch_bf16.py)
MODEL_RATIO = 0.75
TRAIN_RATIO = 1.0
GRAD_RATIO = 2.0
LOSS_RTOL = 2e-5
F16 = torch.float16
JAX_DT = {"float16": jnp.float16, "float32": jnp.float32}
DTYPES = ("float16", "float32")
LSTM_LEAVES = ("w_i", "w_h")
# tests/test_torch_regimes.py's geometry, its learning rate and 3 steps
AE_GEOMETRY = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                   p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
                   batch_size=4, noise_scalar=0.0)
AE_STEPS = 3
AE_LOSS_RTOL = 1e-4


def _round(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float16).astype(np.float32)


def _lstm_f16(tree, dtype):
    """The JAX variables of `tree` at `dtype`: its LSTM leaves fp16
    parameters in fp16, as flax creates them."""
    if dtype == "float32":
        return jax.tree_util.tree_map(jnp.asarray, tree)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, jnp.float16)
        if jax.tree_util.keystr(p).endswith(("'w_i']", "'w_h']"))
        else jnp.asarray(a), tree)


def _shapes(tree):
    """{flat path: shape} of a tree of jax.ShapeDtypeStructs."""
    return {k: tuple(v.shape) for k, v in flatten_tree(
        jax.tree_util.tree_map(lambda a: np.empty(a.shape, np.float32),
                               tree)).items()}


def weights(shapes, seed=2026):
    """A seeded float32 tree with the LSTM's leaves rounded to fp16."""
    flat = random_flax_tree(shapes, seed)
    for k in flat:
        if k.endswith(LSTM_LEAVES):
            flat[k] = _round(flat[k])
    return unflatten_tree(flat)


# ------------------------------------------------------------------ modules

_MODULE_SHAPES = {"bn": (4, 8, 6, 10), "pgenc": (4, 1, 4, 256),
                  "lstm": (2, 5, 48)}


@functools.lru_cache(maxsize=None)
def _jax_module(kind, dtype, train):
    dt = JAX_DT[dtype]
    if kind == "bn":
        module = JaxBN(dtype=dt)

        def apply(v, x):
            out = module.apply(v, jnp.moveaxis(x, 1, -1), train,
                               mutable=["batch_stats"])[0]
            return jnp.moveaxis(out, -1, 1)
    elif kind == "lstm":
        module = JaxBiLSTM(256, dtype=dt)

        def apply(v, x):
            return module.apply(v, x)
    else:
        module = PallasConvStack1x9(tuple(_specs(kind)), dtype=dt)

        def apply(v, x):
            return module.apply(v, x, train, mutable=["batch_stats"])[0]

    def fn(v, x, cot):
        if kind == "pgenc" and not train:  # the eval kernel has no VJP
            return apply(v, x), None
        out, vjp = jax.vjp(lambda p, xin: apply({**v, "params": p}, xin),
                           v["params"], x)
        return out, vjp(cot.astype(out.dtype))
    return module, jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _module_variables(kind):
    x = jnp.zeros(_MODULE_SHAPES[kind])
    module, _ = _jax_module(kind, "float32", False)
    if kind == "bn":
        x = jnp.moveaxis(x, 1, -1)
    args = (x,) if kind == "lstm" else (x, False)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return weights(_shapes(shapes), seed=5)


def _port_module(kind, dtype, train, variables):
    dt = {"float16": F16, "float32": torch.float32}[dtype]
    if kind == "bn":
        port = TorchBatchNorm(_MODULE_SHAPES["bn"][1], dt)
    elif kind == "lstm":
        port = BiLSTM(_MODULE_SHAPES["lstm"][2], 256, backend="scan",
                      dtype=dt)
    else:
        port = KernelConvStack1x9(_specs(kind), dtype=dt)
    port.load_state_dict(from_flax(variables["params"],
                                   variables.get("batch_stats")))
    return port.train(train)


MODULE_CASES = [("bn", 0), ("bn", 1), ("pgenc", 0), ("pgenc", 1),
                ("lstm", 1)]


@pytest.mark.parametrize("kind,train", MODULE_CASES,
                         ids=[f"{k}-{'train' if t else 'eval'}"
                              for k, t in MODULE_CASES])
def test_module_fp16_tracks_jax(kind, train):
    """TorchBatchNorm, KernelConvStack1x9 (K2's module) in eval and train
    mode and BiLSTM (K1's): the output and every gradient, fp16 against
    JAX's fp16."""
    variables = _module_variables(kind)
    x = _round(np.random.default_rng(3).standard_normal(
        _MODULE_SHAPES[kind]).astype(np.float32))
    paths = sorted(flatten_tree(variables["params"]))
    res = {}
    for dtype in DTYPES:
        port = _port_module(kind, dtype, bool(train), variables)
        xt = torch.from_numpy(x).to(port.dtype if kind != "lstm" else
                                    port.fwd.w_i.dtype).requires_grad_(True)
        y = port(xt)
        cot = np.random.default_rng(7).standard_normal(y.shape).astype(
            np.float32)
        y.backward(torch.from_numpy(cot).to(y.dtype))
        flat = flatten_tree(to_flax({n: p.grad for n, p in
                                     port.named_parameters()})[0])
        res[("port", dtype)] = (y, [xt.grad] + [flat[k] for k in paths])
        _, fn = _jax_module(kind, dtype, bool(train))
        with _env(JAX_ENV):
            out, grads = fn(_lstm_f16(variables, dtype),
                            jnp.asarray(x, JAX_DT[dtype]), jnp.asarray(cot))
        if grads is not None:
            g_p, g_x = grads
            flat = flatten_tree(jax.tree_util.tree_map(_f32, g_p))
            grads = [g_x] + [flat[k] for k in paths]
        res[("jax", dtype)] = (out, grads)
    (out_ph, g_ph), (out_jh, g_jh) = res[("port", "float16")], res[
        ("jax", "float16")]
    (out_pf, g_pf), (_, g_jf) = res[("port", "float32")], res[
        ("jax", "float32")]
    assert out_ph.dtype == F16 and out_jh.dtype == jnp.float16
    check_ratio(f"{kind} out", out_ph, out_jh, res[("jax", "float32")][0],
                out_pf, TRAIN_RATIO if train else RATIO)
    if g_jh is None:
        return
    for name, a, b, c, d in zip(["x"] + paths, g_ph, g_jh, g_jf, g_pf):
        check_ratio(f"{kind} grad {name}", a, b, c, d, GRAD_RATIO)


# ------------------------------------------------------------------- K5

def _k5_inputs(ties):
    rng = np.random.default_rng(11 + ties)
    b, c, t, h, w = 2, 16, 3, 8, 12
    y = rng.standard_normal((b, c, t, h, w)) * 0.7
    if ties:  # a coarse grid: many exact ties in the windows
        y = np.round(y * 4.0) / 4.0
    gamma = rng.standard_normal(c) * 0.8
    gamma[: c // 3] = -np.abs(gamma[: c // 3]) - 0.1
    beta = rng.standard_normal(c) * 0.3
    g = rng.standard_normal((b, c, t, h // 2, w // 2))
    return (_round(y.astype(np.float32)), gamma.astype(np.float32),
            beta.astype(np.float32), g.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_k5(dtype):
    def fn(y, gamma, beta, g):
        (out, mu, var), vjp = jax.vjp(
            lambda yy, gm, bt: fused_bn_phasemax_leaky(
                _to_phase_major(yy), gm, bt), y, gamma, beta)
        zeros = jnp.zeros_like(mu)
        return (out, mu, var), vjp((jnp.moveaxis(g, 1, -1).astype(out.dtype),
                                    zeros, zeros))
    return jax.jit(fn)


@pytest.mark.parametrize("ties", [False, True], ids=["gaussian", "ties"])
def test_k5_plain_chain_fp16_tracks_jax(ties):
    """K5's plain chain in fp16 against `fused_bn_phasemax_leaky` in
    interpret mode: out, mu, var, dy, dgamma and dbeta; with ties the
    first tied phase takes the gradient on both sides."""
    y, gamma, beta, g = _k5_inputs(ties)
    res = {}
    for dtype in DTYPES:
        (out, mu, var), (dy, dgm, dbt) = _jax_k5(dtype)(
            jnp.asarray(y, JAX_DT[dtype]), jnp.asarray(gamma),
            jnp.asarray(beta), jnp.asarray(g))
        res[("jax", dtype)] = (np.moveaxis(_f32(out), -1, 1), mu, var, dy,
                               dgm, dbt)
        dt = F16 if dtype == "float16" else torch.float32
        leaves = [torch.from_numpy(y).to(dt).requires_grad_(True)] + [
            torch.from_numpy(a).requires_grad_(True) for a in (gamma, beta)]
        out, mu, var = fused_bn_pool_leaky(*leaves)
        assert out.dtype == dt
        out.backward(torch.from_numpy(g).to(dt))
        assert leaves[0].grad.dtype == dt
        res[("port", dtype)] = (out, mu, var) + tuple(t.grad for t in leaves)
    for i, name in enumerate(("out", "mu", "var", "dy", "dgamma", "dbeta")):
        if name in ("mu", "var"):  # fp32 sums of the same values
            np.testing.assert_allclose(_f32(res[("port", "float16")][i]),
                                       _f32(res[("jax", "float16")][i]),
                                       rtol=1e-5, atol=1e-7)
            continue
        check_ratio(f"K5 {name}", res[("port", "float16")][i],
                    res[("jax", "float16")][i], res[("jax", "float32")][i],
                    res[("port", "float32")][i] if name in ("out", "dy")
                    else None)


# ------------------------------------------------------------ the fusion model

def _jax_fusion(cfg, dtype):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFusion(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla", dtype=JAX_DT[dtype])


@functools.lru_cache(maxsize=None)
def fusion_weights(seed=2026):
    return weights(_leaf_shapes("fusion"), seed)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fusion_forward_fp16_tracks_jax(train):
    """The fusion model's window forward in eval and train mode against
    flax's at fp16, every output."""
    cfg = RunConfig(**FUSION).replace(fusion_encode="window")
    tree = fusion_weights()
    r = np.random.default_rng(5)
    t_stft = cfg.hops_per_frame * cfg.num_frames
    inputs = (r.standard_normal((4, 2, t_stft, 32)).astype(np.float32),
              r.standard_normal((4, 1, 4, 256)).astype(np.float32))
    res = {}
    for dtype in DTYPES:
        model = _jax_fusion(cfg, dtype)
        with _env(JAX_ENV):
            fn = jax.jit(lambda v, a, b: tuple(
                o.astype(jnp.float32) for o in model.apply(
                    v, a, b, train, mutable=["batch_stats"])[0]))
            res[("jax", dtype)] = fn(_lstm_f16(tree, dtype), *inputs)
        _, port, _ = _port_fusion(cfg, tree, dtype)
        port.train(train)
        with torch.no_grad():
            res[("port", dtype)] = port(*[torch.from_numpy(x)
                                          for x in inputs])
    for i, name in enumerate(("a", "v", "fused")):
        assert res[("port", "float16")][i].dtype == F16
        check_ratio(f"fusion {name}", res[("port", "float16")][i],
                    res[("jax", "float16")][i], res[("jax", "float32")][i],
                    res[("port", "float32")][i],
                    TRAIN_RATIO if train else MODEL_RATIO)


@functools.lru_cache(maxsize=None)
def _frames_weights():
    return weights(_leaf_shapes("frames"))


def test_frames_heads_fp16_track_jax():
    """The frames model's eval forward past its visual encoder
    (`forward_with_visual_latent`: the STFT encoder, the LSTM over the
    channels, fc1 and fc2 with tanh, the heads' tanh and sigmoid ending in
    fp16) at fp16 against flax's, every output, from one visual latent."""
    from maavss_tpu.models.fusion_frames import AVFusionFramesModel
    from maavss_tpu_torch.models.shape_plan import (
        frames_visual_encoder_out_hw,
    )
    from maavss_tpu_torch.train.setup import build_frames_model

    cfg = RunConfig(**FRAMES)
    tree = _frames_weights()
    r = np.random.default_rng(6)
    t_stft = cfg.hops_per_frame * cfg.num_frames
    stft_shape = (4, 2, t_stft, cfg.fft_len // 2 + 1)
    frame_shape = (4, 1, cfg.num_frames, cfg.framesize, cfg.framesize)
    res = {}
    for dtype in DTYPES:
        with _env(PORT_ENV):
            port = build_frames_model(cfg.replace(dtype=dtype), 4,
                                      latent_channels=FRAMES_LATENT,
                                      device="cpu")
        port.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
        if dtype == "float16":
            hw = frames_visual_encoder_out_hw(cfg.framesize)
            x_a = r.standard_normal(stft_shape).astype(np.float32)
            x_v = _round(r.standard_normal(
                (4, FRAMES_LATENT, cfg.num_frames, hw * hw)).astype(
                    np.float32))
        model = AVFusionFramesModel(
            stft_shape=stft_shape, frame_shape=frame_shape,
            hops_per_frame=cfg.hops_per_frame,
            latent_channels=FRAMES_LATENT, dtype=JAX_DT[dtype])
        xv = jnp.asarray(x_v, JAX_DT[dtype])
        with _env(JAX_ENV):
            res[("jax", dtype)] = jax.jit(lambda v, a, b: tuple(
                o.astype(jnp.float32) for o in model.apply(
                    v, a, b, False,
                    method=model.forward_with_visual_latent)))(
                _lstm_f16(tree, dtype), x_a, xv)
        with torch.no_grad():
            res[("port", dtype)] = port.eval().forward_with_visual_latent(
                torch.from_numpy(x_a), torch.from_numpy(x_v).to(
                    port.dtype))
        assert all(o.dtype == port.dtype for o in res[("port", dtype)])
    for i, name in enumerate(("a", "v", "fused")):
        check_ratio(f"frames {name}", res[("port", "float16")][i],
                    res[("jax", "float16")][i], res[("jax", "float32")][i],
                    res[("port", "float32")][i], MODEL_RATIO)


@functools.lru_cache(maxsize=None)
def _rows_batch():
    b = fusion_batch(JaxRunConfig(**FUSION))
    return {"audio": b["audio"], "pgram": b["pgram"]}


@functools.lru_cache(maxsize=None)
def _jax_separate(dtype):
    """JAX's full-encode separator's audio on `_rows_batch` from
    `fusion_weights`, at `dtype`: one compile a dtype, cached."""
    jcfg = JaxRunConfig(**FUSION)
    with _env(JAX_ENV):
        separate = jax_make_separator(_jax_fusion(jcfg, dtype), jcfg)
        v = _lstm_f16(fusion_weights(), dtype)
        state = create_train_state(
            {"params": v["params"], "batch_stats": v["batch_stats"]},
            make_optimizer(FUSION["learning_rate"], "adam"))
        return np.asarray(separate(
            state, {k: jnp.asarray(a) for k, a in _rows_batch().items()},
            jax.random.PRNGKey(0))["audio_out"])


def test_fusion_separator_fp16_tracks_jax():
    """The full-encode separator on float16 rows, fp16, against JAX's."""
    cfg = RunConfig(**FUSION)
    tree = fusion_weights()
    batch = _rows_batch()
    res = {}
    for dtype in DTYPES:
        res[("jax", dtype)] = _jax_separate(dtype)
        _, model, _ = _port_fusion(cfg, tree, dtype)
        res[("port", dtype)] = make_separator(model, cfg.replace(
            dtype=dtype))({k: torch.from_numpy(a) for k, a in
                           batch.items()})["audio_out"]
        assert res[("port", dtype)].dtype == torch.float32
    check_ratio("separator audio", res[("port", "float16")],
                res[("jax", "float16")], res[("jax", "float32")],
                res[("port", "float32")], MODEL_RATIO)


def _nonfinite(flat):
    """{path: non-finite elements} of the leaves that have any."""
    out = {}
    for k, a in flat.items():
        n = int(np.size(a) - np.isfinite(np.asarray(a, np.float32)).sum())
        if n:
            out[k] = n
    return out


@functools.lru_cache(maxsize=None)
def _jax_fusion_step(dtype):
    """JAX's first fusion step (--opt_kernel pallas's Adam) from
    `fusion_weights` on `_rows_batch` at `dtype`: (metrics, the flat
    params and Adam first moment after it), cached."""
    cfg = JaxRunConfig(**FUSION).replace(pgenc_kernel="xla")
    with _env(JAX_ENV):
        step = j_steps.make_fusion_step(_jax_fusion(cfg, dtype), cfg)
        v = _lstm_f16(fusion_weights(), dtype)
        state = create_train_state(
            {"params": v["params"], "batch_stats": v["batch_stats"]},
            make_optimizer(FUSION["learning_rate"], "adam", kernel="pallas"))
        state, m = step(state, {k: jnp.asarray(a) for k, a in
                                _rows_batch().items()},
                        jax.random.PRNGKey(0), jnp.int32(MODE))
    return ({k: float(a) for k, a in m.items()},
            flatten_tree(jax.tree_util.tree_map(_f32, {
                "params": state.params, "m": state.opt_state.m})))


def _port_fusion_step(dtype, tree, batch):
    cfg = RunConfig(**FUSION).replace(pgenc_kernel="xla", dtype=dtype)
    cfg, model, state = _port_fusion(cfg, tree, dtype, train=True)
    state, m = steps.make_fusion_step(model, cfg, device="cpu")(
        state, batch, MODE)
    names = [n for n, _ in model.named_parameters()]
    params = to_flax(model.state_dict())[0]
    mom = to_flax(dict(zip(names, state.tx.m)))[0]
    return ({k: float(a) for k, a in m.items()},
            {k: np.array(a) for k, a in flatten_tree(
                {"params": params, "m": mom}).items()}, model)


def test_fusion_step_fp16_tracks_jax_and_breaks_the_lstm():
    """The fp16 full-encode fusion step's first step against JAX's: the
    losses, the gradients through Adam's first moment, the fp32 leaves'
    updates; then the reference's fault on both sides: the four fp16 LSTM
    leaves, and only they, are non-finite in every element."""
    tree = fusion_weights()
    batch = _rows_batch()
    runs = {("jax", d): _jax_fusion_step(d) for d in DTYPES}
    runs.update({("port", d): _port_fusion_step(d, tree, batch)[:2]
                 for d in DTYPES})
    losses = {k: np.array([m[n] for n in ("loss", "a_loss", "v_loss")])
              for k, (m, _) in runs.items()}
    np.testing.assert_allclose(losses[("port", "float16")],
                               losses[("jax", "float16")], rtol=LOSS_RTOL)
    assert not np.array_equal(losses[("port", "float16")],
                              losses[("port", "float32")])
    ph, jh, jf, pf = (runs[k][1] for k in (
        ("port", "float16"), ("jax", "float16"), ("jax", "float32"),
        ("port", "float32")))
    init = flatten_tree(tree)
    _, model, _ = _port_fusion(RunConfig(**FUSION), tree, "float32")
    fed = {"params/" + n.replace(".", "/") for n in model.bn_fed_biases()}
    lstm = sorted(k for k in jh if k.startswith("params/")
                  and k.endswith(LSTM_LEAVES))
    assert len(lstm) == 4
    moments = [k for k in jh if k.startswith("m/")
               and "params/" + k[2:] not in fed]
    check_ratio("fusion gradients (Adam's m)", _cat(ph[k] for k in moments),
                _cat(jh[k] for k in moments), _cat(jf[k] for k in moments),
                _cat(pf[k] for k in moments), GRAD_RATIO)
    f32_leaves = [k for k in jh if k.startswith("params/") and k not in fed
                  and k not in lstm]
    check_ratio("fusion fp32 leaves' updates",
                _cat(ph[k] - init[k] for k in f32_leaves),
                _cat(jh[k] - init[k] for k in f32_leaves),
                _cat(jf[k] - init[k] for k in f32_leaves), None, GRAD_RATIO)
    sizes = {k: int(np.size(jh[k])) for k in lstm}
    for side in ("port", "jax"):
        bad = _nonfinite(runs[(side, "float16")][1])
        assert bad == sizes, (side, bad)
        assert not _nonfinite(runs[(side, "float32")][1]), side


def test_jax_pickle_carries_fp16_leaves(tmp_path):
    """A JAX `save_model` pickle of an fp16 model (the LSTM leaves numpy
    float16) loads into the port's fp16 model, every leaf exact."""
    tree = fusion_weights()
    params = _lstm_f16(tree, "float16")["params"]
    host = jax.tree_util.tree_map(np.asarray, params)
    assert host["lstm"]["fwd"]["w_h"].dtype == np.float16
    path = tmp_path / "m.params.pkl"
    with open(path, "wb") as f:
        pickle.dump(host, f)
    model = build_fusion(RunConfig(**FUSION).replace(dtype="float16"), 4,
                         "cpu")
    load_model(str(path), model)
    got = flatten_tree(to_flax(model.state_dict())[0])
    for k, a in flatten_tree(host).items():
        np.testing.assert_array_equal(got[k], np.asarray(a, np.float32))
    assert model.lstm.fwd.w_h.dtype == F16


# ------------------------------------------------------ autoencoder regimes

AE = {"audio": (j_steps.make_audio_ae_step, steps.make_audio_ae_step),
      "visual": (j_steps.make_visual_ae_step, steps.make_visual_ae_step)}


def _ae_batches(cfg):
    from tests.test_torch_regimes import _batch

    return [_batch(cfg, 11 + i) for i in range(AE_STEPS)]


@pytest.mark.parametrize("kind", ["audio", "visual"])
def test_autoencoder_regime_fp16_tracks_jax(kind):
    """The STFT and phasegram autoencoder steps, fp16, 3 steps from one
    tree against JAX's: the losses within AE_LOSS_RTOL of JAX's fp16 ones
    and not the port's fp32 ones; they train; and the LSTM, unused here,
    ends non-finite on both sides (0/0), every other leaf finite."""
    jcfg = JaxRunConfig(**AE_GEOMETRY)
    t_stft = jcfg.hops_per_frame * jcfg.num_frames
    jmodel = JaxFusion(
        stft_shape=(jcfg.batch_size, 2, t_stft, jcfg.fft_len // 2),
        pgram_shape=(jcfg.batch_size, 1, jcfg.num_frames, jcfg.p_size ** 2),
        latent_channels=jcfg.latent_chan, fc_size=jcfg.fc_size,
        pgenc_kernel="xla", dtype=jnp.float16)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros(jmodel.stft_shape),
        jnp.zeros(jmodel.pgram_shape), method=jmodel.init_all))
    tree = weights(_shapes({"params": shapes["params"],
                            "batch_stats": shapes["batch_stats"]}), seed=3)
    batches = _ae_batches(jcfg)
    with _env(JAX_ENV):
        jstep = AE[kind][0](jmodel, jcfg)
        v = _lstm_f16(tree, "float16")
        state = create_train_state(
            {"params": v["params"], "batch_stats": v["batch_stats"]},
            make_optimizer(jcfg.learning_rate, "adam"))
        want = []
        for b in batches:
            state, m = jstep(state, jax.tree_util.tree_map(jnp.asarray, b),
                             jax.random.PRNGKey(0), jnp.int32(2))
            want.append(float(m["loss"]))
    jbad = _nonfinite(flatten_tree(jax.tree_util.tree_map(_f32,
                                                          state.params)))
    got = {}
    for dtype in DTYPES:
        cfg = RunConfig(**AE_GEOMETRY).replace(dtype=dtype)
        model, pstate = build_fusion_state(cfg, cfg.batch_size, "cpu")
        model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
        pstep = AE[kind][1](model, cfg, device="cpu")
        got[dtype] = []
        for b in batches:
            pstate, m = pstep(pstate, b, 2)
            got[dtype].append(float(m["loss"]))
        if dtype == "float16":
            pbad = _nonfinite(flatten_tree(to_flax(model.state_dict())[0]))
    np.testing.assert_allclose(got["float16"], want, rtol=AE_LOSS_RTOL)
    assert got["float16"] != got["float32"]
    assert want[-1] < want[0] and got["float16"][-1] < got["float16"][0]
    lstm = {k: int(np.prod(s)) for k, s in _shapes(
        shapes["params"]).items() if k.endswith(LSTM_LEAVES)}
    assert len(lstm) == 4
    assert jbad == lstm and pbad == lstm, (jbad, pbad)


# ----------------------------------------------------------------- golden

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "torch_port_fp16_golden.npz")
SEED = 2026
# the golden's step-1 loss gate (on the card the convs, products and the
# STFT run as cuDNN, cuBLAS and the STFT kernel compute them)
GOLDEN_LOSS_RTOL = 1e-4


def make_golden(path: str = GOLDEN) -> None:
    """Write the fixture: the weights as a seeded recipe (fp16 LSTM
    leaves), the batch (audio and float16 rows), JAX's full-encode
    separator audio in fp16 and fp32, and JAX's first fusion step's losses
    in both, with the non-finite elements of each leaf after it."""
    shapes = _leaf_shapes("fusion")
    flat = flatten_tree(fusion_weights(SEED))
    batch = _rows_batch()
    meta = {"cfg": dict(FUSION, dtype="float16"), "seed": SEED,
            "shapes": {k: list(v) for k, v in shapes.items()},
            "checksums": {k: float(np.asarray(v, np.float64).sum())
                          for k, v in flat.items()},
            "mode": MODE, **BATCH}
    for d in DTYPES:
        metrics, after = _jax_fusion_step(d)
        meta[f"losses_{d}"] = [metrics[k] for k in ("loss", "a_loss",
                                                     "v_loss")]
        meta[f"nonfinite_{d}"] = {k[len("params/"):]: n for k, n in
                                  _nonfinite(after).items()
                                  if k.startswith("params/")}
    np.savez_compressed(path, meta=json.dumps(meta), audio=batch["audio"],
                        pgram=batch["pgram"],
                        audio_out=_jax_separate("float16"),
                        audio_out_f32=_jax_separate("float32"))


def _load_golden():
    with np.load(GOLDEN) as z:
        return json.loads(str(z["meta"])), {k: z[k] for k in z.files
                                            if k != "meta"}


def golden_gates(audio_out, losses, nonfinite, meta, arrays):
    """The fp16 golden's gates, shared with chip_smoke.py's fp16_golden:
    the separator's audio within MODEL_RATIO of JAX's fp16-vs-fp32
    distance, the first step's losses within GOLDEN_LOSS_RTOL of JAX's fp16
    ones, and after it the same leaves non-finite in the same count of
    elements ({flax path: count}). Returns (audio ratio, largest loss
    difference relative)."""
    near = _rel(audio_out, arrays["audio_out"])
    base = _rel(arrays["audio_out"], arrays["audio_out_f32"])
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                  meta["losses_float16"]))
    assert near <= MODEL_RATIO * base, (near, base)
    assert rel <= GOLDEN_LOSS_RTOL, (losses, meta["losses_float16"])
    assert nonfinite == meta["nonfinite_float16"], nonfinite
    return near / base, rel


def test_golden_matches_jax():
    """The fixture is what the JAX package computes on the CPU: its
    weights regenerate, its audio and losses are JAX's, and JAX's first
    fp16 step leaves the four LSTM leaves non-finite and nothing else."""
    meta, arrays = _load_golden()
    flat = flatten_tree(fusion_weights(meta["seed"]))
    assert set(flat) == set(meta["checksums"])
    for k, total in meta["checksums"].items():
        assert np.isclose(np.asarray(flat[k], np.float64).sum(), total,
                          rtol=1e-6, atol=1e-6), k
    np.testing.assert_array_equal(_rows_batch()["pgram"], arrays["pgram"])
    assert os.path.getsize(GOLDEN) < 200_000
    for d, key in (("float16", "audio_out"), ("float32", "audio_out_f32")):
        assert _rel(_jax_separate(d), arrays[key]) <= 1e-6, d
        metrics, _ = _jax_fusion_step(d)
        np.testing.assert_allclose([metrics[k] for k in ("loss", "a_loss",
                                                         "v_loss")],
                                   meta[f"losses_{d}"], rtol=1e-6)
    assert sorted(meta["nonfinite_float16"]) == [
        "lstm/bwd/w_h", "lstm/bwd/w_i", "lstm/fwd/w_h", "lstm/fwd/w_i"]
    assert not meta["nonfinite_float32"]


def test_port_matches_golden_on_cpu():
    """The port's plain path on the fixture, under chip_smoke.py's
    fp16_golden gates."""
    meta, arrays = _load_golden()
    cfg = RunConfig(**meta["cfg"])
    tree = fusion_weights(meta["seed"])
    model, state = build_fusion_state(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    batch = {"audio": torch.from_numpy(arrays["audio"]),
             "pgram": torch.from_numpy(arrays["pgram"])}
    audio = make_separator(model, cfg)(batch)["audio_out"].numpy()
    state, m = steps.make_fusion_step(model, cfg, device="cpu")(
        state, batch, meta["mode"])
    bad = _nonfinite(flatten_tree(to_flax(model.state_dict())[0]))
    golden_gates(audio, [float(m[k]) for k in ("loss", "a_loss", "v_loss")],
                 bad, meta, arrays)


if __name__ == "__main__":
    make_golden()
    print(f"wrote {GOLDEN}")
