"""The legacy raw-FFT family of the port against the JAX package on the CPU
(maavss_tpu_torch/ops/fft_legacy.py, data/generator.py, models/legacy.py,
tools/train_legacy_torch.py, the transposed-conv mapping of convert.py).

Same numpy inputs on both sides; weights are seeded numpy trees
(`convert.random_flax_tree`, BN running statistics included) carried
across by `convert.from_flax`. One JAX compile per geometry, cached for
the module.

- fft_legacy: every function in fp32 within 1e-5 relative to the largest
  value; polar phases as wrapped differences on bins whose magnitude is
  above 1e-3 of the largest, each times its magnitude within 1e-5 of the
  largest (a phase alone moves as the rounding over the magnitude).
- DataGenerator: two batches from one seed on an on-disk store: frames and
  audio bit for bit, the noise bit for bit (x = y + noise, with the noise
  replayed from the seed), the features within 1e-5.
- AVModelSTFT at two small geometries (the visual latent pooled, and the
  audio latent pooled): the forward and train_ae=True (audio_ae_forward
  and visual_ae_forward, which the port's eval-mode outputs equal bit for
  bit) in eval mode and in train mode (running statistics after the two
  train-mode calls), and the input and weight gradients of one scalar over
  the train-mode forward's outputs (pool_visual's), within 1e-4 (a weight
  gradient relative to the largest of its layer's, the biases ahead of a
  train-mode BatchNorm having gradients that only rounding sets, plus
  twice the rounding of the port's fp32 gradient against its float64
  one).
- The transposed convs, 2-D and 3-D, with the stride above the kernel
  (lax's extra row and column) and below it.
- main.py's SGD step against tools/train_legacy_torch.py's, 3 steps:
  losses within 1e-5 relative, step 1's outputs and input and weight
  gradients within 1e-4, the leaves after 3 steps within 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.audio_memmap import AudioMemmap as JaxAudio
from maavss_tpu.data.frame_shards import FrameShardStore as JaxFrames
from maavss_tpu.models import legacy as j_legacy
from maavss_tpu.ops import fft_legacy as j_fft
from generator import DataGenerator as JaxGenerator
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    from_flax,
    random_flax_tree,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.data.audio_memmap import AudioMemmap
from maavss_tpu_torch.data.frame_shards import FrameShardStore
from maavss_tpu_torch.data.generator import DataGenerator
from maavss_tpu_torch.data.synthetic import build_synthetic_store
from maavss_tpu_torch.models import legacy
from maavss_tpu_torch.models.layers import TorchBatchNorm
from maavss_tpu_torch.ops import fft_legacy
from maavss_tpu_torch.train.state import make_optimizer
from tests.test_torch_workers import share_cores
from tools import train_legacy_torch

share_cores()


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err} > {tol}"


def _phase_close(mag, got, want, tol=1e-5):
    """Phases as wrapped differences on the bins above 1e-3 of the largest
    magnitude, each times its bin's magnitude (the move of the complex
    value) within `tol` of the largest magnitude."""
    big = mag > 1e-3 * mag.max()
    dphi = np.abs(np.angle(np.exp(1j * (got - want))))
    assert (dphi * mag)[big].max() <= tol * mag.max()


def _t(a):
    return torch.from_numpy(np.array(a))


def _abstract_tree(init):
    """{path: shape} of a flax init's variables, and a seeded numpy tree
    of those shapes (params and batch_stats)."""
    abstract = jax.eval_shape(init, jax.random.PRNGKey(0))
    shapes = {"/".join(str(k.key) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  abstract)[0]}
    tree = unflatten_tree(random_flax_tree(shapes, 0))
    return tree["params"], tree.get("batch_stats", {})


# ---- fft_legacy ----

@pytest.fixture(scope="module")
def audio():
    return np.random.default_rng(0).standard_normal((3, 256)).astype(
        np.float32)


@pytest.mark.parametrize("normalize", [True, False])
def test_fft_half_and_inverse(audio, normalize):
    f_j = np.asarray(j_fft.fft_half(jnp.asarray(audio), normalize))
    f_p = fft_legacy.fft_half(_t(audio), normalize)
    _close(f_p.numpy().real, f_j.real, 1e-5, "re")
    _close(f_p.numpy().imag, f_j.imag, 1e-5, "im")
    _close(fft_legacy.ifft_half(f_p, normalize).numpy(),
           j_fft.ifft_half(jnp.asarray(f_j), normalize), 1e-5, "ifft")


def test_channel_forms(audio):
    f = np.asarray(j_fft.fft_half(jnp.asarray(audio)))
    ri = np.asarray(j_fft.complex_to_ri(jnp.asarray(f)))
    ri_p = fft_legacy.complex_to_ri(_t(f))
    _close(ri_p.numpy(), ri, 1e-5, "ri")
    c = fft_legacy.ri_to_complex(_t(ri)).numpy()
    np.testing.assert_array_equal(c, np.asarray(j_fft.ri_to_complex(
        jnp.asarray(ri))))
    pol_j = np.asarray(j_fft.cartesian_to_polar(jnp.asarray(f)))
    pol_p = fft_legacy.cartesian_to_polar(_t(f)).numpy()
    _close(pol_p[..., 0, :], pol_j[..., 0, :], 1e-5, "mag")
    _phase_close(pol_j[..., 0, :], pol_p[..., 1, :], pol_j[..., 1, :])
    _close(fft_legacy.polar_to_cartesian(_t(pol_j)).numpy(),
           j_fft.polar_to_cartesian(jnp.asarray(pol_j)), 1e-5, "polar->ri")
    cen = np.asarray(j_fft.center_fft_bins(jnp.asarray(ri)))
    np.testing.assert_array_equal(fft_legacy.center_fft_bins(_t(ri)).numpy(),
                                  cen)
    np.testing.assert_array_equal(
        fft_legacy.decenter_fft_bins(_t(cen)).numpy(),
        np.asarray(j_fft.decenter_fft_bins(jnp.asarray(cen))))


@pytest.mark.parametrize("polar,center", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_process_and_inference(audio, polar, center):
    feats_j = np.asarray(j_fft.process_fft(jnp.asarray(audio), polar=polar,
                                           center=center))
    feats_p = fft_legacy.process_fft(_t(audio), polar=polar,
                                     center=center).numpy()
    if polar:  # channel 0 magnitude, channel 1 phase (wrapped)
        _close(feats_p[:, 0], feats_j[:, 0], 1e-5, "mag")
        _phase_close(feats_j[:, 0], feats_p[:, 1], feats_j[:, 1])
    else:
        _close(feats_p, feats_j, 1e-5, "features")
    out_j = j_fft.inference_to_audio(jnp.asarray(feats_j), polar=polar,
                                     center=center)
    out_p = fft_legacy.inference_to_audio(_t(feats_j), polar=polar,
                                          center=center)
    _close(out_p.numpy(), out_j, 1e-5, "inference_to_audio")


# ---- DataGenerator ----

def _replay_noise(cfg, frames, seed, batches, shape):
    """The noise of each batch, drawn as the generators draw it."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        for _ in range(cfg.batch_size):
            v = int(rng.integers(0, len(frames)))
            rng.integers(0, frames.num_frames(v) - cfg.num_frames + 1)
        out.append(rng.normal(0, cfg.noise_scalar, shape).astype(np.float32))
    return out


@pytest.mark.parametrize("use_polar", [False, True])
def test_data_generator_matches_jax(tmp_path, use_polar):
    kw = dict(num_frames=4, batch_size=3, p_size=16, fft_len=64,
              use_polar=use_polar, noise_scalar=0.1)
    cfg = RunConfig(**kw)
    build_synthetic_store(str(tmp_path), cfg, n_videos=3, seconds=1.0,
                          frame_size=16)
    fdir, adir = str(tmp_path / "frames"), str(tmp_path / "audio")
    gen_p = DataGenerator(cfg, FrameShardStore(fdir), AudioMemmap(adir),
                          seed=7).generator()
    gen_j = JaxGenerator(JaxRunConfig(**kw), JaxFrames(fdir), JaxAudio(adir),
                         seed=7).generator()
    got = [next(gen_p) for _ in range(2)]
    want = [next(gen_j) for _ in range(2)]
    noise = _replay_noise(cfg, FrameShardStore(fdir), 7, 2,
                          got[0][1].shape)
    for (xp, yp, fp, ap), (xj, yj, fj, aj), n in zip(got, want, noise):
        np.testing.assert_array_equal(fp, fj)
        np.testing.assert_array_equal(ap, aj)
        np.testing.assert_array_equal(xp, yp + n)
        np.testing.assert_array_equal(xj, yj + n)
        if use_polar:
            _close(yp[:, 0], yj[:, 0], 1e-5, "mag")
            _phase_close(yj[:, 0], yp[:, 1], yj[:, 1])
        else:
            _close(yp, yj, 1e-5, "y_fft")
        assert xp.shape == (3, 2, cfg.hop * cfg.hops_per_frame * 4 // 2)
        assert fp.shape == (3, 1, 4, 16, 16) and fp.dtype == np.float32


# ---- the transposed convs ----

@pytest.mark.parametrize("rank,kernel,stride,padding,in_size,out_size", [
    (2, (3, 3), (4, 4), (1, 1), (3, 2), (12, 8)),   # stride > kernel
    (2, (5, 5), (1, 2), (2, 2), (3, 4), (12, 32)),  # audio_up3's crop + pad
    (3, (3, 3, 3), (1, 4, 4), (1, 1, 1), (2, 2, 3), (2, 8, 12)),  # video_up1
    (3, (3, 3, 3), (1, 2, 2), (1, 1, 1), (2, 3, 2), (2, 6, 4)),
])
def test_conv_transpose_matches_flax(rank, kernel, stride, padding, in_size,
                                     out_size):
    j_cls = j_legacy.ConvTranspose2dTorch if rank == 2 else \
        j_legacy.ConvTranspose3dTorch
    p_cls = legacy.ConvTranspose2dTorch if rank == 2 else \
        legacy.ConvTranspose3dTorch
    x = np.random.default_rng(rank).standard_normal(
        (2, 3) + in_size).astype(np.float32)
    jm = j_cls(4, kernel, stride, padding)
    params, _ = _abstract_tree(lambda k: jm.init(k, jnp.asarray(x), out_size))
    want = jm.apply({"params": params}, jnp.asarray(x), out_size)
    pm = p_cls(3, 4, kernel, stride, padding)
    pm.load_state_dict(from_flax(params), strict=True)
    got = pm(_t(x), out_size)
    assert tuple(got.shape) == tuple(want.shape) == (2, 4) + out_size
    _close(got.detach().numpy(), want, 1e-5, "conv_transpose")
    # the converter's flip and its inverse, on a 2-D and a 3-D kernel
    k = params["ConvTranspose_0"]["kernel"]
    back, _ = to_flax(from_flax(params))
    np.testing.assert_array_equal(back["ConvTranspose_0"]["kernel"], k)
    w = from_flax(params)["ConvTranspose_0.weight"].numpy()
    spatial = tuple(range(rank))
    np.testing.assert_array_equal(
        w, np.flip(k, spatial).transpose((rank, rank + 1) + spatial))


# ---- AVModelSTFT ----

GEOMETRIES = {  # (stft_shape, v_shape, alpha, gradients held)
    # the visual latent pooled (pool_v, pool_div 2)
    "pool_visual": ((2, 2, 12, 64), (2, 1, 3, 16, 16), 3, True),
    # the audio latent pooled (spatial latent 1, pool_div 2); its layers
    # are pool_visual's, so its gradients are not taken again
    "pool_audio": ((2, 2, 12, 16), (2, 1, 3, 16, 16), 3, False),
}


def _paths(mod, xa, xv, train):
    """The forward and train_ae=True, which returns (audio_ae_forward,
    visual_ae_forward)."""
    return (mod(xa, xv, train=train), mod(xa, xv, train=train, train_ae=True))


def _port_paths(model, xa, xv):
    return (model(xa, xv), model(xa, xv, train_ae=True))


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def stft_case(request):
    """One JAX compile a geometry: the eval-mode outputs, the train-mode
    outputs, running statistics and the gradients of sum(out * cot) (None
    where the geometry holds none)."""
    stft_shape, v_shape, alpha, with_grads = GEOMETRIES[request.param]
    m = j_legacy.AVModelSTFT(stft_shape=stft_shape, v_shape=v_shape,
                             alpha=alpha)
    params, stats = _abstract_tree(lambda k: m.init(
        k, jnp.zeros(stft_shape), jnp.zeros(v_shape)))
    rng = np.random.default_rng(1)
    xa = rng.standard_normal(stft_shape).astype(np.float32)
    xv = rng.random(v_shape).astype(np.float32)
    out_shapes = jax.eval_shape(lambda v: m.apply(
        v, jnp.zeros(stft_shape), jnp.zeros(v_shape), False, method=_paths),
        {"params": params, "batch_stats": stats})
    cots = [rng.standard_normal(o.shape).astype(np.float32)
            for o in out_shapes[0]]

    @jax.jit
    def run(params, stats, xa, xv, cots):
        v = {"params": params, "batch_stats": stats}
        ev = m.apply(v, xa, xv, False, method=_paths)

        def scalar(params, xa, xv):
            outs, mut = m.apply({"params": params, "batch_stats": stats},
                                xa, xv, True, method=_paths,
                                mutable=["batch_stats"])
            s = sum(jnp.sum(o * c) for o, c in zip(outs[0], cots))
            return s, (outs, mut["batch_stats"])

        if not with_grads:
            _, (outs, new_stats) = scalar(params, xa, xv)
            return ev, outs, new_stats, None
        (_, (outs, new_stats)), grads = jax.value_and_grad(
            scalar, argnums=(0, 1, 2), has_aux=True)(params, xa, xv)
        return ev, outs, new_stats, grads

    res = jax.tree_util.tree_map(np.asarray,
                                 run(params, stats, xa, xv, cots))
    model = legacy.AVModelSTFT(stft_shape, v_shape, alpha)
    model.load_state_dict(from_flax(params, stats), strict=True)
    return request.param, model, (xa, xv, cots), res


def _float64_grads(model, xa, xv, cots):
    """The gradients of the train-mode scalar, from a float64 copy of
    `model`."""
    m64 = legacy.AVModelSTFT(model.stft_shape, model.v_shape,
                             len(model.audio_enc_convs)).double()
    m64.load_state_dict(model.state_dict())
    for mod in m64.modules():
        if isinstance(mod, TorchBatchNorm):
            mod.dtype = torch.float64
    m64.train()
    outs = m64(_t(xa).double(), _t(xv).double())
    sum((o * _t(c).double()).sum() for o, c in zip(outs, cots)).backward()
    return {k: p.grad for k, p in m64.named_parameters()}


def test_avmodel_stft_eval_matches_jax(stft_case):
    name, model, (xa, xv, _), (ev, _, _, _) = stft_case
    model.eval()
    with torch.no_grad():
        got = jax.tree_util.tree_leaves(_port_paths(model, _t(xa), _t(xv)))
        ae = (model.audio_ae_forward(_t(xa)), model.visual_ae_forward(_t(xv)))
    want = jax.tree_util.tree_leaves(ev)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w, 1e-4, f"{name} eval output {i}")
    for g, w in zip(ae, got[2:]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_avmodel_stft_train_and_grads_match_jax(stft_case):
    name, model, (xa, xv, cots), (_, outs, new_stats, grads) = stft_case
    model = legacy.AVModelSTFT(model.stft_shape, model.v_shape,
                               len(model.audio_enc_convs))
    model.load_state_dict(stft_case[1].state_dict())
    model.train()
    ta, tv = _t(xa).requires_grad_(), _t(xv).requires_grad_()
    got = jax.tree_util.tree_leaves(_port_paths(model, ta, tv))
    for i, (g, w) in enumerate(zip(got, jax.tree_util.tree_leaves(outs))):
        _close(g.detach().numpy(), w, 1e-4, f"{name} train output {i}")
    buffers = dict(model.named_buffers())
    for k, w in from_flax({}, new_stats).items():
        _close(buffers[k].numpy(), w.numpy(), 1e-4, f"{name} {k}")
    if grads is None:
        return
    sum((g * _t(c)).sum() for g, c in zip(got[:2], cots)).backward()
    g_params, g_xa, g_xv = grads
    _close(ta.grad.numpy(), g_xa, 1e-4, f"{name} d x_a")
    _close(tv.grad.numpy(), g_xv, 1e-4, f"{name} d x_v")
    want = from_flax(g_params)
    named = dict(model.named_parameters())
    # a gradient at the scale of its layer's largest (the biases of the
    # convs ahead of a train-mode BatchNorm have gradients near 0, 1e-5
    # against their kernels' 1-300, which only rounding sets), beyond twice
    # the rounding of the port's fp32 gradient against its float64 one
    # (a leaf behind the LayerNorm of three features cancels to 6e-4 of
    # itself in fp32, on both sides)
    g64 = _float64_grads(stft_case[1], xa, xv, cots)
    layer_scale = {}
    for k, w in want.items():
        layer = k.rsplit(".", 1)[0]
        layer_scale[layer] = max(layer_scale.get(layer, 0.0),
                                 float(w.abs().max()))
    for k, w in want.items():
        err = float((named[k].grad - w).abs().max())
        rounding = float((named[k].grad.double() - g64[k]).abs().max())
        assert err <= 1e-4 * layer_scale[k.rsplit(".", 1)[0]] \
            + 2 * rounding, (name, k, err, rounding)


# ---- AVSEModel and main.py's SGD step ----

A_SHAPE, V_SHAPE, LR, LOSS_COEFF = (2, 2, 256), (2, 1, 6, 32, 32), 0.05, 0.1


@pytest.fixture(scope="module")
def sgd_run():
    """3 steps of main.py's step (its loss_fn, optax.sgd), from a seeded
    tree, one jit: the metrics, step 1's outputs and gradients with
    respect to the parameters and both inputs, and the final leaves."""
    m = j_legacy.AVSEModel(a_shape=A_SHAPE, v_shape=V_SHAPE)
    params, _ = _abstract_tree(lambda k: m.init(
        k, jnp.zeros(A_SHAPE), jnp.zeros(V_SHAPE)))
    tx = optax.sgd(LR)

    @jax.jit
    def step(params, opt_state, x_a, y_a, x_v):
        def loss_fn(params, x_a, x_v):
            yh_a, yh_v = m.apply({"params": params}, x_a, x_v, train=True)
            a_loss = jnp.mean((yh_a - y_a) ** 2)
            v_loss = jnp.mean((yh_v - x_v) ** 2)
            return a_loss + LOSS_COEFF * v_loss, (a_loss, v_loss, yh_a, yh_v)

        (loss, (a_loss, v_loss, yh_a, yh_v)), grads = jax.value_and_grad(
            loss_fn, argnums=(0, 1, 2), has_aux=True)(params, x_a, x_v)
        updates, opt_state = tx.update(grads[0], opt_state, params)
        return (optax.apply_updates(params, updates), opt_state,
                {"loss": loss, "a_loss": a_loss, "v_loss": v_loss},
                (yh_a, yh_v), grads)

    rng = np.random.default_rng(2)
    batches = [(rng.standard_normal(A_SHAPE).astype(np.float32),
                0.1 * rng.standard_normal(A_SHAPE).astype(np.float32),
                rng.random(V_SHAPE).astype(np.float32)) for _ in range(3)]
    p, opt_state, metrics, first = params, tx.init(params), [], None
    for b in batches:
        p, opt_state, mets, outs, grads = step(p, opt_state, *b)
        metrics.append({k: float(v) for k, v in mets.items()})
        if first is None:
            first = jax.tree_util.tree_map(np.asarray, (outs, grads))
    return params, batches, metrics, first, jax.tree_util.tree_map(
        np.asarray, p)


def test_avse_model_step1_outputs_and_grads(sgd_run):
    params, batches, _, ((yh_a, yh_v), (g_params, g_xa, g_xv)), _ = sgd_run
    model = legacy.AVSEModel(A_SHAPE, V_SHAPE)
    model.load_state_dict(from_flax(params), strict=True)
    x_a, y_a, x_v = (_t(a) for a in batches[0])
    x_a.requires_grad_()
    x_v.requires_grad_()
    got_a, got_v = model(x_a, x_v)
    _close(got_a.detach().numpy(), yh_a, 1e-4, "a_out")
    _close(got_v.detach().numpy(), yh_v, 1e-4, "v_out")
    loss = torch.mean((got_a - y_a) ** 2) \
        + LOSS_COEFF * torch.mean((got_v - x_v) ** 2)
    loss.backward()
    _close(x_a.grad.numpy(), g_xa, 1e-4, "d x_a")
    _close(x_v.grad.numpy(), g_xv, 1e-4, "d x_v")
    named = dict(model.named_parameters())
    for k, w in from_flax(g_params).items():
        _close(named[k].grad.numpy(), w.numpy(), 1e-4, f"d {k}")


def test_legacy_sgd_trajectory_matches_main(sgd_run):
    params, batches, metrics, _, final = sgd_run
    model = legacy.AVSEModel(A_SHAPE, V_SHAPE)
    model.load_state_dict(from_flax(params), strict=True)
    tx = make_optimizer(list(model.named_parameters()), LR, "sgd")
    step = train_legacy_torch.make_legacy_step(model, tx, LOSS_COEFF)
    for b, want in zip(batches, metrics):
        got = step(*(_t(a) for a in b))
        for k, w in want.items():
            assert abs(float(got[k]) - w) <= 1e-5 * abs(w), (k, got[k], w)
    sd = model.state_dict()
    for k, w in from_flax(final).items():
        _close(sd[k].numpy(), w.numpy(), 1e-4, k)


def test_avse_geometry_at_main_full_size():
    """main.py's geometry (batch 4, hop 66 x 8 x 8 samples, 8 frames of
    256^2): the model plans on the meta device, ~272 M parameters, the
    flax tree's shapes."""
    cfg = RunConfig()
    n = cfg.hop * cfg.hops_per_frame * cfg.num_frames
    a_shape, v_shape = (4, 2, n // 2), (4, 1, cfg.num_frames, 256, 256)
    assert a_shape == (4, 2, 2112)
    m = j_legacy.AVSEModel(a_shape=a_shape, v_shape=v_shape)
    shapes = {"/".join(str(k.key) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  jax.eval_shape(lambda k: m.init(
                      k, jnp.zeros(a_shape), jnp.zeros(v_shape)),
                      jax.random.PRNGKey(0))["params"])[0]}
    with torch.device("meta"):
        model = legacy.AVSEModel(a_shape, v_shape)
    sd = model.state_dict()
    n_params = sum(int(np.prod(s)) for s in shapes.values())
    assert n_params == sum(v.numel() for v in sd.values())
    assert 2.7e8 < n_params < 2.75e8
    tree = unflatten_tree({k: np.zeros(s, np.float32) for k, s in
                           shapes.items() if "Dense_2" not in k})
    for k, v in from_flax(tree).items():
        assert tuple(v.shape) == tuple(sd[k].shape), k


def test_train_legacy_tool_runs_on_cpu(tmp_path, monkeypatch):
    """tools/train_legacy_torch.py end to end on the synthetic store at a
    small geometry: one metrics line a step, finite losses, and the same
    losses from the same seed twice."""
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--data_path", "synthetic:2", "-e", "1",
            "-s", "2", "-b", "2", "--num_frames", "4", "--p_size", "32",
            "-lr", "0.01", "--seed", "3"]
    runs = []
    for run in ("a", "b"):
        log_dir = tmp_path / run
        train_legacy_torch.main(argv + ["--log_dir", str(log_dir)])
        (name,) = os.listdir(log_dir)
        with open(log_dir / name / "metrics.jsonl") as f:
            runs.append([json.loads(line)["loss"] for line in f])
    assert len(runs[0]) == 2
    assert all(np.isfinite(runs[0])) and runs[0] == runs[1]
