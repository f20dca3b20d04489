"""The port's --fusion_encode full path (maavss_tpu_torch/train/steps.py,
train/infer.py, exp/export.py) against the JAX package's, on the CPU, with
raw frames and with --pgram_cache phasegram rows; and the JAX fixture that
ties the path on the card to the reference:
tests/fixtures/torch_port_fullenc_golden.npz.

Both sides start from one seeded weight tree (`convert.random_flax_tree`
over the flax model's leaf shapes, as torch_port_train_golden.npz) and
take the same batch: `synthetic_av_batch(seed=11)` with broadband frame
noise (numpy seed 99, scale 0.1; smooth blob frames have FFT bins whose
phase is numerically arbitrary, tests/test_torch_train_step.py). The rows
are the JAX package's `phasegram_cumsum` of those frames cast to float16,
as bench.py makes them, and both sides read the same rows. Geometry:
tests/test_fusion_fullenc.py:30-32's (num_seq 2) and num_seq 4, batch 4,
lr 1e-3, noise_scalar 0, mode 2.

The train step: 3 steps, losses at relative 1e-5 (mode 2 tracks to ~1e-6,
test_torch_train_step.py). After step 1: every parameter and BatchNorm
statistic at relative L2 1e-4, and the gradient itself through Adam's first
moment (0.1 * g after one step) at relative L2 1e-4 per leaf, so that the
window stacks are held to route each window's gradient back into the one
encoder output; the global and per-module gradient norms at 1e-4. The
conv biases that feed a train-mode BatchNorm (`bn_fed_biases`: true
gradient 0, autodiff noise that Adam turns into +-lr) are held within lr
of their start on each side, and their gradients are not compared. The
phasegram encoder runs as ConvStack ('xla') and as the fused-layer stack
('pallas', its plain versions on the CPU). The JAX steps are compiled once
per (num_seq, loss, visual input) and reused.

The separator (frames) and the serving function (float16 rows): audio at
relative L2 1e-4 against JAX's.

Regenerate the fixture with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_fullenc.py

It holds the weights as a seeded recipe (leaf shapes, seed, per-leaf sums),
the batch's audio and float16 rows, the JAX full-encode separator's audio
on the initial weights, and 3 JAX train steps ('fold' loss, mode 2): the
losses and, per leaf, the sum and absolute sum of the final parameters and
statistics, the BatchNorm-fed conv biases and their running means left out.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch as jax_synthetic
from maavss_tpu.exp.export import make_serving_fn as jax_serving_fn
from maavss_tpu.exp.export import random_serving_inputs as jax_serving_inputs
from maavss_tpu.exp.export import serving_input_specs as jax_serving_specs
from maavss_tpu.models import shape_plan as jax_plan
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.ops.phasegram import phasegram_cumsum as jax_cumsum
from maavss_tpu.train.infer import make_separator as jax_make_separator
from maavss_tpu.train.state import create_train_state, make_optimizer
from maavss_tpu.train.steps import _fusion_full_geometry as jax_geometry
from maavss_tpu.train.steps import make_fusion_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    random_flax_tree,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.exp.export import (
    make_serving_fn,
    random_serving_inputs,
    serving_input_specs,
)
from maavss_tpu_torch.train import steps as port_steps
from maavss_tpu_torch.train.infer import make_separator
from maavss_tpu_torch.train.setup import build_fusion, build_fusion_state
from maavss_tpu_torch.train.steps import make_fusion_step
from tests.test_torch_workers import share_cores

share_cores()

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "torch_port_fullenc_golden.npz")
BASE = dict(num_frames=4, hops_per_frame=4, fft_len=64, p_size=16,
            latent_chan=8, fc_size=256, learning_rate=1e-3, batch_size=4,
            noise_scalar=0.0, fusion_encode="full")
LR = BASE["learning_rate"]
SEED, STEPS, MODE = 2025, 3, 2
BATCH = dict(batch_seed=11, frames_noise_seed=99, frames_noise=0.1)
LOSS_RTOL, PARAM_RTOL, AUDIO_RTOL = 1e-5, 1e-4, 1e-4
# (num_seq, MAAVSS_FULLENC_LOSS, visual input): both losses, rows and
# frames, both window counts, one JAX compile each (the last is the
# golden's)
CASES = [(2, "fold", "pgram"), (2, "slice", "frames"), (4, "fold", "pgram")]
GOLDEN_CASE = (4, "fold", "pgram")


def _cfg(ns, visual="pgram", cls=RunConfig):
    return cls(**BASE, num_seq=ns, pgram_cache=visual == "pgram")


def _jax_model(cfg):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFusion(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla")


@functools.lru_cache(maxsize=None)
def _leaf_shapes():
    """{flat path: shape} of the flax model's params and batch_stats (the
    model's shapes do not depend on num_seq)."""
    model = _jax_model(_cfg(2, cls=JaxRunConfig))
    tree = jax.tree_util.tree_map(
        lambda s: np.empty(s.shape, s.dtype), jax.eval_shape(
            lambda: model.init(jax.random.PRNGKey(0),
                               jnp.zeros(model.stft_shape),
                               jnp.zeros(model.pgram_shape),
                               method=model.init_all)))
    return {k: list(v.shape) for k, v in flatten_tree(
        {"params": tree["params"],
         "batch_stats": tree["batch_stats"]}).items()}


def golden_batch(cfg, meta, synthetic=jax_synthetic):
    """{'audio', 'frames', 'pgram'} numpy: the frames with broadband noise
    and their float16 phasegram rows (JAX's phasegram_cumsum)."""
    batch = synthetic(cfg, cfg.batch_size, seed=meta["batch_seed"])
    noise = np.random.default_rng(meta["frames_noise_seed"]).standard_normal(
        batch["frames"].shape).astype(np.float32)
    frames = np.clip(batch["frames"] + meta["frames_noise"] * noise, 0.0, 1.0)
    rows = np.asarray(jax_cumsum(jnp.asarray(frames)), np.float16)
    return {"audio": batch["audio"], "frames": frames, "pgram": rows}


_JAX_STEPS, _JAX_SEPS, _TRAJ = {}, {}, {}


def _jax_step(case):
    """The JAX full-encode step of `case`, compiled once (the loss is read
    from MAAVSS_FULLENC_LOSS when the step is made)."""
    if case not in _JAX_STEPS:
        ns, loss, visual = case
        cfg = _cfg(ns, visual, JaxRunConfig)
        old = os.environ.get("MAAVSS_FULLENC_LOSS")
        os.environ["MAAVSS_FULLENC_LOSS"] = loss
        try:
            _JAX_STEPS[case] = jax_make_step(_jax_model(cfg), cfg)
        finally:
            if old is None:
                del os.environ["MAAVSS_FULLENC_LOSS"]
            else:
                os.environ["MAAVSS_FULLENC_LOSS"] = old
    return _JAX_STEPS[case]


def _jax_separator(ns):
    if ns not in _JAX_SEPS:
        cfg = _cfg(ns, "frames", JaxRunConfig)
        _JAX_SEPS[ns] = jax_make_separator(_jax_model(cfg), cfg)
    return _JAX_SEPS[ns]


def _np_tree(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def _jax_state(tree):
    return create_train_state(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]},
        make_optimizer(LR, "adam"))


def _jax_run(case, tree, batch, steps=STEPS):
    """Per-step metrics, the (params, batch_stats, Adam mu) after step 1 as
    flat numpy trees, and the final state."""
    step = _jax_step(case)
    state = _jax_state(tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics, after1 = [], None
    for i in range(steps):
        state, m = step(state, jbatch, jax.random.PRNGKey(0),
                        jnp.int32(MODE))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            after1 = (_np_tree(state.params), _np_tree(state.batch_stats),
                      _np_tree(state.opt_state[0].mu))
    return metrics, after1, state


@pytest.fixture(scope="module")
def weights():
    shapes = _leaf_shapes()
    return unflatten_tree(random_flax_tree(shapes, SEED))


_BATCHES = {}


def _batch(ns):
    if ns not in _BATCHES:
        _BATCHES[ns] = golden_batch(_cfg(ns, cls=JaxRunConfig), BATCH)
    return _BATCHES[ns]


def _visual_batch(ns, visual):
    b = _batch(ns)
    return {"audio": b["audio"], visual: b[visual]}


def _port_model(cfg, tree, pgenc_kernel, train=False):
    cfg = cfg.replace(pgenc_kernel=pgenc_kernel)
    if train:
        model, state = build_fusion_state(cfg, cfg.batch_size, "cpu")
    else:
        model, state = build_fusion(cfg, cfg.batch_size, "cpu"), None
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    assert model.pgenc_kernel == pgenc_kernel
    return cfg, model, state


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


@pytest.mark.parametrize("pgenc_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_full_step_tracks_jax(weights, case, pgenc_kernel, monkeypatch):
    ns, loss, visual = case
    batch = _visual_batch(ns, visual)
    key = case
    if key not in _TRAJ:
        _TRAJ[key] = _jax_run(case, weights, batch)[:2]
    want, (params_j, stats_j, mu_j) = _TRAJ[key]
    monkeypatch.setenv("MAAVSS_FULLENC_LOSS", loss)
    cfg, model, state = _port_model(_cfg(ns, visual), weights, pgenc_kernel,
                                    train=True)
    step = make_fusion_step(model, cfg, device="cpu")
    init = flatten_tree(weights["params"])
    got = []
    for i in range(STEPS):
        state, m = step(state, batch, MODE)
        got.append({k: float(v) for k, v in m.items()})
        if i == 0:
            _compare_after_step1(model, state, params_j, stats_j, mu_j, init)
    assert state.step == STEPS
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "a_loss", "v_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, atol=0,
                                       err_msg=k)
    assert got[-1]["loss"] < got[0]["loss"]
    for k, w in want[0].items():  # step 1's gradient and parameter norms
        np.testing.assert_allclose(got[0][k], w, rtol=PARAM_RTOL, atol=1e-9,
                                   err_msg=k)


def _compare_after_step1(model, state, params_j, stats_j, mu_j, init):
    params, stats = (_np_tree_copy(t) for t in to_flax(model.state_dict()))
    fed = {k.replace(".", "/") for k in model.bn_fed_biases()}
    assert set(params) == set(params_j) and set(stats) == set(stats_j)
    for path, want in params_j.items():
        if path in fed:
            for side in (params[path], want):
                np.testing.assert_allclose(side, init[path], atol=LR * 1.0001,
                                           rtol=0, err_msg=path)
            continue
        assert _rel_l2(params[path], want) <= PARAM_RTOL, path
    for path, want in stats_j.items():
        assert _rel_l2(stats[path], want) <= PARAM_RTOL, path
    # Adam's first moment after one step is 0.1 * the gradient
    names = [n for n, _ in model.named_parameters()]
    mu_sd = from_flax(unflatten_tree(mu_j))
    for name, m in zip(names, state.tx.m):
        if name.replace(".", "/") in fed:
            continue
        rel = _rel_l2(m.numpy(), mu_sd[name].numpy())
        assert rel <= PARAM_RTOL, (name, rel)


def _np_tree_copy(tree):
    return {k: np.array(v) for k, v in flatten_tree(tree).items()}


@pytest.mark.parametrize("pgenc_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("ns", [2, 4])
def test_full_separator_matches_jax(weights, ns, pgenc_kernel):
    batch = _visual_batch(ns, "frames")
    want = _jax_separator(ns)(_jax_state(weights),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(7))
    cfg, model, _ = _port_model(_cfg(ns, "frames"), weights, pgenc_kernel)
    got = make_separator(model, cfg)({k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert not model.training
    for k in ("audio_out", "audio_in"):
        assert _rel_l2(got[k].numpy(), np.asarray(want[k])) <= AUDIO_RTOL, k


@pytest.mark.parametrize("pgenc_kernel", ["xla", "pallas"])
def test_full_serving_fn_with_rows_matches_jax(weights, pgenc_kernel):
    ns, batch = 4, 4
    jcfg = _cfg(ns, "pgram", JaxRunConfig)
    cfg, model, _ = _port_model(_cfg(ns, "pgram"), weights, pgenc_kernel)
    a_spec, v_spec = serving_input_specs(cfg, batch)
    ja, jv = jax_serving_specs(jcfg, batch)
    assert (a_spec.shape, v_spec.shape) == (ja.shape, jv.shape)
    assert (a_spec.dtype, v_spec.dtype) == (np.float32, np.float16)
    assert np.dtype(jv.dtype) == v_spec.dtype
    audio, rows = random_serving_inputs(cfg, batch, seed=3)
    for a, b in zip((audio, rows), jax_serving_inputs(jcfg, batch, seed=3)):
        np.testing.assert_array_equal(a, b)
    want = jax_serving_fn(_jax_model(jcfg), jcfg)(
        weights["params"], weights["batch_stats"], jnp.asarray(audio),
        jnp.asarray(rows))
    got = make_serving_fn(model, cfg)(torch.from_numpy(audio),
                                      torch.from_numpy(rows))
    assert _rel_l2(got.numpy(), np.asarray(want)) <= AUDIO_RTOL


def test_rows_and_frames_give_the_same_step_up_to_float16():
    """The rows are the frames' phasegram cumsum rounded to float16: by at
    most 2^-11 of each value, or half of float16's smallest subnormal,
    2^-25, below its normal range. One step from each, from one state, gives
    losses within 2^-10 relative of each other (twice that rounding; the
    phasegram's max-abs normalisation and the encoders carry it to the
    loss at a fraction of it: 4.4e-5 at num_seq 2 and 1.9e-5 at num_seq 4
    measured on the CPU). chip_smoke.py's fullenc_train holds the
    flagship to the same gate."""
    for ns in (2, 4):
        b = _batch(ns)
        exact = np.asarray(jax_cumsum(jnp.asarray(b["frames"])), np.float32)
        rows = b["pgram"].astype(np.float32)
        assert np.all(np.abs(rows - exact)
                      <= 2.0 ** -11 * np.abs(exact) + 2.0 ** -25)
        losses = {}
        for visual in ("pgram", "frames"):
            cfg, model, state = _port_model(
                _cfg(ns, visual), unflatten_tree(random_flax_tree(
                    _leaf_shapes(), SEED)), "pallas", train=True)
            _, m = make_fusion_step(model, cfg, device="cpu")(
                state, _visual_batch(ns, visual), MODE)
            losses[visual] = float(m["loss"])
        np.testing.assert_allclose(losses["pgram"], losses["frames"],
                                   rtol=2.0 ** -10)


def test_full_geometry_guard(monkeypatch):
    """The port's geometry is JAX's at both window counts and at the
    flagship, and a plan whose time strides do not divide hops_per_frame
    raises JAX's ValueError."""
    flagship = dict(num_frames=8, num_seq=4, hops_per_frame=8, fft_len=256,
                    p_size=64, latent_chan=64, fc_size=4096, batch_size=8)
    for kw in (dict(BASE, num_seq=2), dict(BASE, num_seq=4), flagship):
        jcfg = JaxRunConfig(**kw)
        model = _stand_in(jcfg)
        want = jax_geometry(model, jcfg)
        assert port_steps._fusion_full_geometry(model, RunConfig(**kw)) \
            == want
    assert want == (1, 1, 8)

    def stride3(plan):
        def plan3(*args, **kwargs):
            specs, hw = plan(*args, **kwargs)
            return [dataclasses.replace(specs[0], stride=(3, 1))] \
                + list(specs[1:]), hw
        return plan3

    jcfg = JaxRunConfig(**BASE, num_seq=2)
    monkeypatch.setattr(jax_plan, "plan_stft_encoder_fusion",
                        stride3(jax_plan.plan_stft_encoder_fusion))
    monkeypatch.setattr(port_steps, "plan_stft_encoder_fusion",
                        stride3(port_steps.plan_stft_encoder_fusion))
    with pytest.raises(ValueError) as want_err:
        jax_geometry(_stand_in(jcfg), jcfg)
    with pytest.raises(ValueError) as got_err:
        port_steps._fusion_full_geometry(_stand_in(jcfg), _cfg(2))
    assert str(got_err.value) == str(want_err.value)
    assert "does not divide hops_per_frame" in str(got_err.value)


def _stand_in(cfg):
    """What the geometry reads of a fusion model, without building one."""
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return _Shapes(stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
                   pgram_shape=(cfg.batch_size, 1, cfg.num_frames,
                                cfg.p_size ** 2),
                   latent_channels=cfg.latent_chan, fc_size=cfg.fc_size)


@dataclasses.dataclass
class _Shapes:
    stft_shape: tuple
    pgram_shape: tuple
    latent_channels: int
    fc_size: int


def test_unknown_fullenc_loss_raises(monkeypatch):
    monkeypatch.setenv("MAAVSS_FULLENC_LOSS", "sliced")
    cfg, model, _ = _port_model(_cfg(2), unflatten_tree(random_flax_tree(
        _leaf_shapes(), SEED)), "xla", train=True)
    with pytest.raises(ValueError, match="auto|fold|slice"):
        make_fusion_step(model, cfg, device="cpu")
    monkeypatch.setenv("MAAVSS_FULLENC_LOSS", "auto")
    assert port_steps.fullenc_loss_impl() == "fold"


# ---------------------------------------------------------------- golden

def _bn_fed_paths():
    _, model, _ = _port_model(_cfg(4), unflatten_tree(random_flax_tree(
        _leaf_shapes(), SEED)), "xla")
    paths = []
    for stack, mod in model.named_children():
        for conv, bn in getattr(mod, "names", ()):
            if bn is not None:
                paths += [f"params/{stack}/{conv}/bias",
                          f"batch_stats/{stack}/{bn}/BatchNorm_0/mean"]
    return sorted(paths)


def _sums(flat, left_out):
    return {k: [float(v.astype(np.float64).sum()),
                float(np.abs(v.astype(np.float64)).sum())]
            for k, v in flat.items() if k not in left_out}


def _golden_jax(meta):
    """(JAX separator audio on the initial weights, losses, final flat
    tree) of the fixture's recipe."""
    tree = unflatten_tree(random_flax_tree(
        {k: tuple(v) for k, v in meta["shapes"].items()}, meta["seed"]))
    cfg = JaxRunConfig(**meta["cfg"])
    batch = golden_batch(cfg, meta)
    sep = jax_make_separator(_jax_model(cfg), cfg)
    audio_out = np.asarray(sep(
        _jax_state(tree), {"audio": jnp.asarray(batch["audio"]),
                           "pgram": jnp.asarray(batch["pgram"])},
        jax.random.PRNGKey(0))["audio_out"])
    metrics, _, state = _jax_run(GOLDEN_CASE, tree,
                                 {"audio": batch["audio"],
                                  "pgram": batch["pgram"]})
    flat = _np_tree({"params": state.params,
                     "batch_stats": state.batch_stats})
    return batch, audio_out, [m["loss"] for m in metrics], flat


def make_golden(path: str = GOLDEN) -> None:
    ns, loss, visual = GOLDEN_CASE
    shapes = _leaf_shapes()
    flat = random_flax_tree(shapes, SEED)
    meta = {"cfg": dict(BASE, num_seq=ns, pgram_cache=visual == "pgram"),
            "seed": SEED, "shapes": shapes,
            "checksums": {k: float(v.astype(np.float64).sum())
                          for k, v in flat.items()},
            "mode": MODE, "fullenc_loss": loss, **BATCH,
            "bn_fed": _bn_fed_paths()}
    batch, audio_out, losses, final = _golden_jax(meta)
    meta.update(losses=losses, sums=_sums(final, set(meta["bn_fed"])))
    np.savez_compressed(path, meta=json.dumps(meta), audio=batch["audio"],
                        pgram=batch["pgram"], audio_out=audio_out)


def _load():
    with np.load(GOLDEN) as z:
        return (json.loads(str(z["meta"])), z["audio"], z["pgram"],
                z["audio_out"])


def test_golden_recipe_regenerates():
    meta, audio, rows, audio_out = _load()
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    for k, total in meta["checksums"].items():
        assert np.isclose(flat[k].astype(np.float64).sum(), total,
                          rtol=1e-6, atol=1e-6), k
    assert set(meta["bn_fed"]) == set(_bn_fed_paths())
    assert set(meta["sums"]) == set(flat) - set(meta["bn_fed"])
    assert rows.dtype == np.float16 and audio_out.shape == audio.shape
    assert os.path.getsize(GOLDEN) < 200_000


def test_golden_matches_jax():
    """The fixture is still what the JAX reference computes (fp32, CPU)."""
    meta, audio, rows, audio_out = _load()
    batch, want_audio, losses, final = _golden_jax(meta)
    np.testing.assert_array_equal(batch["pgram"], rows)
    np.testing.assert_array_equal(batch["audio"], audio)
    assert _rel_l2(want_audio, audio_out) <= 1e-6
    np.testing.assert_allclose(losses, meta["losses"], rtol=1e-6)
    for path, (total, abs_total) in meta["sums"].items():
        assert abs(final[path].astype(np.float64).sum() - total) <= (
            1e-6 * abs_total + 1e-9), path


def test_port_matches_golden_on_cpu():
    """The port's plain path on the fixture, with the fused-layer stack
    (the path the card runs) and chip_smoke.py's fullenc_golden gates."""
    meta, audio, rows, audio_out = _load()
    tree = unflatten_tree(random_flax_tree(
        {k: tuple(v) for k, v in meta["shapes"].items()}, meta["seed"]))
    cfg = RunConfig(**meta["cfg"]).replace(pgenc_kernel="pallas")
    model, state = build_fusion_state(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    batch = {"audio": torch.from_numpy(audio), "pgram": torch.from_numpy(rows)}
    got = make_separator(model, cfg)(batch)["audio_out"].numpy()
    assert _rel_l2(got, audio_out) <= AUDIO_RTOL
    step = make_fusion_step(model, cfg, device="cpu")
    losses = []
    for _ in meta["losses"]:
        state, m = step(state, batch, meta["mode"])
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, meta["losses"], rtol=LOSS_RTOL)
    params, stats = to_flax(model.state_dict())
    got = flatten_tree({"params": params, "batch_stats": stats})
    for path, (total, abs_total) in meta["sums"].items():
        assert abs(got[path].astype(np.float64).sum() - total) <= (
            1e-4 * abs_total + 1e-7), path


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    make_golden()
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
