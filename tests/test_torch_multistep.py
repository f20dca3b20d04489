"""--steps_per_dispatch and --noise_schedule in the port
(maavss_tpu_torch/train/cuda_graph.py, train/steps.py, train/setup.py), on
the CPU, where a K-step dispatch runs its K steps eagerly with the plain
versions.

- The port's K-step fusion dispatch tracks JAX's
  make_fusion_step(..., k_steps=3) (`_multistep`, lax.scan over the
  stacked batches) on the same stacked batches, at
  tests/test_torch_train_step.py's geometry and tolerances (one JAX
  compile for the file).
- A K-step dispatch equals K sequential single steps bit for bit, for the
  vectorized, scan and full-encode fusion steps and the frames step, with
  noise 0.1 drawn from one generator seed.
- A 0-d noise tensor gives the bits of the same Python float; under
  --noise_schedule a dispatch at value v equals K single steps at v.
- resolve_noise_schedule equals JAX's; FusedAdam's count and [c1, c2] on
  the device give the host formula's bits; stack_batches lays batches out
  as make_stream's `stacked`; tools/train_torch.py and
  tools/bench_torch.py take K.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.synthetic import synthetic_av_batch as jax_batch
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.train.setup import make_stream as jax_make_stream
from maavss_tpu.train.setup import resolve_noise_schedule as jax_schedule
from maavss_tpu.train.state import create_train_state as jax_create_state
from maavss_tpu.train.state import make_optimizer as jax_make_optimizer
from maavss_tpu.train.steps import make_fusion_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import flatten_tree, from_flax, to_flax
from maavss_tpu_torch.data.synthetic import synthetic_av_batch, with_pgram_rows
from maavss_tpu_torch.ops.cuda_adam import (
    adam_update_low,
    adam_update_plain,
    bias_corrections,
)
from maavss_tpu_torch.train import setup
from maavss_tpu_torch.train.fused_adam import FusedAdam
from maavss_tpu_torch.train.state import create_train_state
from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step
from tools import bench_torch, train_torch
from tests.test_torch_workers import share_cores

share_cores()

# tests/test_torch_train_step.py's geometry, loss tolerance in mode 2 and
# parameter tolerance
GEOMETRY = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
                batch_size=4, noise_scalar=0.0)
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4
LR = GEOMETRY["learning_rate"]
K = 3
# tests/test_torch_frames.py's geometry (latent width 8), with K5 at
# stages 0 and 1
FRAMES = dict(num_frames=2, num_seq=2, hops_per_frame=4, fft_len=64,
              framesize=24, batch_size=2, learning_rate=1e-3)


def _broadband(cfg, seed):
    """A batch with broadband frames (tests/test_torch_train_step.py's
    `_batch`: smooth blob frames have FFT bins of arbitrary phase)."""
    batch = jax_batch(cfg, cfg.batch_size, seed=seed)
    noise = np.random.default_rng(99 + seed).standard_normal(
        batch["frames"].shape).astype(np.float32)
    batch["frames"] = np.clip(batch["frames"] + 0.1 * noise, 0.0, 1.0)
    return batch


def test_k_step_tracks_jax_multistep():
    cfg_j = JaxRunConfig(**GEOMETRY)
    t_stft = cfg_j.hops_per_frame * cfg_j.num_frames
    model_j = JaxFusion(
        stft_shape=(cfg_j.batch_size, 2, t_stft, cfg_j.fft_len // 2),
        pgram_shape=(cfg_j.batch_size, 1, cfg_j.num_frames,
                     cfg_j.p_size ** 2),
        latent_channels=cfg_j.latent_chan, fc_size=cfg_j.fc_size,
        pgenc_kernel="xla")
    variables = model_j.init(jax.random.PRNGKey(0),
                             jnp.zeros(model_j.stft_shape),
                             jnp.zeros(model_j.pgram_shape),
                             method=model_j.init_all)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    stacked = setup.stack_batches([_broadband(cfg_j, 11 + i)
                                   for i in range(K)])
    state_j = jax_create_state(variables, jax_make_optimizer(LR, "adam"))
    kstep_j = jax_make_step(model_j, cfg_j, window_mode="vectorized",
                            k_steps=K)
    state_j, want = kstep_j(state_j, jax.tree_util.tree_map(jnp.asarray,
                                                            stacked),
                            jax.random.PRNGKey(0), jnp.int32(2))
    params_j = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                   state_j.params))
    stats_j = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                  state_j.batch_stats))

    cfg = RunConfig(**GEOMETRY).replace(window_mode="vectorized",
                                        steps_per_dispatch=K)
    model = setup.build_fusion(cfg, cfg.batch_size, "cpu")
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]))
    state = create_train_state(model, cfg, "cpu")
    kstep = make_fusion_step(model, cfg, device="cpu")  # k from cfg
    state, got = kstep(state, stacked, 2)
    assert state.step == K and state.tx.count == K
    assert set(got) == set(want)
    for key, v in got.items():
        assert v.shape == (K,), key
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]),
                               rtol=LOSS_RTOL, atol=0)
    for key in ("a_loss", "v_loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=PARAM_RTOL, atol=1e-9, err_msg=key)
    params, stats = (flatten_tree(t) for t in to_flax(model.state_dict()))
    init = flatten_tree(variables["params"])
    fed = {k.replace(".", "/") for k in model.bn_fed_biases()}
    for path, w in params_j.items():
        if path in fed:  # noise-driven updates: within lr a step of init
            for side in (params[path], w):
                np.testing.assert_allclose(side, init[path],
                                           atol=K * LR * 1.0001, rtol=0,
                                           err_msg=path)
            continue
        rel = np.linalg.norm(params[path] - w) / max(np.linalg.norm(w),
                                                      1e-12)
        assert rel <= PARAM_RTOL, (path, rel)
    for path, w in stats_j.items():
        # a running mean behind a BatchNorm-fed conv bias carries that
        # bias's noise-driven steps (at most lr a step on each side)
        bias = path.replace("TorchBatchNorm_", "Conv_").replace(
            "/BatchNorm_0/mean", "/bias")
        if path.endswith("/mean") and bias in fed:
            np.testing.assert_allclose(stats[path], w, rtol=0,
                                       atol=2 * K * LR * 1.0001,
                                       err_msg=path)
            continue
        rel = np.linalg.norm(stats[path] - w) / max(np.linalg.norm(w), 1e-12)
        assert rel <= PARAM_RTOL, (path, rel)


def _port_pair(kind, monkeypatch, k=K, **flags):
    """(cfg, (state, step), (twin state, k-step dispatch), batches) of
    `kind` on the CPU: a model from its seed and a twin from its
    state_dict, and k synthetic batches."""
    if kind == "frames":
        monkeypatch.setenv("MAAVSS_S2D_MIN_HW", "8")
        cfg = RunConfig(**FRAMES).replace(**flags)
        build = functools.partial(setup.build_frames_state,
                                  latent_channels=8)
        make, fs = make_frames_step, 24
    else:
        cfg = RunConfig(**GEOMETRY).replace(noise_scalar=0.1, **flags)
        if kind == "full":
            cfg = cfg.replace(fusion_encode="full", pgram_cache=True)
        else:
            cfg = cfg.replace(window_mode=kind)
        build, make, fs = setup.build_fusion_state, make_fusion_step, None
    model, state = build(cfg, cfg.batch_size, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    twin, twin_state = build(cfg, cfg.batch_size, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    twin.load_state_dict(model.state_dict())
    batches = [synthetic_av_batch(cfg, cfg.batch_size, seed=i, frame_size=fs)
               for i in range(k)]
    if cfg.pgram_cache:
        batches = [with_pgram_rows(b) for b in batches]
    return (cfg, (state, make(model, cfg, device="cpu")),
            (twin_state, make(twin, cfg, device="cpu", k_steps=k)), batches)


def _assert_same_state(a, b):
    for (n, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(x, y), n
    for x, y in zip(a.tx.m + a.tx.v, b.tx.m + b.tx.v):
        assert torch.equal(x, y)
    assert torch.equal(a.tx.count_tensor, b.tx.count_tensor)
    assert (a.step, a.tx.count) == (b.step, b.tx.count)


@pytest.mark.parametrize("kind, flags, k", [
    ("vectorized", {}, K), ("scan", {}, K), ("full", {}, K), ("frames", {}, K),
    ("frames", dict(frames_encode="full", microbatch=2), 2),
], ids=["vectorized", "scan", "full", "frames", "frames-full-mb2"])
def test_k_step_equals_sequential_steps(kind, flags, k, monkeypatch):
    cfg, (state, step), (k_state, kstep), batches = _port_pair(
        kind, monkeypatch, k, **flags)
    assert cfg.noise_scalar == 0.1
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    seq = []
    for b in batches:
        state, m = step(state, b, 2, g1)
        seq.append(m)
    k_state, got = kstep(k_state, setup.stack_batches(batches), 2, g2)
    for key in seq[0]:
        assert torch.equal(got[key], torch.stack([m[key] for m in seq])), key
    _assert_same_state(state, k_state)
    assert k_state.step == k and torch.equal(g1.get_state(), g2.get_state())


def test_noise_tensor_and_schedule_dispatch(monkeypatch):
    # a 0-d tensor and the same float give the same bits (both draw)
    cfg, (state, step), (twin, _), batches = _port_pair("vectorized",
                                                        monkeypatch)
    twin_step = make_fusion_step(twin.model, cfg, device="cpu")
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    state, m1 = step(state, batches[0], 2, g1, noise=0.1)
    twin, m2 = twin_step(twin, batches[0], 2, g2,
                         noise=torch.tensor(0.1, dtype=torch.float32))
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_same_state(state, twin)
    # under --noise_schedule: a dispatch at v is K single steps at v
    cfg, (state, step), (k_state, kstep), batches = _port_pair(
        "vectorized", monkeypatch, noise_schedule="linear:0.2:0.0")
    v = 0.05
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    seq = []
    for b in batches:
        state, m = step(state, b, 2, g1, noise=v)
        seq.append(m["loss"])
    k_state, got = kstep(k_state, setup.stack_batches(batches), 2, g2,
                         noise=v)
    assert torch.equal(got["loss"], torch.stack(seq))
    _assert_same_state(state, k_state)
    # 0.0 under the schedule (a tensor) still draws, as JAX's traced scalar
    # does; the float 0.0 draws nothing
    g = torch.Generator().manual_seed(4)
    before = g.get_state()
    step(state, batches[0], 2, g, noise=0.0)
    assert not torch.equal(g.get_state(), before)
    plain = make_fusion_step(state.model, cfg.replace(noise_schedule=None),
                             device="cpu")
    g = torch.Generator().manual_seed(4)
    plain(state, batches[0], 2, g, noise=0.0)
    assert torch.equal(g.get_state(), before)


@pytest.mark.parametrize("spec", ["linear:0.1:0.0", "cosine:0.3:0.05"])
def test_noise_schedule_matches_jax(spec):
    kw = dict(epochs=2, steps_per_epoch=6, noise_schedule=spec)
    got = setup.resolve_noise_schedule(RunConfig(**kw))
    want = jax_schedule(JaxRunConfig(**kw))
    total = 2 * 6 - 1
    for step in (0, total // 2, total, total + 7):
        assert got(step) == want(step)
    assert setup.resolve_noise_schedule(RunConfig()) is None
    for bad in ("linear:0.1", "exp:0.1:0.0", "linear:a:0"):
        with pytest.raises(SystemExit) as e_port:
            setup.resolve_noise_schedule(RunConfig(noise_schedule=bad))
        with pytest.raises(SystemExit) as e_jax:
            jax_schedule(JaxRunConfig(noise_schedule=bad))
        assert str(e_port.value) == str(e_jax.value)


def test_device_count_equals_host_bias_corrections():
    g = torch.Generator().manual_seed(2)
    shapes = [(37, 5), (8,), (16, 12)]
    ps = [torch.randn(s, generator=g) for s in shapes] + [
        torch.randn(s, generator=g).to(torch.bfloat16) for s in shapes[:2]]
    ref = [p.clone() for p in ps]
    opt = FusedAdam(ps, LR, kernel="xla")
    mr = [torch.zeros_like(p) for p in ps]
    vr = [torch.zeros_like(p) for p in ps]
    for count in range(1, 6):
        grads = [torch.randn(p.shape, generator=g).to(p.dtype) for p in ps]
        for p, gr in zip(ps, grads):
            p.grad = gr
        opt.step()
        c1, c2 = bias_corrections(count, 0.9, 0.999)
        for i in range(3):
            adam_update_plain(grads[i], mr[i], vr[i], ref[i], c1, c2, LR,
                              0.9, 0.999, 1e-8)
        adam_update_low(grads[3:], mr[3:], vr[3:], ref[3:], c1, c2, LR, 0.9,
                        0.999, 1e-8)
        assert opt.count == count
        assert opt.bc.tolist() == [c1, c2]
        for a, b in zip(ps + opt.m + opt.v, ref + mr + vr):
            assert torch.equal(a, b)


def test_stack_batches_gives_make_stream_layout():
    """The dispatch batches of JAX's make_stream(stack=K) are stack_batches
    of the K batches its unstacked stream gives from the same seed, for
    float32 audio, uint8 frames and float16 phasegram rows."""
    rng = np.random.default_rng(0)
    items = [{"audio": rng.standard_normal(32).astype(np.float32),
              "frames": rng.integers(0, 256, (3, 4, 4), dtype=np.uint8),
              "pgram": rng.standard_normal((3, 16)).astype(np.float16)}
             for _ in range(7)]
    cfg = JaxRunConfig(batch_size=2)
    single = jax_make_stream(cfg, items, seed=3)
    want = next(jax_make_stream(cfg, items, seed=3, stack=K))
    got = setup.stack_batches([next(single) for _ in range(K)])
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape[0] == K
        np.testing.assert_array_equal(got[key], want[key])
    t = setup.stack_batches([{"a": torch.ones(2)}, {"a": torch.zeros(2)}])
    assert torch.equal(t["a"], torch.tensor([[1.0, 1.0], [0.0, 0.0]]))


TRAIN_ARGV = ["--device", "cpu", "-b", "2", "--num_frames", "4", "--fft_len",
              "64", "--p_size", "16", "--latent_chan", "8", "--fc_size",
              "256", "-lr", "1e-3", "--fusion_encode", "full",
              "--pgram_cache"]


def test_train_tool_takes_steps_per_dispatch(capsys):
    train_torch.main(TRAIN_ARGV + ["-s", "4", "--steps_per_dispatch", "2",
                                   "-e", "1", "--noise_schedule",
                                   "linear:0.1:0.0"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    steps, final = lines[:-1], lines[-1]
    assert [x["step"] for x in steps] == [1, 2, 3, 4]
    assert all(math.isfinite(x["loss"]) for x in steps)
    # one value a dispatch: JAX's schedule at the dispatch's first step
    want = jax_schedule(JaxRunConfig(epochs=1, steps_per_epoch=4,
                                     noise_schedule="linear:0.1:0.0"))
    assert [x["noise"] for x in steps] == [want(0), want(0), want(2),
                                           want(2)]
    assert final["steps"] == 4 and final["steps_per_dispatch"] == 2
    with pytest.raises(ValueError, match="must be a multiple of "
                       "steps_per_dispatch=2"):
        train_torch.main(TRAIN_ARGV + ["-s", "3", "--steps_per_dispatch",
                                       "2"])


def test_bench_takes_multistep():
    tiny = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                p_size=16, latent_chan=8, fc_size=256)
    env = {"MAAVSS_BENCH_MULTISTEP": "2"}
    line = bench_torch.measure(2, steps=2, windows=1, warmup=1,
                               device="cpu", env=env, geometry=tiny)
    assert line["multistep"] == 2 and line["value"] > 0
    assert not any(line["kernels"].values())
    with pytest.raises(SystemExit, match="MAAVSS_BENCH_STEPS=3 must be a "
                       "multiple of MAAVSS_BENCH_MULTISTEP=2"):
        bench_torch.measure(2, steps=3, windows=1, warmup=1, device="cpu",
                            env=env, geometry=tiny)


@pytest.mark.cuda
def test_graphed_dispatch_equals_eager_steps_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode); "
                    "chip_smoke.py's graphs phase holds every path there")
    torch.backends.cudnn.deterministic = True  # cuDNN's fp32 wgrad varies
    cfg = RunConfig(**GEOMETRY).replace(noise_scalar=0.1,
                                        fusion_encode="full",
                                        pgram_cache=True)
    model, state = setup.build_fusion_state(cfg, cfg.batch_size, "cuda",
                                            torch.Generator().manual_seed(0))
    twin, twin_state = setup.build_fusion_state(
        cfg, cfg.batch_size, "cuda", torch.Generator().manual_seed(1))
    twin.load_state_dict(model.state_dict())
    step = make_fusion_step(twin, cfg, device="cuda")
    kstep = make_fusion_step(model, cfg, device="cuda", k_steps=K)
    g1, g2 = (torch.Generator(device="cuda").manual_seed(5)
              for _ in range(2))
    for d in range(3):  # an eager dispatch that captures, then replays
        batches = [with_pgram_rows(synthetic_av_batch(
            cfg, cfg.batch_size, seed=d * K + i), "cuda") for i in range(K)]
        seq = []
        for b in batches:
            twin_state, m = step(twin_state, b, 2, g1)
            seq.append(m["loss"])
        state, got = kstep(state, setup.stack_batches(batches), 2, g2)
        assert torch.equal(got["loss"], torch.stack(seq))
        _assert_same_state(twin_state, state)
    assert kstep.captures == 1
    torch.backends.cudnn.deterministic = False
