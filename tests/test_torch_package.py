"""Guards of the PyTorch port `maavss_tpu_torch`: it never loads jax, its
copies of the JAX package's plain-Python modules (the fusion and frames
planners included) stay equal to their originals, the weight converter
covers the whole flax tree both ways, the kernel wrappers take their plain
versions on CPU tensors only, the entry points default to the card, and
chip_smoke.py refuses to run without a card."""

import dataclasses
import inspect
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maavss_tpu import config as jax_config
from maavss_tpu.data import synthetic as jax_synthetic
from maavss_tpu.models import shape_plan as jax_plan
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu_torch import config as port_config
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    load_npz,
    random_flax_tree,
    save_npz,
    to_flax,
    unflatten_tree,
)
from maavss_tpu_torch.data import synthetic as port_synthetic
from maavss_tpu_torch.models import shape_plan as port_plan
from maavss_tpu_torch.ops.cuda_adam import adam_multi_tensor
from maavss_tpu_torch.ops.cuda_lstm import (
    lstm_recurrence,
    lstm_recurrence_bwd,
    lstm_recurrence_plain,
)
from maavss_tpu_torch.ops.cuda_pgenc import (
    pgenc_bwd,
    pgenc_layer,
    pgenc_layer_plain,
    pgenc_train,
)
from maavss_tpu_torch.train import setup as port_setup
from maavss_tpu_torch.train import state as port_state
from maavss_tpu_torch.train import steps as port_steps
from maavss_tpu_torch.train.setup import (
    build_frames_model,
    build_frames_state,
    build_fusion,
)
from tests.test_torch_workers import share_cores
from maavss_tpu_torch.ops.dino import VideoAttention
from tools import (
    evaluate_torch,
    fit_torch,
    flow_torch,
    quality_curve_torch,
    save_attn_videos_torch,
    save_phasegrams_torch,
    separate_torch,
    train_legacy_torch,
)

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_frames=4, num_seq=4, fft_len=64, p_size=16, latent_chan=8,
             fc_size=256, batch_size=2)


def test_port_imports_without_jax():
    """Every module of the port, and tools/bench_torch.py, fit_torch.py,
    save_phasegrams_torch.py, evaluate_torch.py, separate_torch.py,
    quality_curve_torch.py, train_legacy_torch.py,
    save_attn_videos_torch.py and flow_torch.py with the modules they
    reach, load in a fresh process without jax, ml_dtypes (which the
    card's machine lacks) or maavss_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import maavss_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "maavss_tpu_torch.__path__, 'maavss_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "from tools import bench_torch, fit_torch, save_phasegrams_torch\n"
        "from tools import evaluate_torch, quality_curve_torch, "
        "separate_torch\n"
        "from tools import train_legacy_torch, save_attn_videos_torch, "
        "flow_torch\n"
        "bench_torch.kernel_counters(); bench_torch.bench_config({}, 8)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'ml_dtypes', 'maavss_tpu') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 51, names\n"
        "new = {'maavss_tpu_torch.ops.cuda_adam', "
        "'maavss_tpu_torch.train.fused_adam', 'maavss_tpu_torch.train.state', "
        "'maavss_tpu_torch.train.steps', 'maavss_tpu_torch.data.synthetic', "
        "'maavss_tpu_torch.ops.cuda_epilogue', "
        "'maavss_tpu_torch.models.fusion_frames', "
        "'maavss_tpu_torch.train.cuda_graph', 'maavss_tpu_torch.ops.counters',"
        " 'maavss_tpu_torch.data.wavio', 'maavss_tpu_torch.data.frame_shards',"
        " 'maavss_tpu_torch.data.audio_memmap',"
        " 'maavss_tpu_torch.data.clip_index', 'maavss_tpu_torch.data.dataset',"
        " 'maavss_tpu_torch.exp.metrics', 'maavss_tpu_torch.exp.checkpoint',"
        " 'maavss_tpu_torch.exp.profiling', 'maavss_tpu_torch.train.trainer',"
        " 'maavss_tpu_torch.ops.audio', 'maavss_tpu_torch.exp.viz',"
        " 'maavss_tpu_torch.ops.fft_legacy', 'maavss_tpu_torch.data.generator',"
        " 'maavss_tpu_torch.models.legacy', 'maavss_tpu_torch.ops.dino',"
        " 'maavss_tpu_torch.ops.flow'}\n"
        "assert new <= set(names), new - set(names)\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("argv", [
    [],
    ["-b", "8", "--fft_len", "64", "--p_size", "16", "--latent_chan", "8",
     "--fc_size", "256", "--num_frames", "4", "--pgenc_kernel", "pallas"],
    ["--rnn_cell", "gru", "--mask_head", "--use_polar", "true",
     "--fusion_encode", "full", "--dtype", "bfloat16", "-a", "4"],
    ["--framesize", "24", "--frames_encode", "full", "--frames_halo", "1",
     "--objective_zeros", "true", "--num_seq", "2", "--microbatch", "2"],
])
def test_config_copy_parses_like_jax(argv):
    jax_cfg = jax_config.model_args(argv)
    port_cfg = port_config.model_args(argv)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert (port_cfg.hop, port_cfg.audio_sample_len, port_cfg.num_fft_frames) \
        == (jax_cfg.hop, jax_cfg.audio_sample_len, jax_cfg.num_fft_frames)


@pytest.mark.parametrize("geom", [
    dict(p=64, nf=8, fft=256, a=8, latent=64, fc=4096),  # flagship
    dict(p=16, nf=4, fft=64, a=8, latent=8, fc=256),  # the tests' geometry
    dict(p=32, nf=6, fft=128, a=4, latent=32, fc=1024),
])
def test_shape_plan_copy_matches_jax(geom):
    pg_shape = (2, 1, geom["nf"], geom["p"] ** 2)
    st_shape = (2, 2, geom["a"] * geom["nf"], geom["fft"] // 2)
    plans = []
    for mod in (jax_plan, port_plan):
        enc, hw = mod.plan_phasegram_encoder(pg_shape, geom["latent"],
                                             geom["fc"])
        dec, _ = mod.plan_phasegram_decoder(hw, pg_shape, geom["latent"])
        a_enc, a_hw = mod.plan_stft_encoder_fusion(st_shape, hw,
                                                   geom["latent"])
        a_dec, _ = mod.plan_stft_decoder_fusion(a_hw, st_shape,
                                                geom["latent"])
        plans.append([[dataclasses.astuple(s) for s in p]
                      for p in (enc, dec, a_enc, a_dec)] + [hw, a_hw])
    assert plans[0] == plans[1]


@pytest.mark.parametrize("geom", [
    dict(fs=256, nf=8, fft=256, a=8, latent=16),  # flagship
    dict(fs=24, nf=2, fft=64, a=4, latent=8),  # the frames tests' geometry
    dict(fs=96, nf=4, fft=128, a=4, latent=16),
])
def test_frames_shape_plan_copy_matches_jax(geom):
    st_shape = (2, 2, geom["a"] * geom["nf"], geom["fft"] // 2 + 1)
    plans = []
    for mod in (jax_plan, port_plan):
        hw = mod.frames_visual_encoder_out_hw(geom["fs"])
        enc, a_hw = mod.plan_stft_encoder_frames(st_shape, (geom["nf"], hw * hw),
                                                 geom["latent"])
        dec, _ = mod.plan_stft_decoder_frames(a_hw, st_shape, geom["latent"])
        plans.append([[dataclasses.astuple(s) for s in p] for p in (enc, dec)]
                     + [hw, a_hw])
    assert plans[0] == plans[1]


@pytest.fixture(scope="module")
def flax_small():
    cfg = jax_config.RunConfig(**SMALL)
    t_stft = cfg.hops_per_frame * cfg.num_frames
    model = JaxFusion(
        stft_shape=(2, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(2, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla")
    v = jax.jit(lambda key: model.init(
        key, jnp.zeros(model.stft_shape), jnp.zeros(model.pgram_shape),
        method=model.init_all))(jax.random.PRNGKey(0))
    return (jax.tree_util.tree_map(np.asarray, v["params"]),
            jax.tree_util.tree_map(np.asarray, v["batch_stats"]))


def test_from_flax_covers_every_leaf(flax_small):
    params, batch_stats = flax_small
    sd = from_flax(params, batch_stats)
    n_leaves = len(flatten_tree(params)) + len(flatten_tree(batch_stats))
    assert len(sd) == n_leaves
    model = build_fusion(port_config.RunConfig(**SMALL), 2, "cpu")
    model_sd = model.state_dict()
    assert set(sd) == set(model_sd)
    for k, v in sd.items():
        assert v.shape == model_sd[k].shape, k
    model.load_state_dict(sd, strict=True)
    # LSTM weights keep the flax [D,4H]/[H,4H] layout the kernel reads
    np.testing.assert_array_equal(model.lstm.fwd.w_h.detach().numpy(),
                                  params["lstm"]["fwd"]["w_h"])


def test_npz_round_trip(flax_small, tmp_path):
    params, batch_stats = flax_small
    path = str(tmp_path / "w.npz")
    save_npz(path, params, batch_stats)
    p2, b2 = load_npz(path)
    for a, b in ((params, p2), (batch_stats, b2)):
        fa, fb = flatten_tree(a), flatten_tree(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])


def test_kernel_wrappers_take_plain_path_on_cpu():
    lstm_recurrence.launches = 0
    pgenc_layer.launches = 0
    g = torch.Generator().manual_seed(0)
    xw = torch.randn(2, 3, 128, generator=g)
    wh = torch.randn(32, 128, generator=g) * 0.1
    got, = lstm_recurrence([xw], [wh], [True])
    for a, b in zip(got, lstm_recurrence_plain(xw, wh, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x = torch.randn(2, 6, 16, generator=g)
    w2 = torch.randn(4, 18, generator=g)
    vecs = [torch.randn(4, generator=g) for _ in range(4)] + [torch.ones(4)]
    torch.testing.assert_close(pgenc_layer(x, w2, *vecs),
                               pgenc_layer_plain(x, w2, *vecs), rtol=0, atol=0)
    assert lstm_recurrence.launches == 0 and pgenc_layer.launches == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        lstm_recurrence([xw], [wh], [False], backend="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        pgenc_layer(x, w2, *vecs, backend="kernel")


def test_new_wrappers_count_no_launch_on_cpu():
    """The train path's wrappers take their plain versions on CPU tensors
    and count no launch there."""
    g = torch.Generator().manual_seed(1)
    counters = (lstm_recurrence_bwd, pgenc_train, pgenc_bwd,
                adam_multi_tensor)
    for c in counters:
        c.launches = 0
    xw = torch.randn(2, 3, 128, generator=g)
    wh = torch.randn(32, 128, generator=g) * 0.1
    (ys, cs, acts), = lstm_recurrence([xw], [wh], [False])
    lstm_recurrence_bwd([acts], [wh], [ys], [cs], [torch.ones_like(ys)],
                        [False])
    x = torch.randn(2, 6, 16, generator=g)
    w2 = torch.randn(4, 18, generator=g)
    vecs = [torch.randn(4, generator=g) for _ in range(2)] + [torch.ones(4)]
    y, mu, var, yc = pgenc_train(x, w2, *vecs)
    pgenc_bwd(x, w2, yc, *vecs[1:], mu, var, torch.ones_like(y))
    p = [torch.randn(5, generator=g)]
    adam_multi_tensor([None], [torch.zeros(5)], [torch.zeros(5)], p,
                      torch.tensor([0.1, 0.001, 1e-3]), 0.9, 0.999, 1e-8)
    assert [c.launches for c in counters] == [0, 0, 0, 0]


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_copy_matches_jax(seed):
    for kwargs in (dict(), dict(num_frames=4, num_seq=2, p_size=16,
                                fft_len=64)):
        cfg_j = jax_config.RunConfig(**kwargs)
        cfg_p = port_config.RunConfig(**kwargs)
        a = jax_synthetic.synthetic_av_batch(cfg_j, 2, seed=seed)
        b = port_synthetic.synthetic_av_batch(cfg_p, 2, seed=seed)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(
        jax_synthetic.sine_sweep_audio(seed, 3, 1000),
        port_synthetic.sine_sweep_audio(seed, 3, 1000))
    np.testing.assert_array_equal(
        jax_synthetic.moving_blob_frames(seed, 2, 5, 12),
        port_synthetic.moving_blob_frames(seed, 2, 5, 12))


def test_to_flax_round_trip_on_flagship_tree():
    """from_flax then to_flax gives back every leaf of the flagship fusion
    model's tree (shapes from jax.eval_shape of its init, values from the
    seeded recipe), in flax's layout."""
    cfg = jax_config.RunConfig()
    t_stft = cfg.hops_per_frame * cfg.num_frames
    model = JaxFusion(stft_shape=(8, 2, t_stft, cfg.fft_len // 2),
                      pgram_shape=(8, 1, cfg.num_frames, cfg.p_size ** 2),
                      latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
                      pgenc_kernel="xla")
    abstract = jax.eval_shape(lambda key: model.init(
        key, jnp.zeros(model.stft_shape), jnp.zeros(model.pgram_shape),
        method=model.init_all), jax.random.PRNGKey(0))
    shapes = {
        "/".join(str(k.key) for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            {"params": abstract["params"],
             "batch_stats": abstract["batch_stats"]})[0]}
    flat = random_flax_tree(shapes, 0)
    n_params = sum(int(np.prod(s)) for k, s in shapes.items()
                   if k.startswith("params/"))
    assert n_params == 36_716_731
    tree = unflatten_tree(flat)
    sd = from_flax(tree["params"], tree["batch_stats"])
    params, stats = to_flax(sd)
    back = flatten_tree({"params": params, "batch_stats": stats})
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_entry_points_default_to_cuda():
    for fn in (build_fusion, port_setup.build_fusion_state,
               port_state.create_train_state, port_steps.make_fusion_step,
               port_steps.make_fusion_eval, build_frames_model,
               build_frames_state, port_steps.make_frames_step,
               fit_torch.fit, save_phasegrams_torch.build_pgram_store,
               evaluate_torch.evaluate, separate_torch.separate_file,
               quality_curve_torch.quality_curve, train_legacy_torch.train,
               train_legacy_torch.build_legacy_model,
               save_attn_videos_torch.save_attention, flow_torch.flow_frames,
               VideoAttention.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__name__
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build_fusion(port_config.RunConfig(**SMALL), 2)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        for tool, argv in (
                ("train_torch.py", ["-s", "1"]),
                ("train_torch.py", ["--model", "frames", "-s", "1"]),
                ("fit_torch.py", ["--data_path", "synthetic"]),
                ("fit_torch.py", ["--model", "frames"]),
                ("save_phasegrams_torch.py", ["--data_path", "synthetic"]),
                ("evaluate_torch.py", ["--data_path", "synthetic"]),
                ("evaluate_torch.py", ["--model", "frames"]),
                ("separate_torch.py", ["--audio", "missing.wav", "--out",
                                       "unwritten.wav"]),
                ("quality_curve_torch.py", ["--steps", "1"]),
                ("train_legacy_torch.py", ["--data_path", "synthetic"]),
                ("save_attn_videos_torch.py", ["--data_path", "synthetic"]),
                ("flow_torch.py", ["--video", "0"])):
            out = subprocess.run([sys.executable, f"tools/{tool}", *argv],
                                 cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=120)
            assert out.returncode != 0, tool
            assert "CUDA is not available" in out.stderr, tool


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_cuda():
    out = _run_chip_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_chip_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
