"""Guards of the PyTorch port `maavss_tpu_torch`: it never loads jax, its
copies of the JAX package's plain-Python modules stay equal to their
originals, the weight converter covers the whole flax tree, the kernel
wrappers take their plain versions on CPU tensors only, and chip_smoke.py
refuses to run without a card."""

import dataclasses
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
from maavss_tpu.models import shape_plan as jax_plan
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu_torch import config as port_config
from maavss_tpu_torch.convert import (
    flatten_tree,
    from_flax,
    load_npz,
    save_npz,
)
from maavss_tpu_torch.models import shape_plan as port_plan
from maavss_tpu_torch.ops.cuda_lstm import lstm_recurrence, lstm_recurrence_plain
from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer, pgenc_layer_plain
from maavss_tpu_torch.train.setup import build_fusion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_frames=4, num_seq=4, fft_len=64, p_size=16, latent_chan=8,
             fc_size=256, batch_size=2)


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import maavss_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "maavss_tpu_torch.__path__, 'maavss_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'maavss_tpu') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
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
    (ys, cs), = lstm_recurrence([xw], [wh], [True])
    ys_p, cs_p = lstm_recurrence_plain(xw, wh, True)
    torch.testing.assert_close(ys, ys_p, rtol=0, atol=0)
    torch.testing.assert_close(cs, cs_p, rtol=0, atol=0)
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
