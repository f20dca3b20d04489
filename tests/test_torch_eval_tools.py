"""The port's evaluation tools against the JAX package's, on the CPU at a
small geometry: tools/evaluate_torch.py against evaluate.py (the fusion
model with --rnn_cell gru, the frames model with --rnn_cell none) and
tools/separate_torch.py against separate.py, in-process, from one JAX
checkpoint that both load (the JAX package's pickle backend,
`<name>.ckpt.pkl`: the file evaluate.py's --checkpoint reads), on one tiny
synthetic store whose frames carry broadband noise (a smooth blob's
near-zero FFT bins have arbitrary phases, and so phasegrams), with noise 0
(the two packages' generators draw differently). JSON fields within 1e-3
dB, the written wavs within 1e-4 relative L2, and --compare equal to the
JAX function on the same two wavs. Runs from a temporary directory: the stores, checkpoints and wavs
never touch the checkout."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.exp.checkpoint import save_checkpoint
from maavss_tpu.train import setup as jax_setup
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import from_flax
from maavss_tpu_torch.data.wavio import read_wav, write_wav
from maavss_tpu_torch.exp.checkpoint import load_checkpoint
from maavss_tpu_torch.train.setup import build_frames_model, build_fusion
from tests.test_torch_trainer import _broadband
from tests.test_torch_workers import share_cores
from tools import evaluate_torch, separate_torch

share_cores()

DB_TOL, WAV_RTOL = 1e-3, 1e-4
FUSION = ["--num_frames", "4", "--num_seq", "4", "--fft_len", "64",
          "--p_size", "16", "--latent_chan", "8", "--fc_size", "256",
          "-b", "2", "--noise_scalar", "0", "--data_path", "synthetic:3",
          "-v", "2", "--rnn_cell", "gru"]
FRAMES = ["--num_frames", "2", "--num_seq", "2", "-a", "4", "--fft_len",
          "64", "--p_size", "24", "-b", "2", "--noise_scalar", "0",
          "--data_path", "synthetic:3", "-v", "1", "--rnn_cell", "none"]
ARGS = {"fusion": FUSION, "frames": FRAMES}


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _random_stats(batch_stats, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 1.5, v.shape)
                      if "var" in jax.tree_util.keystr(p)
                      else rng.normal(0, 0.2, v.shape)).astype(np.float32),
        batch_stats)


def _run(fn, argv, capsys, monkeypatch):
    """fn() with sys.argv = argv; the JSON of its last printed line."""
    monkeypatch.setattr(sys, "argv", ["tool"] + argv)
    capsys.readouterr()
    fn()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A temporary working directory holding the synthetic stores and one
    JAX checkpoint a model kind, with random BatchNorm statistics."""
    root = tmp_path_factory.mktemp("eval_tools")
    old, env = os.getcwd(), os.environ.get("MAAVSS_CKPT_BACKEND")
    os.chdir(root)
    os.environ["MAAVSS_CKPT_BACKEND"] = "pkl"
    try:
        for kind, argv in ARGS.items():
            from maavss_tpu.config import model_args as jax_model_args

            cfg = jax_model_args(argv)
            jax_setup.load_stores(cfg)
            _broadband(jax_setup.resolve_data_root(cfg))
            if kind == "frames":
                _, state = jax_setup.build_frames_model(cfg, 2, 24)
            else:
                _, state = jax_setup.build_fusion(cfg, 2)
            state = state.replace(batch_stats=_random_stats(
                state.batch_stats, 5))
            save_checkpoint(os.path.join("cp", kind), kind, state, 3, 0.5)
        yield root
    finally:
        os.chdir(old)
        if env is None:
            os.environ.pop("MAAVSS_CKPT_BACKEND", None)
        else:
            os.environ["MAAVSS_CKPT_BACKEND"] = env


@pytest.fixture
def no_jax_cache(monkeypatch):
    """The JAX tools' init_runtime would turn on JAX's persistent
    compilation cache for the rest of the test process: a no-op here."""
    import evaluate

    monkeypatch.setattr(jax_setup, "init_runtime", lambda: None)
    monkeypatch.setattr(evaluate, "init_runtime", lambda: None)
    return evaluate


def _ckpt(kind):
    return os.path.join("cp", kind, f"{kind}.ckpt.pkl")


@pytest.mark.parametrize("kind", ["fusion", "frames"])
def test_checkpoint_loads_jax_pickle(workdir, kind):
    """A JAX `.ckpt.pkl` loads through exp/checkpoint.py: the model's
    parameters and statistics are the converted tree's, the step and epoch
    the file's, and Adam's count and moments under load_opt."""
    import pickle

    from maavss_tpu_torch.train.setup import (
        build_frames_state,
        build_fusion_state,
    )

    cfg = _port_cfg(kind)
    if kind == "frames":
        model, state = build_frames_state(cfg, 2, 24, device="cpu")
    else:
        model, state = build_fusion_state(cfg, 2, "cpu")
    state, epoch = load_checkpoint("unused", state, auto=False,
                                   path=_ckpt(kind), load_opt=True)
    with open(_ckpt(kind), "rb") as f:
        tree = pickle.load(f)
    want = from_flax(tree["params"], tree["batch_stats"])
    got = model.state_dict()
    assert set(got) == set(want) and epoch == 3 and state.step == 0
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())
    adam = tree["opt_state"][0]
    names = [n for n, _ in model.named_parameters()]
    mu = from_flax(adam.mu)
    assert state.tx.count == int(adam.count)
    for n, m in zip(names, state.tx.m):
        np.testing.assert_array_equal(m.numpy(), mu[n].numpy())


def _port_cfg(kind):
    from maavss_tpu_torch.config import model_args

    return model_args(ARGS[kind])


@pytest.mark.parametrize("kind", ["fusion", "frames"])
def test_evaluate_matches_jax(workdir, no_jax_cache, kind, capsys,
                              monkeypatch):
    """evaluate_torch.py against evaluate.py from one checkpoint: the JSON
    line's fields within 1e-3 dB, the example wavs within 1e-4 rel L2."""
    argv = ARGS[kind] + ["--model", kind, "--checkpoint", _ckpt(kind)]
    want = _run(no_jax_cache.main, argv + ["--log_dir", "jax_runs"], capsys,
                monkeypatch)
    got = _run(lambda: evaluate_torch.main(
        argv + ["--log_dir", "port_runs", "--device", "cpu"]), [], capsys,
        monkeypatch)
    assert got["n_clips"] == want["n_clips"] == 2 * _port_cfg(kind).val_steps
    for key in ("si_sdr_mean", "si_sdr_gain_mean"):
        assert np.isfinite(got[key])
        assert abs(got[key] - want[key]) <= DB_TOL, (key, got, want)
    assert got["wav_dir"] == os.path.join("port_runs", "separated")
    for b in (1, 2):
        for what in ("output", "ground_truth"):
            name = f"example_{b}_{what}.wav"
            g, sr_g = read_wav(os.path.join(got["wav_dir"], name))
            w, sr_w = read_wav(os.path.join(want["wav_dir"], name))
            assert sr_g == sr_w == 16000 and g.shape == w.shape
            assert _rel_l2(g, w) <= WAV_RTOL, (name, _rel_l2(g, w))


def test_compare_matches_jax(workdir, no_jax_cache, capsys, monkeypatch):
    """--compare on two wavs: the JAX function's JSON line, SI-SDR and SDR
    within 1e-3 dB (different lengths, the common prefix scored)."""
    rng = np.random.default_rng(9)
    ref = (rng.standard_normal(5000) * 0.3).astype(np.float32)
    est = ref[:4800] + (rng.standard_normal(4800) * 0.05).astype(np.float32)
    write_wav("cmp_ref.wav", ref, 16000)
    write_wav("cmp_est.wav", est, 16000)
    argv = ["--compare", "cmp_est.wav", "cmp_ref.wav"]
    want = _run(no_jax_cache.main, argv, capsys, monkeypatch)
    got = evaluate_torch.main(argv)
    assert got.keys() == want.keys()
    for key in ("si_sdr", "sdr"):
        assert abs(got[key] - want[key]) <= DB_TOL
    assert (got["n_samples"], got["sr"]) == (want["n_samples"], want["sr"])


@pytest.mark.parametrize("with_frames", [False, True],
                         ids=["audio_only", "frame_store"])
def test_separate_matches_jax(workdir, no_jax_cache, with_frames, capsys,
                              monkeypatch):
    """separate_torch.py against separate.py on one stereo wav of 2.6 tiles
    (the last tile and the last batch padded), with the synthetic store's
    frames (32 px, resized to --p_size 16) or zeros: the JSON line, its
    SI-SDR against a reference within 1e-3 dB, the written wav within 1e-4
    rel L2."""
    import separate

    cfg = _port_cfg("fusion")
    n = int(2.6 * cfg.hop * cfg.hops_per_frame
            * (cfg.num_frames + cfg.num_seq))
    rng = np.random.default_rng(4)
    t = np.arange(n) / 16000.0
    clean = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    mix = np.stack([clean + 0.2 * rng.standard_normal(n),
                    clean - 0.1 * rng.standard_normal(n)]).astype(np.float32)
    write_wav("mix.wav", mix, 16000)
    write_wav("clean.wav", clean, 16000)
    if with_frames and not os.path.exists("data/synthetic-p32"):
        jax_setup.load_stores(JaxRunConfig(p_size=32,
                                           data_path="synthetic:1"))
        _broadband("data/synthetic-p32")
    extra = (["--frames", "data/synthetic-p32/frames"] if with_frames
             else [])
    argv = FUSION + ["--checkpoint", _ckpt("fusion"), "--audio", "mix.wav",
                     "--reference", "clean.wav"] + extra
    want = _run(separate.main, argv + ["--out", "jax_sep.wav"], capsys,
                monkeypatch)
    got = separate_torch.main(argv + ["--out", "port_sep.wav",
                                      "--device", "cpu"])
    assert got["tiles"] == want["tiles"] == 3
    for key in ("n_samples", "tile_samples", "sr"):
        assert got[key] == want[key]
    assert abs(got["si_sdr"] - want["si_sdr"]) <= DB_TOL, (got, want)
    g, _ = read_wav("port_sep.wav")
    w, _ = read_wav("jax_sep.wav")
    assert g.shape == w.shape == (1, n)
    assert _rel_l2(g, w) <= WAV_RTOL, _rel_l2(g, w)


def test_resume_flag_finds_the_jax_pickle(workdir):
    """`-c`: the newest checkpoint of --cp_dir, a JAX `.ckpt.pkl` among
    them, loads into the tools' models (every tensor the file's)."""
    import pickle

    for kind in ARGS:
        cfg = _port_cfg(kind).replace(c=True, cp_dir=os.path.join("cp", kind))
        model = (build_frames_model(cfg, 2, 24, device="cpu")
                 if kind == "frames" else build_fusion(cfg, 2, "cpu"))
        evaluate_torch.load_weights(cfg, model)
        with open(_ckpt(kind), "rb") as f:
            tree = pickle.load(f)
        want = from_flax(tree["params"], tree["batch_stats"])
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), (kind, k)
