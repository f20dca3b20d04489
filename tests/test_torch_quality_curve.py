"""tools/quality_curve_torch.py against tools/quality_curve.py on the CPU.

- The eval anchor: on the committed anchor's recipe (--data_path
  synthetic:8 -b 32 at the flagship geometry) the port's eval batches hash
  to the pinned `batch_sha256`, and its noisy anchor, drawn with the
  port's generators, lies within the tool's 0.1 dB of the pinned value
  (no model is built: `noisy_anchor` is the separator's si_sdr_noisy
  mean). The anchor check refuses a drift, relabels it under
  --allow_anchor_drift, and leaves another recipe alone.
- The curve: 4 fusion steps at the small geometry with --eval_every 2, the
  port from JAX's initial state (`from_flax`) at noise 0, both tools
  in-process on one synthetic store whose frames carry broadband noise,
  the anchor file in the temporary directory: the records' keys and
  steps equal, each record's si_sdr and si_sdr_gain within 1e-3 dB, and
  every step's loss within LOSS_RTOL. The conv biases that feed a
  train-mode BatchNorm have a true gradient of 0 that autodiff returns as
  rounding noise, which Adam turns into +-lr a step in either package, and
  which the eval's running statistics then see: each port step takes
  those biases from the JAX step of the same number, as
  tests/test_torch_trainer.py does.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from maavss_tpu.train import setup as jax_setup
from maavss_tpu.train import steps as jax_steps
from maavss_tpu_torch.config import model_args
from maavss_tpu_torch.convert import from_flax
from maavss_tpu_torch.data.dataset import AVDataset, split_train_val
from maavss_tpu_torch.train import steps as port_steps
from maavss_tpu_torch.train.setup import (
    build_fusion_state,
    load_stores,
    make_stream,
)
from tests.test_torch_trainer import _broadband
from tests.test_torch_workers import share_cores
from tools import quality_curve_torch as qc

share_cores()

DB_TOL, LOSS_RTOL = 1e-3, 1e-5
SMALL = ["--num_frames", "4", "--num_seq", "4", "--fft_len", "64",
         "--p_size", "16", "--latent_chan", "8", "--fc_size", "256", "-b",
         "2", "--noise_scalar", "0", "--data_path", "synthetic:3", "-lr",
         "1e-3"]
CURVE = ["--steps", "4", "--eval_every", "2", "--eval_batches", "2"]


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_anchor_recipe_hash_and_noisy_anchor(in_tmp):
    """The pinned recipe's eval batches hash to the committed sha, and the
    noisy anchor reads within 0.1 dB of the committed value."""
    cfg = model_args(["--data_path", "synthetic:8", "-b", "32", "-lr",
                      "1e-3"])
    with open(qc.ANCHOR_FILE) as f:
        pinned = json.load(f)
    assert qc.anchor_recipe(cfg, "fusion", 2) == pinned["recipe"]
    frames, audio = load_stores(cfg)
    ds = AVDataset(cfg, frames, audio, cfg.num_frames + cfg.num_seq)
    _, va = split_train_val(len(ds), cfg.split, cfg.seed)
    it = make_stream(cfg, ds, va, cfg.seed + 1)
    val = [next(it) for _ in range(2)]
    assert qc.batch_sha256(val) == pinned["batch_sha256"]
    anchor = qc.noisy_anchor(cfg, val, [qc.eval_seed(cfg, i)
                                        for i in range(2)])
    assert abs(anchor - pinned["anchor_db"]) <= qc.ANCHOR_TOL_DB, anchor
    # the check itself: within the tolerance it passes ...
    recipe, sha = pinned["recipe"], pinned["batch_sha256"]
    assert not qc.check_anchor(qc.ANCHOR_FILE, recipe, sha, anchor, False)
    # ... past it, or on other batches, it refuses or relabels
    with pytest.raises(SystemExit, match="ANCHOR DRIFT"):
        qc.check_anchor(qc.ANCHOR_FILE, recipe, sha, anchor + 0.2, False)
    with pytest.raises(SystemExit, match="EVAL BATCHES CHANGED"):
        qc.check_anchor(qc.ANCHOR_FILE, recipe, "0" * 64, anchor, False)
    assert qc.check_anchor(qc.ANCHOR_FILE, recipe, sha, anchor + 0.2, True)
    assert not qc.check_anchor(qc.ANCHOR_FILE, dict(recipe, seed=1), "x",
                               0.0, False)


def _lines(out: str):
    return [json.loads(s) for s in out.splitlines() if s.startswith("{")]


def test_curve_matches_jax(in_tmp, monkeypatch, capsys):
    from maavss_tpu.config import model_args as jax_model_args
    from tools import quality_curve as jax_qc

    jcfg = jax_model_args(SMALL)
    jax_setup.load_stores(jcfg)
    _broadband(jax_setup.resolve_data_root(jcfg))
    monkeypatch.setattr(jax_setup, "init_runtime", lambda: None)
    anchor = str(in_tmp / "anchor.json")
    # JAX's tool builds the same initial state as this call
    _, init = jax_setup.build_fusion(jcfg, jcfg.batch_size)
    init_sd = from_flax(*[jax.tree_util.tree_map(np.asarray, t)
                          for t in (init.params, init.batch_stats)])

    jax_losses, jax_states = [], []
    make_jax = jax_steps.make_fusion_step

    def jax_step_maker(*a, **k):
        step = make_jax(*a, **k)

        def run(*args):
            state, m = step(*args)
            jax_losses.append(float(m["loss"]))
            jax_states.append(jax.tree_util.tree_map(
                np.asarray, state.params))
            return state, m
        return run

    monkeypatch.setattr(jax_steps, "make_fusion_step", jax_step_maker)
    monkeypatch.setattr(sys, "argv", ["quality_curve.py"] + SMALL + CURVE
                        + ["--out", "jax.jsonl", "--anchor_file", anchor,
                           "--pin_anchor"])
    capsys.readouterr()
    jax_qc.main()
    want = _lines(capsys.readouterr().out)

    def port_state(cfg, regime, batch_size, frame_size, device):
        model, state = build_fusion_state(cfg, batch_size, device)
        model.load_state_dict(init_sd)
        return model, state

    port_losses = []
    make_port = port_steps.make_fusion_step

    def port_step_maker(model, *a, **k):
        step = make_port(model, *a, **k)
        fed = model.bn_fed_biases()

        def run(state, *args):
            state, m = step(state, *args)
            port_losses.append(float(m["loss"]))
            synced = from_flax(jax_states[len(port_losses) - 1])
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name in fed:
                        p.copy_(synced[name])
            return state, m
        return run

    monkeypatch.setattr(qc, "build_state", port_state)
    monkeypatch.setattr(port_steps, "make_fusion_step", port_step_maker)
    summary = qc.main(SMALL + CURVE + ["--out", "port.jsonl", "--anchor_file",
                                       anchor, "--device", "cpu"])
    assert "[anchor] ok" in capsys.readouterr().out  # the pin enforced
    with open("port.jsonl") as f:
        got_recs = [json.loads(s) for s in f]
    with open("jax.jsonl") as f:
        want_recs = [json.loads(s) for s in f]
    assert [r["step"] for r in got_recs] == [r["step"] for r in want_recs] \
        == [0, 2, 4, 4]
    for g, w in zip(got_recs, want_recs):
        assert g.keys() == w.keys()
        for key in ("si_sdr", "si_sdr_gain", "noisy_anchor"):
            assert abs(g[key] - w[key]) <= DB_TOL, (key, g, w)
        assert g["n_clips"] == w["n_clips"] == 4
    assert len(port_losses) == len(jax_losses) == 4
    np.testing.assert_allclose(port_losses, jax_losses, rtol=LOSS_RTOL)
    want_summary = want[-1]
    assert summary.keys() == want_summary.keys()
    assert summary["regime"] == "fusion" and summary["mask_head"] is False
    assert np.isclose(summary["loss"], want_summary["loss"], rtol=LOSS_RTOL)
