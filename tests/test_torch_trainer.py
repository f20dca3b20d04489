"""The port's Trainer (maavss_tpu_torch/train/trainer.py) and checkpoints
(exp/checkpoint.py) against the JAX package's, on the CPU.

- Bookkeeping, with stub steps: one stub loss, a function of the global
  step, the mode and the batch, goes into both Trainers, over the same
  numpy batch streams. The JSONL records (without `ts` and the meter's
  `clips_per_sec_per_chip`, wall-clock values), the histogram records
  (MAAVSS_WATCH=1; the port's tiny model holds the JAX one's weights under
  the same flax names) and the sequence of checkpoint saves (epoch, loss,
  step) must be equal, under every mode schedule, --steps_per_dispatch 2,
  cp_freq, both policies, --noise_schedule, a SIGTERM (drained, saved,
  resumed with -c and --cp_load_opt) and a second SIGINT. The JAX package
  runs its pickle checkpoint backend (MAAVSS_CKPT_BACKEND=pkl).
- Real steps: the small fusion geometry, noise_scalar 0, --mode_schedule
  fixed (mode 2), 3 epochs x 2 steps, val_steps 1, both packages on their
  own data pipeline over one synthetic store whose frames carry broadband
  noise (`_broadband`), the port from `from_flax` of JAX's init: losses
  and val losses within 1e-4 relative.
- A JAX pickle-backend `save_model` file loads into the port in a process
  that imports no jax (`load_model`); the port's eval then equals JAX's
  within 1e-5 (both with the initial BatchNorm statistics: the file holds
  the parameters only).
- The port's checkpoints restore in place (the tensors a captured CUDA
  graph holds keep their addresses) and refuse a missing or extra key.
"""

import glob
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data.dataset import AVDataset as JaxAVDataset
from maavss_tpu.exp import checkpoint as jax_ckpt
from maavss_tpu.models.fusion import AVFusionModel as JaxFusion
from maavss_tpu.train import setup as jax_setup
from maavss_tpu.train import trainer as jax_trainer_mod
from maavss_tpu.train.state import create_train_state as jax_create_state
from maavss_tpu.train.state import make_optimizer as jax_make_optimizer
from maavss_tpu.train.steps import make_fusion_eval as jax_make_eval
from maavss_tpu.train.steps import make_fusion_step as jax_make_step
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.convert import from_flax
from maavss_tpu_torch.data.dataset import AVDataset, split_train_val
from maavss_tpu_torch.data.frame_shards import (
    FrameShardStore,
    write_frame_shard,
)
from maavss_tpu_torch.data.synthetic import build_synthetic_store
from maavss_tpu_torch.exp import checkpoint as port_ckpt
from maavss_tpu_torch.train import setup as port_setup
from maavss_tpu_torch.train import trainer as port_trainer_mod
from maavss_tpu_torch.train.fused_adam import FusedAdam
from maavss_tpu_torch.train.setup import build_fusion_state
from maavss_tpu_torch.train.state import TrainState
from maavss_tpu_torch.train.steps import make_fusion_eval, make_fusion_step
from tests.test_torch_workers import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOK = dict(epochs=4, steps_per_epoch=4, val_steps=2, cb_freq=2,
            batch_size=3)
WALL = ("ts", "clips_per_sec_per_chip")


class TinyNet(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Dense(3)(x)


class TinyPort(torch.nn.Module):
    """TinyNet's tree in the port: `to_flax` names it Dense_0/kernel, bias."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(4, 3)


def _tiny_states():
    variables = TinyNet().init(jax.random.PRNGKey(0), jnp.ones((2, 4)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    jstate = jax_create_state({"params": params},
                              jax_make_optimizer(1e-3, "adam"))
    model = TinyPort()
    model.load_state_dict(from_flax(params))
    pstate = TrainState(model=model,
                        tx=FusedAdam(list(model.parameters()), 1e-3,
                                     kernel="xla"))
    return jstate, pstate


def _loss(step, mode, batch):
    return (np.float32(0.01 * step + 0.1 * mode)
            + np.float32(np.asarray(batch["audio"], np.float32).mean()))


def _stub_metrics(k, first, mode, batch, noise):
    """[k] (or 0-d) float32 metrics of the k steps from global step
    `first`."""
    rows = [batch if k == 1 else {n: v[j] for n, v in batch.items()}
            for j in range(k)]
    loss = np.array([_loss(first + j, mode, r) for j, r in enumerate(rows)],
                    np.float32)
    out = {"loss": loss, "a_loss": loss * np.float32(0.5),
           "grad_norm": loss + np.float32(1.0)}
    if noise is not None:
        out["noise"] = np.full(k, noise, np.float32)
    return {n: v if k > 1 else v[0] for n, v in out.items()}


def _stubs(k, hook=None):
    """(jax_step, port_step, jax_eval, port_eval) sharing one stub loss;
    `hook(call_index)` runs inside the n-th step call of either."""
    calls = {"jax": 0, "port": 0}

    def jax_step(state, batch, rng, mode, noise=None):
        calls["jax"] += 1
        if hook:
            hook(calls["jax"])
        m = _stub_metrics(k, int(state.step) + 1, int(mode), batch,
                          None if noise is None else np.float32(noise))
        return (state.replace(step=state.step + k),
                {n: jnp.asarray(v) for n, v in m.items()})

    def port_step(state, batch, mode, generator, noise=None):
        assert isinstance(generator, torch.Generator)
        calls["port"] += 1
        if hook:
            hook(calls["port"])
        m = _stub_metrics(k, state.step + 1, int(mode), batch,
                          None if noise is None else np.float32(noise))
        state.step += k
        return state, {n: torch.as_tensor(v) for n, v in m.items()}

    def val(mode, batch):
        return np.float32(0.5 + 0.25 * ((mode + 1) % 3)) + np.float32(
            np.asarray(batch["audio"], np.float32).mean())

    def jax_eval(state, batch, rng, mode):
        return {"loss": jnp.asarray(val(int(mode), batch))}

    def port_eval(state, batch, mode, generator):
        return {"loss": torch.as_tensor(val(int(mode), batch))}

    return jax_step, port_step, jax_eval, port_eval


def _stream(seed, k=1):
    rng = np.random.default_rng(seed)
    while True:
        b = {"audio": rng.standard_normal((BOOK["batch_size"], 8)).astype(
            np.float32)}
        if k > 1:
            b = {"audio": np.stack([b["audio"]] + [
                rng.standard_normal(b["audio"].shape).astype(np.float32)
                for _ in range(k - 1)])}
        yield b


def _records(log_dir, name, kind="metrics"):
    path = os.path.join(log_dir, name, f"{kind}.jsonl")
    if not os.path.exists(path):
        return []
    return [{k: v for k, v in json.loads(line).items() if k not in WALL}
            for line in open(path)]


@pytest.fixture
def book(tmp_path, monkeypatch):
    """chdir into tmp_path, the pickle backend for JAX, histograms on, and
    every checkpoint save of either Trainer recorded."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MAAVSS_CKPT_BACKEND", "pkl")
    monkeypatch.setenv("MAAVSS_WATCH", "1")
    saves = {"jax": [], "port": []}
    for key, mod in (("jax", jax_trainer_mod), ("port", port_trainer_mod)):
        real = mod.save_checkpoint

        def wrapped(cp_dir, name, state, epoch=0, loss=0.0, _real=real,
                    _key=key):
            saves[_key].append((int(epoch), float(loss), int(state.step)))
            return _real(cp_dir, name, state, epoch, loss)

        monkeypatch.setattr(mod, "save_checkpoint", wrapped)
    return saves


def _run_both(flags, saves, hook=None, states=None, expect=None,
              with_eval=True):
    """Fit both Trainers with the same stubs and streams; returns the two
    runs' records and histogram records, and asserts the saves agree."""
    k = flags.get("steps_per_dispatch", 1)
    jstep, pstep, jeval, peval = _stubs(k, hook)
    jstate, pstate = states or _tiny_states()
    schedule = flags.pop("mode_schedule", "cycle")
    policy = flags.pop("policy", "epoch")
    out = {}
    for key, cfg_cls, mod, step, ev, state in (
            ("jax", JaxRunConfig, jax_trainer_mod, jstep, jeval, jstate),
            ("port", RunConfig, port_trainer_mod, pstep, peval, pstate)):
        cfg = cfg_cls(**{**BOOK, **flags}).replace(
            log_dir=f"logs-{key}", cp_dir=f"cp-{key}")
        trainer = mod.Trainer(cfg, step, state, run_name="run",
                              eval_fn=ev if with_eval else None,
                              mode_schedule=schedule,
                              checkpoint_policy=policy)
        if expect is None:
            trainer.fit(_stream(1, k), _stream(2))
        else:
            with pytest.raises(expect):
                trainer.fit(_stream(1, k), _stream(2))
        out[key] = (_records(cfg.log_dir, "run"),
                    _records(cfg.log_dir, "run", "histograms"),
                    trainer.epoch, trainer.mode)
    assert saves["jax"] == saves["port"]
    return out


@pytest.mark.parametrize("flags", [
    dict(mode_schedule="cycle"),
    dict(mode_schedule="cycle", mode_freq=2),
    dict(mode_schedule="random01"),
    dict(mode_schedule="random:1,1,2", seed=3),
    dict(mode_schedule="fixed"),
    dict(mode_schedule="cycle", steps_per_dispatch=2),
    dict(mode_schedule="cycle", cp_freq=3, cb_freq=3),
    dict(mode_schedule="random01", policy="best", seed=5),
    dict(mode_schedule="cycle", noise_schedule="linear:0.3:0.0"),
])
def test_records_equal_jax(book, flags):
    out = _run_both(dict(flags), book)
    (rj, hj, ej, mj), (rp, hp, ep, mp) = out["jax"], out["port"]
    n = BOOK["epochs"] * BOOK["steps_per_epoch"]
    assert len([r for r in rp if "loss" in r]) == n
    assert len([r for r in rp if "val_loss" in r]) == BOOK["epochs"]
    assert rp == rj
    assert hp == hj and len(hp) >= BOOK["epochs"]
    assert (ep, mp) == (ej, mj)
    assert book["port"]
    if flags.get("steps_per_dispatch"):
        assert [r["step"] for r in rp if "loss" in r] == list(range(1, n + 1))


def test_sigterm_save_and_resume_equal_jax(book):
    """SIGTERM from inside the 6th step: both drain, save at epoch 1 and
    return; -c --cp_load_opt resumes AT epoch 1 (JAX's quirk) with 'cycle'
    back at mode 0, and the resumed runs' records agree too."""
    def hook(n):
        if n == 6:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    out = _run_both(dict(), book, hook=hook)
    assert signal.getsignal(signal.SIGTERM) is before
    (rj, _, _, _), (rp, _, ep, _) = out["jax"], out["port"]
    assert rp == rj and ep == 1
    assert any(r.get("preempted") for r in rp)
    assert sum(1 for r in rp if "loss" in r) == 6
    assert book["port"][-1][0] == 1 and book["port"][-1][2] == 6

    jstate, pstate = _tiny_states()
    resumed = {}
    for key, cfg_cls, mod, state in (
            ("jax", JaxRunConfig, jax_trainer_mod, jstate),
            ("port", RunConfig, port_trainer_mod, pstate)):
        jstep, pstep, jeval, peval = _stubs(1)
        cfg = cfg_cls(**BOOK).replace(log_dir=f"logs2-{key}",
                                      cp_dir=f"cp-{key}", c=True,
                                      cp_load_opt=True)
        trainer = mod.Trainer(cfg, jstep if key == "jax" else pstep, state,
                              run_name="run2",
                              eval_fn=jeval if key == "jax" else peval)
        assert trainer.epoch == 1 and trainer.mode == 0
        assert int(trainer.state.step) == 6
        trainer.fit(_stream(1), _stream(2))
        resumed[key] = _records(cfg.log_dir, "run2")
    assert resumed["port"] == resumed["jax"]
    assert [r["step"] for r in resumed["port"] if "loss" in r][0] == 7


def test_second_sigint_raises_like_jax(book):
    def hook(n):
        if n == 3:
            os.kill(os.getpid(), signal.SIGINT)  # the flag
            os.kill(os.getpid(), signal.SIGINT)  # raises at once

    before = signal.getsignal(signal.SIGINT)
    out = _run_both(dict(), book, hook=hook, expect=KeyboardInterrupt)
    assert signal.getsignal(signal.SIGINT) is before
    assert out["port"][0] == out["jax"][0]


# ------------------------------------------------------- checkpoints

def test_checkpoint_restores_in_place(tmp_path):
    cfg = RunConfig(num_frames=4, num_seq=2, fft_len=64, p_size=16,
                    latent_chan=8, fc_size=256)
    _, state = build_fusion_state(cfg, 2, "cpu",
                                  torch.Generator().manual_seed(1))
    for i, (m, v) in enumerate(zip(state.tx.m, state.tx.v)):
        m.fill_(0.1 * i)
        v.fill_(0.01 * i)
    state.tx.count, state.step = 5, 5
    port_ckpt.save_checkpoint(str(tmp_path), "a", state, epoch=2, loss=0.5)
    _, other = build_fusion_state(cfg, 2, "cpu",
                                  torch.Generator().manual_seed(2))
    ptrs = [t.data_ptr() for t in list(other.model.state_dict().values())
            + other.tx.m + other.tx.v + [other.tx.count_tensor]]
    restored, epoch = port_ckpt.load_checkpoint(str(tmp_path), other,
                                                load_opt=True)
    assert restored is other and epoch == 2 and other.step == 5
    assert ptrs == [t.data_ptr() for t in list(
        other.model.state_dict().values()) + other.tx.m + other.tx.v
        + [other.tx.count_tensor]]
    for (k, a), b in zip(state.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.tx.m + state.tx.v, other.tx.m + other.tx.v):
        assert torch.equal(a, b)
    assert other.tx.count == 5 and float(other.tx.count_tensor) == 5.0
    # without --cp_load_opt the moments and count stay
    _, third = build_fusion_state(cfg, 2, "cpu")
    port_ckpt.load_checkpoint(str(tmp_path), third)
    assert third.tx.count == 0 and not third.tx.m[1].any()
    # a model with another tree refuses the file
    wide = cfg.replace(fc_size=128)
    _, bad = build_fusion_state(wide, 2, "cpu")
    with pytest.raises(KeyError, match="missing"):
        port_ckpt.load_checkpoint(str(tmp_path), bad)
    with pytest.raises(KeyError, match="missing"):
        port_ckpt.load_model(port_ckpt.save_model(
            str(tmp_path / "tiny"), TinyPort()), state.model)
    assert port_ckpt.load_checkpoint(str(tmp_path / "none"), third) == (
        third, 0)


# ------------------------------------------------------- real steps

GEOMETRY = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
                p_size=16, latent_chan=8, fc_size=256, learning_rate=1e-3,
                batch_size=4, noise_scalar=0.0, pgenc_kernel="xla",
                epochs=3, steps_per_epoch=2, val_steps=1, cb_freq=1,
                mode_schedule="fixed")


def _jax_model(cfg):
    t_stft = cfg.hops_per_frame * cfg.num_frames
    return JaxFusion(
        stft_shape=(cfg.batch_size, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(cfg.batch_size, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        pgenc_kernel="xla")


def _broadband(root):
    """Add uniform noise to the store's blob frames: a smooth blob has FFT
    bins of near-zero magnitude whose phase, and so the phasegram target,
    is numerically arbitrary (tests/test_torch_train_step.py uses noisy
    frames for the same reason)."""
    store = FrameShardStore(os.path.join(root, "frames"))
    rng = np.random.default_rng(3)
    for v, vid in enumerate(store.video_ids):
        fr = store.read(v, np.arange(store.num_frames(v))).astype(np.int16)
        fr = np.clip(fr + rng.integers(-25, 26, fr.shape), 0, 255)
        write_frame_shard(os.path.join(root, "frames"), vid,
                          fr.astype(np.uint8), store.fps(v))


@pytest.fixture(scope="module")
def real_runs(tmp_path_factory):
    """Both packages' Trainers on real steps (module docstring), run once:
    (records by package, the JAX model, its init variables, its final
    state, the store's directory)."""
    cwd = os.getcwd()
    root = tmp_path_factory.mktemp("real")
    os.chdir(root)
    old = os.environ.get("MAAVSS_CKPT_BACKEND")
    os.environ["MAAVSS_CKPT_BACKEND"] = "pkl"
    try:
        build_synthetic_store("store", RunConfig(**GEOMETRY), n_videos=3,
                              seconds=2.0, frame_size=16, seed=2)
        _broadband("store")
        jcfg = JaxRunConfig(**GEOMETRY).replace(
            data_path="store", log_dir="logs-jax", cp_dir="cp-jax")
        model = _jax_model(jcfg)
        variables = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda key: model.init(key, jnp.zeros(model.stft_shape),
                                   jnp.zeros(model.pgram_shape),
                                   method=model.init_all))(
                jax.random.PRNGKey(0)))
        frames, audio = jax_setup.load_stores(jcfg)
        ds = JaxAVDataset(jcfg, frames, audio, 8, cache_dir="cc-jax")
        tr, va = split_train_val(len(ds), jcfg.split, jcfg.seed)
        jstate = jax_create_state(variables,
                                  jax_make_optimizer(1e-3, "adam"))
        trainer = jax_trainer_mod.Trainer(
            jcfg, jax_make_step(model, jcfg), jstate, run_name="real",
            eval_fn=jax_make_eval(model, jcfg), mode_schedule="fixed")
        jfinal = trainer.fit(jax_setup.make_stream(jcfg, ds, tr, None, 0),
                             jax_setup.make_stream(jcfg, ds, va, None, 1))

        cfg = RunConfig(**GEOMETRY).replace(
            data_path="store", log_dir="logs-port", cp_dir="cp-port")
        pmodel, pstate = build_fusion_state(cfg, cfg.batch_size, "cpu")
        pmodel.load_state_dict(from_flax(variables["params"],
                                         variables["batch_stats"]))
        pds = AVDataset(cfg, *port_setup.load_stores(cfg), 8,
                        cache_dir="cc-port")
        trainer = port_trainer_mod.Trainer(
            cfg, make_fusion_step(pmodel, cfg, device="cpu"), pstate,
            run_name="real", eval_fn=make_fusion_eval(pmodel, cfg, "cpu"),
            mode_schedule="fixed")
        trainer.fit(port_setup.make_stream(cfg, pds, tr, 0),
                    port_setup.make_stream(cfg, pds, va, 1))
        records = {k: _records(f"logs-{k}", "real") for k in ("jax", "port")}
        yield records, model, jcfg, variables, jfinal, pds, root
    finally:
        os.chdir(cwd)
        if old is None:
            os.environ.pop("MAAVSS_CKPT_BACKEND", None)
        else:
            os.environ["MAAVSS_CKPT_BACKEND"] = old


def test_real_steps_track_jax(real_runs):
    records = real_runs[0]
    for key in ("loss", "a_loss", "v_loss", "val_loss"):
        want = [r[key] for r in records["jax"] if key in r]
        got = [r[key] for r in records["port"] if key in r]
        assert len(got) == len(want) == (3 if key == "val_loss" else 6)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0, err_msg=key)
    assert [r["step"] for r in records["port"]] == \
        [r["step"] for r in records["jax"]]
    assert os.path.exists(os.path.join(real_runs[-1], "cp-port",
                                       "real.ckpt.pt"))


def test_jax_saved_model_loads_without_jax(real_runs):
    _, model, jcfg, variables, jfinal, pds, root = real_runs
    path = jax_ckpt.save_model(os.path.join(str(root), "saved", "jax"),
                               jfinal.params)
    assert path.endswith(".params.pkl")
    out = os.path.join(str(root), "loaded.pt")
    code = (
        "import sys, torch\n"
        "from maavss_tpu_torch.config import RunConfig\n"
        "from maavss_tpu_torch.exp.checkpoint import load_model\n"
        "from maavss_tpu_torch.train.setup import build_fusion\n"
        f"cfg = RunConfig(**{GEOMETRY!r})\n"
        "model = build_fusion(cfg, cfg.batch_size, 'cpu')\n"
        f"load_model({path!r}, model)\n"
        f"torch.save(model.state_dict(), {out!r})\n"
        "bad = [m for m in ('jax', 'flax', 'maavss_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    cfg = RunConfig(**GEOMETRY)
    from maavss_tpu_torch.train.setup import build_fusion

    pmodel = build_fusion(cfg, cfg.batch_size, "cpu")
    pmodel.load_state_dict(torch.load(out))
    _, pstate = build_fusion_state(cfg, cfg.batch_size, "cpu")
    pstate.model = pmodel
    batch = next(port_setup.make_stream(cfg, pds, None, 9))
    got = make_fusion_eval(pmodel, cfg, "cpu")(pstate, batch, 2)
    # JAX's eval of the saved parameters with the initial statistics
    jstate = jfinal.replace(batch_stats=variables["batch_stats"])
    want = jax_make_eval(model, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), jnp.int32(2))
    for k in ("loss", "a_loss", "v_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=0, err_msg=k)


def test_fit_tool_writes_media(tmp_path, monkeypatch):
    """tools/fit_torch.py: MAAVSS_MEDIA=1 (train.py's media callback) on a
    fusion run, with --native_loader: every --cb_freq steps the STFT panel
    and the input and separated wavs of the batch's first clip under
    <log_dir>/<run>/media/ (tests/test_torch_viz.py holds their content
    against the JAX package's)."""
    from maavss_tpu_torch.config import model_args
    from tools import fit_torch

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MAAVSS_MEDIA", "1")
    cfg = model_args(["--data_path", "store", "-e", "1", "-s", "4",
                      "-v", "1", "-b", "2", "--num_frames", "4",
                      "--fft_len", "64", "--p_size", "16", "--latent_chan",
                      "8", "--fc_size", "256", "-lr", "1e-3", "--cb_freq",
                      "2", "--native_loader", "--no_save"])
    build_synthetic_store("store", cfg, n_videos=3, seconds=1.0,
                          frame_size=16, seed=2)
    state = fit_torch.fit(cfg, "fusion", "cpu")
    assert state.step == 4
    media = glob.glob(os.path.join(cfg.log_dir, "*", "media"))
    assert len(media) == 1
    names = sorted(os.listdir(media[0]))
    assert names == [f"{kind}_{step:07d}.{ext}" for kind, ext in (
        ("audio_in", "wav"), ("audio_out", "wav"), ("stft", "png"))
        for step in (1, 3)], names
