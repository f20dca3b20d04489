"""The port's data layer and experiment-plane copies against the JAX
package, on the CPU.

- The numpy-only modules the port copies (data/wavio.py, frame_shards.py,
  audio_memmap.py, clip_index.py, dataset.py and exp/metrics.py) are
  pinned to their originals: the code after the module docstring is the
  original's, with its `maavss_tpu.` imports made `maavss_tpu_torch.`.
- Both packages' `build_synthetic_store` write the same files: equal frame
  shards, wavs and audio memmap, equal meta.json and memmap index.
- Over one store, `AVDataset` gives JAX's items array for array (raw
  frames, and float16 phasegram rows under --pgram_cache), and
  `make_stream` JAX's batches, unstacked and stacked [K, B, ...] (K = 2),
  train and validation splits; --native_loader raises instead of quietly
  taking the Python pipeline.
- tools/save_phasegrams_torch.py writes, in save_phasegrams.py's layout,
  the float16 rounding of the port's `phasegram_cumsum` of the frames, bit
  for bit. On broadband frames (uniform uint8 noise: the smooth blob
  frames have FFT bins of near-zero magnitude, whose phase is numerically
  arbitrary) it writes save_phasegrams.py's rows within float16's rounding
  but for whole steps of 1/S (S = p_size^2) in a few elements: the bins on
  the real axis have phase +pi or -pi by rounding, which differs between
  pocketfft and XLA's FFT (ROADMAP §3), and a 2 pi flip of one angle moves
  every later cumsum entry by 2 pi / (2 pi S).

Each test runs in its own temporary directory: AVDataset keeps its
clip-index cache under ./clipcache.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data import dataset as jax_dataset
from maavss_tpu.data.synthetic import build_synthetic_store as jax_build
from maavss_tpu.train import setup as jax_setup
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.data import dataset as port_dataset
from maavss_tpu_torch.data.frame_shards import (
    FrameShardStore,
    write_frame_shard,
)
from maavss_tpu_torch.data.synthetic import build_synthetic_store as port_build
from maavss_tpu_torch.ops.phasegram import phasegram_cumsum
from maavss_tpu_torch.train import setup as port_setup
from tests.test_torch_workers import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_frames=4, num_seq=2, fft_len=64, p_size=16, latent_chan=8,
             fc_size=256, batch_size=3)


def _code(path: str) -> str:
    """The source after the module docstring."""
    src = open(path).read()
    end = ast.parse(src).body[0].end_lineno
    return "\n".join(src.splitlines()[end:])


@pytest.mark.parametrize("module", [
    "data/wavio.py", "data/frame_shards.py", "data/audio_memmap.py",
    "data/clip_index.py", "data/dataset.py", "exp/metrics.py"])
def test_copy_pinned_to_original(module):
    jax_src = _code(os.path.join(ROOT, "maavss_tpu", module))
    port_src = _code(os.path.join(ROOT, "maavss_tpu_torch", module))
    assert port_src == jax_src.replace("from maavss_tpu.",
                                       "from maavss_tpu_torch.")
    assert "maavss_tpu." not in port_src.replace("maavss_tpu_torch.", "")


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(d, n), root)] = \
                os.path.join(d, n)
    return out


def test_build_synthetic_store_equals_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for build, cfg, out in ((jax_build, JaxRunConfig(**SMALL), "jax"),
                            (port_build, RunConfig(**SMALL), "port")):
        build(out, cfg, n_videos=3, seconds=1.0, frame_size=16, seed=4)
    a, b = _files("jax"), _files("port")
    assert set(a) == set(b) and len(a) >= 8
    for rel in a:
        if rel.endswith(".json"):
            ja, jb = (json.load(open(p)) for p in (a[rel], b[rel]))
            assert json.dumps(ja).replace("jax/", "port/") == json.dumps(jb)
        elif rel.endswith(".obj"):  # the reference-format pickle of paths
            continue
        else:
            assert open(a[rel], "rb").read() == open(b[rel], "rb").read(), rel


def _stores(cfg_cls, out):
    cfg = cfg_cls(**SMALL).replace(data_path=out)
    mod = jax_setup if cfg_cls is JaxRunConfig else port_setup
    frames, audio = mod.load_stores(cfg)
    return cfg, frames, audio


@pytest.fixture
def store(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port_build("store", RunConfig(**SMALL), n_videos=3, seconds=2.0,
               frame_size=16, seed=1)
    return "store"


def _equal_batches(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dataset_items_and_streams_equal_jax(store):
    runs = {}
    for cfg_cls, ds_mod, mod in ((JaxRunConfig, jax_dataset, jax_setup),
                                 (RunConfig, port_dataset, port_setup)):
        cfg, frames, audio = _stores(cfg_cls, store)
        clip_len = cfg.num_frames + cfg.num_seq
        ds = ds_mod.AVDataset(cfg, frames, audio, clip_len,
                              cache_dir=f"clipcache-{cfg_cls.__module__}")
        tr, va = ds_mod.split_train_val(len(ds), cfg.split, cfg.seed)
        items = [ds[i] for i in range(0, len(ds), 7)]
        if mod is jax_setup:
            streams = [mod.make_stream(cfg, ds, tr, None, 3),
                       mod.make_stream(cfg, ds, va, None, 4),
                       mod.make_stream(cfg, ds, tr, None, 3, stack=2)]
        else:
            streams = [mod.make_stream(cfg, ds, tr, 3),
                       mod.make_stream(cfg, ds, va, 4),
                       mod.make_stream(cfg, ds, tr, 3, stack=2)]
        batches = [[next(s) for _ in range(3)] for s in streams]
        runs[cfg_cls] = (len(ds), tr, va, items, batches)
    (n_j, tr_j, va_j, items_j, b_j), (n_p, tr_p, va_p, items_p, b_p) = \
        runs[JaxRunConfig], runs[RunConfig]
    assert n_j == n_p > 0
    np.testing.assert_array_equal(tr_j, tr_p)
    np.testing.assert_array_equal(va_j, va_p)
    for a, b in zip(items_j, items_p):
        _equal_batches(a, b)
    for sj, sp in zip(b_j, b_p):
        for a, b in zip(sj, sp):
            _equal_batches(a, b)
    assert b_p[2][0]["audio"].shape[:2] == (2, SMALL["batch_size"])
    assert b_p[2][0]["frames"].dtype == np.uint8


def test_pgram_rows_from_the_port_tool_equal_jax(store):
    """tools/save_phasegrams_torch.py's rows against save_phasegrams.py's
    over a store of broadband frames, and the port's AVDataset's 'pgram'
    items from the rows it writes for the synthetic store."""
    import save_phasegrams
    from tools import save_phasegrams_torch

    port_build_rows = save_phasegrams_torch.build_pgram_store(store, 16,
                                                              "cpu")
    rng = np.random.default_rng(7)
    for v in range(2):
        write_frame_shard(os.path.join("noisy", "frames"), f"vid{v:03d}",
                          rng.integers(0, 256, (40, 16, 16), np.uint8), 30.0)
    jax_dir = save_phasegrams.build_pgram_store("noisy", 16)
    rows_j = {f: np.load(os.path.join(jax_dir, f))
              for f in sorted(os.listdir(jax_dir)) if f.endswith(".npy")}
    meta_j = json.load(open(os.path.join(jax_dir, "meta.json")))
    port_dir = save_phasegrams_torch.build_pgram_store("noisy", 16, "cpu")
    assert port_dir == jax_dir
    meta_p = json.load(open(os.path.join(port_dir, "meta.json")))
    assert meta_p == meta_j
    frames = FrameShardStore(os.path.join("noisy", "frames"))
    s = 16 * 16
    flipped = 0
    for v, (f, want) in enumerate(rows_j.items()):
        got = np.load(os.path.join(port_dir, f))
        assert got.dtype == np.float16 and got.shape == want.shape
        fr = torch.from_numpy(frames.read(v, np.arange(len(got))))
        own = phasegram_cumsum(fr.float()[None] / 255.0)[0]
        np.testing.assert_array_equal(got, own.half().numpy(), err_msg=f)
        # values in [-1/2, 1/2]: two float16 roundings within 2^-12
        d = got.astype(np.float64) - want.astype(np.float64)
        steps = np.round(d * s)
        np.testing.assert_allclose(d - steps / s, 0.0, rtol=0,
                                   atol=2.0 ** -11, err_msg=f)
        flipped += np.count_nonzero(steps)
    assert flipped <= 0.05 * sum(r.size for r in rows_j.values())
    cfg = RunConfig(**SMALL).replace(data_path=store, pgram_cache=True)
    assert port_build_rows == os.path.join(store, "pgrams-p16")
    ds = port_dataset.AVDataset(
        cfg, *port_setup.load_stores(cfg), cfg.num_frames + cfg.num_seq,
        pgrams=port_setup.load_pgram_store(cfg))
    item = ds[5]
    assert set(item) == {"audio", "pgram"}
    assert item["pgram"].shape == (cfg.num_frames + cfg.num_seq, 16 * 16)


def test_native_loader_raises(store):
    cfg, frames, audio = _stores(RunConfig, store)
    ds = port_dataset.AVDataset(cfg, frames, audio, 6)
    with pytest.raises(NotImplementedError, match="M6-rest"):
        port_setup.make_stream(cfg.replace(native_loader=True), ds)


def test_missing_stores_exit_like_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for cfg_cls, mod in ((JaxRunConfig, jax_setup),
                         (RunConfig, port_setup)):
        msgs = []
        for flags, fn in ((dict(data_path="nowhere"), mod.load_stores),
                          (dict(data_path="nowhere", pgram_cache=True),
                           mod.load_pgram_store),
                          (dict(autocontrast=True), mod.load_stores)):
            with pytest.raises(SystemExit) as err:
                fn(cfg_cls(**SMALL).replace(**flags))
            msgs.append(str(err.value))
        if cfg_cls is JaxRunConfig:
            want = msgs
    # the pgram message names the port's tool, which needs no jax
    want[1] = want[1].replace("python save_phasegrams.py",
                              "python tools/save_phasegrams_torch.py")
    assert msgs == want


def test_profiling_on_the_cpu(tmp_path):
    """exp/profiling.py: `trace` writes a Chrome trace and yields the
    profile, `annotate` labels a region in it, `PhaseTimer` means seconds
    by phase."""
    from maavss_tpu_torch.exp.profiling import PhaseTimer, annotate, trace

    timer = PhaseTimer()
    with trace(str(tmp_path / "t")) as prof:
        for _ in range(2):
            with annotate("block"), timer.phase("mm"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "t" / "trace.json") > 0
    assert any(e.key == "block" and e.count == 2
               for e in prof.key_averages())
    summary = timer.summary()
    assert set(summary) == {"time_mm"} and summary["time_mm"] > 0
