"""--native_loader in the port (maavss_tpu_torch/data/native_loader.py and
train/setup.make_stream) against the JAX package's C++ loader, on the CPU.

- With one worker thread both loaders give the same batch sequence from
  one store and seed, bit for bit, over two epochs: the whole dataset, a
  subset of clips (a train split), and a --max_clip_len view
  (tests/test_native_loader.py's cases). With more threads the rows of a
  batch come in the order the threads take their clips, on both sides.
- Every row is a dataset item: the audio slice and the uint8 frames of
  AVDataset[i] for the clip the row names.
- make_stream takes the C++ loader for an {audio, frames} dataset, also
  stacked [K, B, ...] (K = 2, --steps_per_dispatch), and the Python
  pipeline for phasegram rows.
- The port builds its own copy of the source (data/dataloader.cc) with the
  host's compiler; a failed build raises (tests/test_torch_data.py).
"""

import os

import numpy as np
import pytest

from maavss_tpu.config import RunConfig as JaxRunConfig
from maavss_tpu.data import native_loader as jax_native
from maavss_tpu.data.audio_memmap import AudioMemmap as JaxAudio
from maavss_tpu.data.dataset import AVDataset as JaxAVDataset
from maavss_tpu.data.frame_shards import FrameShardStore as JaxFrames
from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.data import native_loader
from maavss_tpu_torch.data.audio_memmap import (
    AudioMemmap,
    build_audio_memmap,
)
from maavss_tpu_torch.data.dataset import AVDataset
from maavss_tpu_torch.data.frame_shards import (
    FrameShardStore,
    write_frame_shard,
)
from maavss_tpu_torch.data.synthetic import build_synthetic_store
from maavss_tpu_torch.data.wavio import write_wav
from maavss_tpu_torch.train import setup as port_setup
from tests.test_torch_workers import share_cores

share_cores()

CFG = dict(num_frames=4, num_seq=4, hops_per_frame=4, fft_len=64,
           p_size=16, frame_hop=2, framerate=30)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """One synthetic store (tests/test_native_loader.py's), and the JAX
    and port datasets over it."""
    d = tmp_path_factory.mktemp("native_store")
    cfg = RunConfig(**CFG)
    frames, audio = build_synthetic_store(str(d), cfg, n_videos=3,
                                          seconds=1.5)
    clip = cfg.num_frames + cfg.num_seq
    port = AVDataset(cfg, frames, audio, clip, cache_dir=str(d / "cc"))
    jax_ds = JaxAVDataset(JaxRunConfig(**CFG), JaxFrames(frames.dir),
                          JaxAudio(os.path.dirname(audio.map.filename)),
                          clip, cache_dir=str(d / "cc_jax"))
    return port, jax_ds


def _long_store(tmp_path):
    """Two videos of 20 and 40 frames; --max_clip_len 30 leaves the
    shorter one's clips (tests/test_native_loader.py's store)."""
    rng = np.random.default_rng(0)
    cfg = RunConfig(**CFG)
    frames_dir = str(tmp_path / "frames")
    audio_dir = str(tmp_path / "audio")
    os.makedirs(audio_dir)
    lengths = {"vid0": 20, "vid1": 40}
    for vid, n in lengths.items():
        write_frame_shard(frames_dir, vid,
                          (rng.random((n, cfg.p_size, cfg.p_size)) * 255)
                          .astype(np.uint8), cfg.framerate, source=vid)
        n_samp = int(n / cfg.framerate * cfg.samplerate) + cfg.samplerate
        write_wav(os.path.join(audio_dir, f"{vid}.wav"),
                  rng.standard_normal(n_samp).astype(np.float32) * 0.1,
                  cfg.samplerate)
    build_audio_memmap([os.path.join(audio_dir, f"{v}.wav") for v in lengths],
                       str(tmp_path / "mm"), cfg.samplerate)
    clip = cfg.num_frames + cfg.num_seq
    port = AVDataset(cfg.replace(max_clip_len=30), FrameShardStore(frames_dir),
                     AudioMemmap(str(tmp_path / "mm")), clip,
                     cache_dir=str(tmp_path / "cc"))
    jax_ds = JaxAVDataset(JaxRunConfig(**CFG).replace(max_clip_len=30),
                          JaxFrames(frames_dir),
                          JaxAudio(str(tmp_path / "mm")), clip,
                          cache_dir=str(tmp_path / "cc_jax"))
    return port, jax_ds


def _sequence(loader, n):
    out = [next(loader) for _ in range(n)]
    loader.close()
    return out


def _row_items(ds, batch, ids):
    """Each row of `batch` equals the item of one clip in `ids`."""
    items = [ds[int(i)] for i in ids]
    for row in range(batch["audio"].shape[0]):
        hit = [it for it in items
               if np.array_equal(batch["audio"][row], it["audio"])]
        assert hit, "a row matches no clip"
        np.testing.assert_array_equal(batch["frames"][row], hit[0]["frames"])


@pytest.mark.parametrize("case", ["all", "subset", "max_clip_len"])
def test_batches_equal_jax_loader(store, tmp_path, case):
    """One thread, one seed: the port's batch sequence is JAX's, bit for
    bit, over two epochs, and every row is a dataset item."""
    port, jax_ds = _long_store(tmp_path) if case == "max_clip_len" else store
    if not jax_native.native_available():
        pytest.fail("the JAX package's loader did not build: no reference")
    ids = (np.array([0, 2, 4], np.int64) if case == "subset"
           else np.arange(len(port)))
    assert len(port) == len(jax_ds) and len(ids) >= 2
    b = 2 if len(ids) >= 4 else 1
    n = 2 * (len(ids) // b)  # two epochs' worth
    kw = dict(seed=7, threads=1, clip_indices=ids)
    got = _sequence(native_loader.NativeAVLoader(port, b, **kw), n)
    want = _sequence(jax_native.NativeAVLoader(jax_ds, b, **kw), n)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"audio", "frames"}
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
        _row_items(port, g, ids)
    seen = {bytes(r) for g in got for r in g["audio"]}
    assert len(seen) == len(ids)  # each epoch's shuffle covers the clips


def test_make_stream_takes_the_cpp_loader_stacked(store, monkeypatch):
    """--native_loader with stack = 2: [2, B, ...] dispatch batches of the
    C++ loader's rows (a split's clips only); --pgram_cache datasets stay
    on the Python pipeline."""
    port, _ = store
    made = []
    real = native_loader.NativeAVLoader

    def spy(*args, **kw):
        made.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(native_loader, "NativeAVLoader", spy)
    cfg = port.cfg.replace(native_loader=True, batch_size=2)
    ids = np.array([1, 3, 5], np.int64)
    it = port_setup.make_stream(cfg, port, ids, seed=3, stack=2)
    for _ in range(3):
        batch = next(it)
        assert batch["audio"].shape == (2, 2, port.samples_per_frame
                                        * port.clip_len)
        assert batch["frames"].dtype == np.uint8
        assert batch["frames"].shape[:3] == (2, 2, port.clip_len)
        for k in range(2):
            _row_items(port, {n: v[k] for n, v in batch.items()}, ids)
    assert len(made) == 1 and list(made[0]["clip_indices"]) == list(ids)
    rows = AVDataset(port.cfg, port.frames, port.audio, port.clip_len,
                     cache_dir=os.path.dirname(port.frames.dir) + "/cc",
                     pgrams=port.frames)  # any store: the route is the point
    next(port_setup.make_stream(cfg, rows, None, seed=3))
    assert len(made) == 1


def test_port_builds_its_own_copy(store):
    """The library comes from data/dataloader.cc, built under
    build/maavss_tpu_torch/, not from native/."""
    from maavss_tpu_torch.ops._build import BUILD_ROOT

    path = native_loader.build()
    assert os.path.dirname(os.path.dirname(path)) == BUILD_ROOT
    assert os.path.basename(path) == native_loader.LIB_NAME
    assert native_loader.library()._name == path
