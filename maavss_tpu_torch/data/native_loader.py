"""--native_loader: the C++ batch assembler of `data/dataloader.cc` behind a
ctypes binding (counterpart of maavss_tpu/data/native_loader.py, with its
interface).

`NativeAVLoader(dataset, batch_size, seed, queue, threads, clip_indices)`
is an infinite, epoch-shuffled stream of the same `{'audio', 'frames'}`
batches as `dataset.batches(AVDataset(...))` (float32 audio [B, S], uint8
frames [B, T, H, W]), assembled in C++ worker threads behind a bounded
prefetch ring. The source is the port's copy of the JAX package's
native/dataloader.cc, so both give the same batches from the same store
and seed (with one worker thread the same sequence; with more, each
batch's rows come in the order the threads take their clips).

The library is built with the host's C++ compiler (no CUDA) the first time
a loader is made, into `build/maavss_tpu_torch/<hash>/` beside the
kernels' library, keyed by a hash of the source and flags. Where it cannot
be built or loaded the loader raises RuntimeError: the JAX package prints a
message and falls back to the Python pipeline
(maavss_tpu/train/setup.py:297-303); a run that asked for the C++ loader
here never trains on another one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterator, Optional

import numpy as np

from maavss_tpu_torch.data.audio_memmap import AudioMemmap
from maavss_tpu_torch.data.dataset import AVDataset

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "dataloader.cc")
LIB_NAME = "libmaavss_dataloader.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("--native_loader: no C++ compiler (c++, g++ or $CXX) "
                       "to build data/dataloader.cc")


def build() -> str:
    """Compile `SOURCE` into a shared library unless this exact build
    exists; returns its path. Raises RuntimeError when it cannot."""
    from maavss_tpu_torch.ops._build import BUILD_ROOT

    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, "loader-" + h.hexdigest()[:16])
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, check=False)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"--native_loader: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"--native_loader: build failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded library, with argtypes/restype declared."""
    lib = ctypes.CDLL(build())
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_create.argtypes = [
        ctypes.c_char_p,                    # audio_path
        ctypes.POINTER(ctypes.c_char_p),    # shard_paths
        i32,                                # n_shards
        p64, p64,                           # clip_audio_start, clip_audio_end
        ctypes.POINTER(ctypes.c_int32),     # clip_video
        p64,                                # clip_frames
        i64, i32, i64,                      # n_clips, t_total, samples
        i32, i32, i32,                      # batch, queue, threads
        ctypes.c_uint64,                    # seed
    ]
    lib.dl_next.restype = i32
    lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_uint8)]
    lib.dl_frame_dims.argtypes = [ctypes.c_void_p, p64, p64]
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeAVLoader:
    """Infinite epoch-shuffled batch stream over an AVDataset's stores,
    assembled by the C++ library; `clip_indices` (the dataset's view ids,
    a train or val split) restricts it to those clips."""

    def __init__(self, dataset: AVDataset, batch_size: int, seed: int = 0,
                 queue: int = 2, threads: int = 2,
                 clip_indices: Optional[np.ndarray] = None):
        self._lib = library()
        audio: AudioMemmap = dataset.audio
        store = dataset.frames
        ids = (np.arange(len(dataset)) if clip_indices is None
               else np.asarray(clip_indices, np.int64))
        n = len(ids)
        t_total = dataset.clip_len
        self.samples = dataset.samples_per_frame * t_total
        self.batch = batch_size
        a_start = np.empty(n, np.int64)
        a_end = np.empty(n, np.int64)
        vid = np.empty(n, np.int32)
        fidx = np.empty((n, t_total), np.int64)
        sr = dataset.cfg.samplerate
        for row, i in enumerate(ids):
            # view ids (--max_clip_len filters the index) to raw clip ids,
            # and AVDataset.__getitem__'s audio pairing and offset
            v, fi = dataset.index.clip_frame_indices(dataset._clip_id(int(i)))
            vid[row] = v
            fidx[row] = fi
            fs, fe = audio.indexes[dataset._audio_of_video[v]]
            src_fps = store.fps(v) or dataset.cfg.framerate
            a_start[row] = fs + int(round(fi[0] * sr / src_fps))
            a_end[row] = fe
        paths = [os.path.join(store.dir, f"{v}.npy").encode()
                 for v in store.video_ids]
        self._h = self._lib.dl_create(
            os.path.abspath(audio.map.filename).encode(),
            (ctypes.c_char_p * len(paths))(*paths), len(paths),
            _ptr(a_start, ctypes.c_int64), _ptr(a_end, ctypes.c_int64),
            _ptr(vid, ctypes.c_int32),
            _ptr(np.ascontiguousarray(fidx), ctypes.c_int64),
            n, t_total, self.samples, batch_size, queue, threads, seed)
        if not self._h:
            raise RuntimeError("--native_loader: dl_create failed on the "
                               f"stores under {store.dir}")
        h, w = ctypes.c_int64(), ctypes.c_int64()
        self._lib.dl_frame_dims(self._h, ctypes.byref(h), ctypes.byref(w))
        self.frame_hw = (h.value, w.value)
        self.t_total = t_total

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        a = np.empty((self.batch, self.samples), np.float32)
        f = np.empty((self.batch, self.t_total) + self.frame_hw, np.uint8)
        if self._lib.dl_next(self._h, _ptr(a, ctypes.c_float),
                             _ptr(f, ctypes.c_uint8)) != 0:
            raise StopIteration
        return {"audio": a, "frames": f}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dl_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
