"""Flat float32 audio memmap cache + index.

Contract parity with save_memmap.py / utilities.py:56-66: every clip's mono
float32 audio concatenated into one `audio_memmap.memmap`, with an index of
`[paths, [start, end]]` sample ranges per file. Training reads are zero-copy
`map[start:end]` slices (av_dataset.py:289-294).

Differences: the index is JSON (inspectable, no pickle-module coupling) but a
reference-format pickle is also written for drop-in compatibility; building
uses the dependency-free WAV reader instead of torchaudio.

A copy of maavss_tpu/data/audio_memmap.py (numpy only), pinned to it by
tests/test_torch_data.py: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from maavss_tpu_torch.data.wavio import read_wav

MEMMAP_NAME = "audio_memmap.memmap"
INDEX_NAME = "audio_index_map.json"
INDEX_NAME_PKL = "audio_index_map.obj"  # reference pickle name (save_memmap.py:45)


def build_audio_memmap(
    wav_paths: Sequence[str], out_dir: str, samplerate: Optional[int] = None
) -> Tuple[str, str]:
    """Concatenate mono float32 audio of every file; returns (memmap, index).

    Mono mix divides by channel count before summing (av_dataset.py:204-207
    semantics). Files whose sample rate mismatches `samplerate` are rejected
    (resampling belongs to the ingest tool, process_downloads.py parity).
    """
    os.makedirs(out_dir, exist_ok=True)
    audios: List[np.ndarray] = []
    paths: List[str] = []
    indexes: List[List[int]] = []
    total = 0
    for p in wav_paths:
        try:
            a, sr = read_wav(p)
        except (ValueError, OSError) as e:
            print(f"skipping {p}: {e}")
            continue
        if samplerate is not None and sr != samplerate:
            print(f"skipping {p}: sr {sr} != {samplerate}")
            continue
        mono = a.sum(axis=0) / a.shape[0]
        audios.append(mono.astype(np.float32))
        paths.append(os.path.abspath(p))
        indexes.append([total, total + len(mono)])
        total += len(mono)

    mm_path = os.path.join(out_dir, MEMMAP_NAME)
    mm = np.memmap(mm_path, dtype=np.float32, mode="w+", shape=(max(total, 1),))
    for a, (s, e) in zip(audios, indexes):
        mm[s:e] = a
    mm.flush()

    idx_path = os.path.join(out_dir, INDEX_NAME)
    with open(idx_path, "w") as f:
        json.dump({"paths": paths, "indexes": indexes, "total": total}, f)
    with open(os.path.join(out_dir, INDEX_NAME_PKL), "wb") as f:
        pickle.dump([paths, indexes], f)  # reference [paths, indexes] layout
    return mm_path, idx_path


class AudioMemmap:
    """Read side: zero-copy sample-range slices (utilities.py:56-66)."""

    def __init__(self, dir_or_memmap: str, index_path: Optional[str] = None):
        if os.path.isdir(dir_or_memmap):
            mm_path = os.path.join(dir_or_memmap, MEMMAP_NAME)
            index_path = index_path or os.path.join(dir_or_memmap, INDEX_NAME)
        else:
            mm_path = dir_or_memmap
        if index_path.endswith(".obj"):
            with open(index_path, "rb") as f:
                paths, indexes = pickle.load(f)
            meta = {"paths": paths, "indexes": indexes}
        else:
            with open(index_path) as f:
                meta = json.load(f)
        self.paths: List[str] = meta["paths"]
        self.indexes = np.asarray(meta["indexes"], np.int64)
        self.map = np.memmap(mm_path, dtype=np.float32, mode="r")
        self._by_path = {p: i for i, p in enumerate(self.paths)}

    def __len__(self) -> int:
        return len(self.paths)

    def file_num_samples(self, file_idx: int) -> int:
        s, e = self.indexes[file_idx]
        return int(e - s)

    def read(self, file_idx: int, start: int, num: int) -> np.ndarray:
        """num samples at `start` within file `file_idx`, zero-padded past EOF
        (fixed shapes for the device pipeline)."""
        s, e = self.indexes[file_idx]
        lo = s + start
        hi = min(lo + num, e)
        out = np.zeros((num,), np.float32)
        if hi > lo:
            out[: hi - lo] = self.map[lo:hi]
        return out

    def read_by_path(self, path: str, start: int, num: int) -> np.ndarray:
        return self.read(self._by_path[os.path.abspath(path)], start, num)
