"""Datasets + host batch pipeline.

Capability parity with av_dataset.py's three dataset classes, redesigned so
that __getitem__ returns *raw fixed-shape arrays* (audio samples + uint8
frames) and every transform that the reference ran per-item on host
(STFT, noise, normalization, phasegram, resize) runs batched inside the
jit-compiled train step (maavss_tpu/train/steps.py):

- `AVDataset`      ≅ AV_Dataset       (av_dataset.py:15-377)
- `STFTDataset`    ≅ STFT_Dataset     (av_dataset.py:381-491): random audio crops
- `VideoDataset`   ≅ Video_Dataset    (av_dataset.py:494-564): frames only

The pipeline is `batches()` (shuffled, drop-remainder, infinite epochs,
reference DataLoader(shuffle=True, drop_last=True) semantics, train.py:57-64)
wrapped in `prefetch()` — a background-thread queue so host slicing overlaps
device compute (the reference runs num_workers=0, i.e. no overlap at all).

A copy of maavss_tpu/data/dataset.py (numpy only), pinned to it by
tests/test_torch_data.py: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.data.audio_memmap import AudioMemmap
from maavss_tpu_torch.data.clip_index import ClipIndex
from maavss_tpu_torch.data.frame_shards import FrameShardStore


class AVDataset:
    """Aligned (audio, frames) clips.

    Clip geometry: `clip_len` video frames (the train scripts pass
    num_frames + num_seq, train.py:33-43) -> audio span of
    `hop * hops_per_frame * clip_len` samples starting at the clip's first
    frame (av_dataset.py:285-300 uses the clip pts the same way).
    `mode`: 'av' | 'audio' | 'video' gates which arrays are produced
    (av_dataset.py:153-155 gen_stft/gen_video toggles).
    """

    def __init__(self, cfg: RunConfig, frames: FrameShardStore,
                 audio: AudioMemmap, clip_len: int,
                 cache_dir: str = "clipcache", mode: str = "av",
                 pgrams: "Optional[FrameShardStore]" = None):
        self.cfg = cfg
        self.frames = frames
        self.audio = audio
        self.mode = mode
        self.clip_len = clip_len
        # precomputed phasegram rows (save_phasegrams.py): when present the
        # visual stream ships float16 [T, p^2] rows under 'pgram' INSTEAD of
        # raw frames, and the fusion step skips its fft2/angle/cumsum chain
        self.pgrams = pgrams
        self.samples_per_frame = cfg.hop * cfg.hops_per_frame
        self.index = ClipIndex.load_or_build(
            cache_dir,
            video_paths=frames.video_ids,
            total_frames=[frames.num_frames(v) for v in range(len(frames))],
            video_fps=[frames.fps(v) for v in range(len(frames))],
            clip_len=clip_len, frame_hop=cfg.frame_hop, framerate=cfg.framerate,
        )
        # pair audio files to videos by name stem (ingest writes vidX.wav for
        # vidX.npy); fall back to positional order when stems don't line up
        stems = {os.path.splitext(os.path.basename(p))[0]: i
                 for i, p in enumerate(audio.paths)}
        if all(v in stems for v in frames.video_ids):
            self._audio_of_video = [stems[v] for v in frames.video_ids]
        else:
            if len(audio) != len(frames):
                raise ValueError(
                    f"audio memmap has {len(audio)} files for {len(frames)} "
                    f"videos and names don't match")
            self._audio_of_video = list(range(len(frames)))
        self._apply_max_clip_len()

    def _apply_max_clip_len(self) -> None:
        """--max_clip_len (run_config.py:39): the reference drops videos with
        more than N frames at dataset build (utilities.py:117-119, a loading
        speed filter). The decoded shards already exist here, so the filter
        drops those videos' clips from the index view instead."""
        self._clip_map = None
        if self.cfg.max_clip_len is None:
            return
        nf_of = [self.frames.num_frames(v) for v in range(len(self.frames))]
        self._clip_map = np.asarray(
            [i for i in range(self.index.num_clips())
             if nf_of[self.index.clip_frame_indices(i)[0]]
             <= self.cfg.max_clip_len],
            np.int64)

    def _clip_id(self, idx: int) -> int:
        return int(self._clip_map[idx]) if self._clip_map is not None else idx

    def __len__(self) -> int:
        return (len(self._clip_map) if self._clip_map is not None
                else self.index.num_clips())

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        v, frame_idx = self.index.clip_frame_indices(self._clip_id(idx))
        out: Dict[str, np.ndarray] = {}
        if self.mode in ("av", "video"):
            if self.pgrams is not None:
                out["pgram"] = self.pgrams.read(v, frame_idx)
            else:
                # frames ship as uint8; the jitted steps normalize on device
                # (4x less host->device transfer than float32)
                out["frames"] = self.frames.read(v, frame_idx)
        if self.mode in ("av", "audio"):
            # frame_idx addresses frames in the shard's NATIVE fps (the clip
            # index resamples by selecting source frames), so the audio offset
            # converts through the source fps, not the target framerate
            src_fps = self.frames.fps(v) or self.cfg.framerate
            start = int(round(frame_idx[0] * self.cfg.samplerate / src_fps))
            num = self.samples_per_frame * self.clip_len
            out["audio"] = self.audio.read(self._audio_of_video[v], start, num)
        return out


class STFTDataset:
    """Random fixed-length audio crops -> denoising-AE pairs are built on
    device; host side returns only the raw crop (av_dataset.py:381-491)."""

    def __init__(self, cfg: RunConfig, audio: AudioMemmap,
                 num_samples: Optional[int] = None, seed: int = 0):
        self.cfg = cfg
        self.audio = audio
        self.num_samples = num_samples or cfg.audio_sample_len
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.audio)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        n = self.audio.file_num_samples(idx)
        hi = max(1, n - self.num_samples)
        start = int(self._rng.integers(0, hi))
        return {"audio": self.audio.read(idx, start, self.num_samples)}


class VideoDataset(AVDataset):
    """Frames-only view (av_dataset.py:494-564)."""

    def __init__(self, cfg: RunConfig, frames: FrameShardStore, clip_len: int,
                 cache_dir: str = "clipcache"):
        # bypass the audio pairing check with a frames-only index
        self.cfg = cfg
        self.frames = frames
        self.mode = "video"
        self.clip_len = clip_len
        self.samples_per_frame = cfg.hop * cfg.hops_per_frame
        self.index = ClipIndex.load_or_build(
            cache_dir,
            video_paths=frames.video_ids,
            total_frames=[frames.num_frames(v) for v in range(len(frames))],
            video_fps=[frames.fps(v) for v in range(len(frames))],
            clip_len=clip_len, frame_hop=cfg.frame_hop, framerate=cfg.framerate,
        )
        self._apply_max_clip_len()

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        v, frame_idx = self.index.clip_frame_indices(self._clip_id(idx))
        return {"frames": self.frames.read(v, frame_idx)}


class Subset:
    """Index-selected view of a dataset (train/val split carrier)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices, np.int64)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[int(self.indices[i])]


def batches(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
            ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite epoch-shuffled drop-remainder batch stream.

    Datasets smaller than one batch wrap (each epoch is the dataset repeated
    until a batch fills) so tiny validation splits still stream fixed-shape
    batches instead of aborting."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    if n == 0:
        raise ValueError("dataset is empty")
    reps = -(-batch_size // n)  # ceil
    if reps > 1:
        print(f"dataset has {n} items < batch_size {batch_size}; "
              f"sampling with wraparound")
    while True:
        if shuffle:
            order = np.concatenate([rng.permutation(n) for _ in range(reps)])
        else:
            order = np.tile(np.arange(n), reps)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [dataset[int(j)] for j in order[i:i + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetch queue: host batch assembly overlaps device
    compute (the reference's DataLoaders run num_workers=0, train.py:57-64)."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item


def split_train_val(dataset_len: int, split: float, seed: int = 0):
    """Index split (reference splits by clip count, train.py:46-52)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(dataset_len)
    n_train = int(dataset_len * split)
    return order[:n_train], order[n_train:]
