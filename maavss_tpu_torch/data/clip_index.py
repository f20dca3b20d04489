"""Clip index: flat addressing of fixed-length frame windows across videos.

Numpy-native port of the math inside the reference's vendored `VideoClips`
(video_utils_custom.py): sliding windows via strided unfold (:31-47,223-246),
fps-resampling index (:272-282), flat-idx -> (video, clip) via bisect
(:260-270), and the config-keyed on-disk cache (utilities.py:129-163).

Decode is NOT here by design: the reference probes and decodes video at
__getitem__ time through libav (SURVEY.md §3.2); in this framework the ingest
tool (tools/ingest.py) decodes once into fixed-shape frame shards, and the
index addresses *frames in shards*, so the steady-state input pipeline is
pure array slicing.

A copy of maavss_tpu/data/clip_index.py (numpy only), pinned to it by
tests/test_torch_data.py: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
from bisect import bisect_right
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _log_wandb_artifact(path: str, key: str) -> None:
    """Upload a clip-index cache file as a wandb Artifact when a run is
    active (parity: av_dataset.py:123-131). No-op (and never fatal) when
    wandb is absent, disabled, or offline — wandb stays opt-in here."""
    try:
        import sys

        wandb = sys.modules.get("wandb")
        if wandb is None or wandb.run is None:
            return
        art = wandb.Artifact(f"clip_index_{key}", type="dataset-index")
        art.add_file(path)
        wandb.run.log_artifact(art)
    except Exception:
        pass  # artifact upload is best-effort telemetry, never breaks builds


def resample_video_idx(num_frames: int, original_fps: float, new_fps: float) -> np.ndarray:
    """Frame indices mapping an `original_fps` stream onto `new_fps` ticks
    (video_utils_custom.py:272-282 semantics)."""
    step = float(original_fps) / new_fps
    if step.is_integer():
        return np.arange(num_frames, dtype=np.int64) * int(step)
    idxs = np.arange(num_frames, dtype=np.float64) * step
    return idxs.astype(np.int64)


def sliding_windows(n: int, size: int, step: int) -> np.ndarray:
    """[num_clips, size] start-aligned windows over range(n) (unfold math,
    video_utils_custom.py:31-47). Empty if n < size."""
    if n < size:
        return np.zeros((0, size), dtype=np.int64)
    starts = np.arange(0, n - size + 1, step, dtype=np.int64)
    return starts[:, None] + np.arange(size, dtype=np.int64)[None, :]


@dataclasses.dataclass
class ClipIndex:
    """Addresses every `clip_len`-frame window (stride `frame_hop`) in a set
    of videos, optionally fps-resampled to `framerate`.

    video_paths[i] has total_frames[i] decoded frames at video_fps[i].
    """

    video_paths: List[str]
    total_frames: np.ndarray  # [V] int64, decoded frame count per video
    video_fps: np.ndarray  # [V] float64
    clip_len: int
    frame_hop: int
    framerate: Optional[int] = None  # resample target fps (None = native)

    def __post_init__(self):
        self.total_frames = np.asarray(self.total_frames, np.int64)
        self.video_fps = np.asarray(self.video_fps, np.float64)
        self._frame_maps: List[np.ndarray] = []
        self._clips: List[np.ndarray] = []
        for v in range(len(self.video_paths)):
            n = int(self.total_frames[v])
            fps = float(self.video_fps[v]) or (self.framerate or 30)
            if self.framerate is not None and self.framerate != fps:
                n_res = int(np.floor(n * self.framerate / fps))
                fmap = resample_video_idx(n_res, fps, self.framerate)
            else:
                fmap = np.arange(n, dtype=np.int64)
            self._frame_maps.append(fmap)
            self._clips.append(sliding_windows(len(fmap), self.clip_len, self.frame_hop))
        counts = np.array([len(c) for c in self._clips], np.int64)
        self.cumulative = np.cumsum(counts)

    def num_clips(self) -> int:
        return int(self.cumulative[-1]) if len(self.cumulative) else 0

    def get_clip_location(self, idx: int) -> Tuple[int, int]:
        """flat idx -> (video_idx, clip_idx) (video_utils_custom.py:260-270)."""
        if idx >= self.num_clips():
            raise IndexError(f"clip {idx} out of range ({self.num_clips()})")
        video_idx = bisect_right(self.cumulative.tolist(), idx)
        clip_idx = idx if video_idx == 0 else idx - int(self.cumulative[video_idx - 1])
        return video_idx, clip_idx

    def clip_frame_indices(self, idx: int) -> Tuple[int, np.ndarray]:
        """flat idx -> (video_idx, frame indices into the video's shard)."""
        v, c = self.get_clip_location(idx)
        window = self._clips[v][c]
        return v, self._frame_maps[v][window]

    # -- cache (utilities.py:129-163: keyed by [clip_len, frame_hop, framerate])
    # (artifact logging below: av_dataset.py:123-131 uploads the clip index
    # as a wandb Artifact; mirrored here whenever a wandb run is active)
    def cache_key(self) -> str:
        meta = {
            "clip_len": self.clip_len, "frame_hop": self.frame_hop,
            "framerate": self.framerate, "videos": list(self.video_paths),
            "frames": self.total_frames.tolist(),
        }
        return hashlib.sha1(json.dumps(meta, sort_keys=True).encode()).hexdigest()[:16]

    def save(self, cache_dir: str) -> str:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"clip_index_{self.cache_key()}.pkl")
        with open(path, "wb") as f:
            pickle.dump(self, f)
        _log_wandb_artifact(path, self.cache_key())
        return path

    @staticmethod
    def load_or_build(cache_dir: str, video_paths: Sequence[str],
                      total_frames, video_fps, clip_len: int, frame_hop: int,
                      framerate: Optional[int] = None) -> "ClipIndex":
        idx = ClipIndex(list(video_paths), total_frames, video_fps,
                        clip_len, frame_hop, framerate)
        path = os.path.join(cache_dir, f"clip_index_{idx.cache_key()}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        idx.save(cache_dir)
        return idx
