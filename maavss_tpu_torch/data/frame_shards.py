"""Fixed-shape decoded-frame shards.

Replaces the reference's two frame stores — per-clip libav decode at
__getitem__ time (video_utils_custom.py:284-387) and the attention-frame JPEG
cache (av_dataset.py:251-278, save_attn_videos.py) — with one format: per
video, a `.npy` uint8 array `[T, H, W]` (grayscale/attention) or `[T, H, W, 3]`
(RGB), written once by the ingest tool and memory-mapped at train time. Reads
are array slices; no decoder in the hot path.

A `meta.json` carries per-video fps/frame counts, replacing the cv2 probing
pass (utilities.py:105-126, get_video_stats.py).

A copy of maavss_tpu/data/frame_shards.py (numpy only), pinned to it by
tests/test_torch_data.py: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

META_NAME = "meta.json"


def write_frame_shard(out_dir: str, video_id: str, frames: np.ndarray,
                      fps: float, source: str = "") -> str:
    """frames uint8 [T,H,W] or [T,H,W,3] -> <out_dir>/<video_id>.npy + meta."""
    os.makedirs(out_dir, exist_ok=True)
    if frames.dtype != np.uint8:
        raise ValueError(f"frames must be uint8, got {frames.dtype}")
    path = os.path.join(out_dir, f"{video_id}.npy")
    np.save(path, frames)
    meta_path = os.path.join(out_dir, META_NAME)
    meta: Dict[str, dict] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    meta[video_id] = {
        "frames": int(frames.shape[0]), "fps": float(fps),
        "shape": list(frames.shape[1:]), "source": source,
    }
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return path


def write_pgram_shard(out_dir: str, video_id: str, rows: np.ndarray,
                      fps: float, p_size: int, source: str = "") -> str:
    """Precomputed phasegram cumsum rows float16 `[T, p_size*p_size]` ->
    <out_dir>/<video_id>.npy + meta (ingest-time phasegram precompute: the
    rows are a deterministic function of each frame, so the fusion train step
    can skip its per-step fft2/angle/cumsum chain — save_phasegrams.py,
    mirroring the attention-frame cache pattern of save_attn_videos.py)."""
    os.makedirs(out_dir, exist_ok=True)
    if rows.dtype != np.float16:
        raise ValueError(f"pgram rows must be float16, got {rows.dtype}")
    if rows.ndim != 2 or rows.shape[1] != p_size * p_size:
        raise ValueError(f"rows must be [T, {p_size * p_size}], got {rows.shape}")
    path = os.path.join(out_dir, f"{video_id}.npy")
    np.save(path, rows)
    meta_path = os.path.join(out_dir, META_NAME)
    meta: Dict[str, dict] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    meta[video_id] = {
        "frames": int(rows.shape[0]), "fps": float(fps),
        "shape": list(rows.shape[1:]), "p_size": int(p_size), "source": source,
    }
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return path


class FrameShardStore:
    """Memory-mapped reader over a shard directory (uint8 frames or float16
    phasegram rows — reads are dtype-preserving array slices)."""

    def __init__(self, shard_dir: str, video_ids: Optional[Sequence[str]] = None):
        self.dir = shard_dir
        with open(os.path.join(shard_dir, META_NAME)) as f:
            self.meta: Dict[str, dict] = json.load(f)
        self.video_ids: List[str] = sorted(video_ids or self.meta.keys())
        missing = [v for v in self.video_ids if v not in self.meta]
        if missing:
            raise KeyError(f"videos missing from shard meta: {missing[:5]}")
        self._arrays: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.video_ids)

    def fps(self, video_idx: int) -> float:
        return float(self.meta[self.video_ids[video_idx]]["fps"])

    def num_frames(self, video_idx: int) -> int:
        return int(self.meta[self.video_ids[video_idx]]["frames"])

    def _array(self, video_id: str) -> np.ndarray:
        if video_id not in self._arrays:
            self._arrays[video_id] = np.load(
                os.path.join(self.dir, f"{video_id}.npy"), mmap_mode="r")
        return self._arrays[video_id]

    def read(self, video_idx: int, frame_indices: np.ndarray) -> np.ndarray:
        """uint8 [len(frame_indices), H, W(, 3)]."""
        arr = self._array(self.video_ids[video_idx])
        return np.asarray(arr[np.asarray(frame_indices)])
