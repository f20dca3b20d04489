#!/usr/bin/env python
"""Ingest-time phasegram precompute with the PyTorch port: frame shards ->
cumsum-row shards (the port's counterpart of save_phasegrams.py:29-50).

For every video of `<data_root>/frames/`, the per-frame half of the
phasegram (`ops/phasegram.phasegram_cumsum`: fft2 -> fftshift -> angle ->
flatten -> cumsum-normalize, with a bilinear resize when the frames are not
p_size square) runs on the card, 256 frames a batch, and the rows are
written as float16 `[T, p_size^2]` into `<data_root>/pgrams-p<p_size>/`,
the layout `--pgram_cache` reads (`train/setup.load_pgram_store`), so the
fusion regime trains from disk on a machine without JAX.

Usage:
  python tools/save_phasegrams_torch.py --data_path data/processed --p_size 64
  python tools/save_phasegrams_torch.py --data_path synthetic   # fixture store
  python tools/save_phasegrams_torch.py --device cpu --data_path synthetic
      --p_size 16       (the plain PyTorch ops on the CPU)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_pgram_store(data_root: str, p_size: int, device="cuda",
                      batch_frames: int = 256) -> str:
    """Write `<data_root>/pgrams-p<p_size>/` from `<data_root>/frames/`;
    returns the directory."""
    import torch

    from maavss_tpu_torch.data.frame_shards import (
        FrameShardStore,
        write_pgram_shard,
    )
    from maavss_tpu_torch.ops.phasegram import phasegram_cumsum

    frames = FrameShardStore(os.path.join(data_root, "frames"))
    out_dir = os.path.join(data_root, f"pgrams-p{p_size}")
    for v in range(len(frames)):
        vid = frames.video_ids[v]
        t_total = frames.num_frames(v)
        rows = np.empty((t_total, p_size * p_size), np.float16)
        for lo in range(0, t_total, batch_frames):
            idx = np.arange(lo, min(lo + batch_frames, t_total))
            fr = torch.from_numpy(frames.read(v, idx)).to(device)
            fr = fr.to(torch.float32) / 255.0  # [t, H, W]
            resize = None if fr.shape[-1] == p_size else (p_size, p_size)
            r = phasegram_cumsum(fr[None], resize=resize)[0]
            rows[idx] = r.to(torch.float16).cpu().numpy()
        write_pgram_shard(out_dir, vid, rows, fps=frames.fps(v), p_size=p_size,
                          source=os.path.join(data_root, "frames", f"{vid}.npy"))
        print(f"pgram shard: {vid} ({t_total} frames)")
    return out_dir


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    own, rest = pre.parse_known_args(argv)

    import torch

    from maavss_tpu_torch.config import model_args
    from maavss_tpu_torch.train.setup import load_stores, resolve_data_root

    cfg = model_args(rest)
    device = torch.device(own.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("save_phasegrams_torch: CUDA is not available (pass "
                         "--device cpu to run the plain PyTorch ops)")
    load_stores(cfg)  # builds the synthetic fixture store if requested
    out = build_pgram_store(resolve_data_root(cfg), cfg.p_size, device)
    print(f"pgram store ready: {out}")


if __name__ == "__main__":
    main()
