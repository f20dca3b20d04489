#!/usr/bin/env python
"""Optical-flow frames of one ingested video with the PyTorch port: the
counterpart of flow.py.

`--num_frames` frames of a video of `<data_path>/frames/` (`--video`, or a
random one; a random start) go through dense Lucas-Kanade
(`ops/flow.flow_magnitude`, on the card with TF32 off unless `--device
cpu`), and each flow-magnitude frame is written as a PNG to `--out`. The
computation is `flow_frames`; only the PNG writing needs matplotlib, and
without it the tool stops before it computes anything.

Usage:
  python tools/flow_torch.py --data_path data/processed --video 0 --out flow_frames
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def flow_frames(data_path: str, video=None, num_frames: int = 16,
                rng=None, device="cuda"):
    """(video index, flow-magnitude frames [n, H, W] float32 numpy) of a
    random window of `video` (random when None), drawn from `rng` (a
    fresh `np.random.default_rng()` when None). RGB shards are converted
    to grayscale first."""
    import torch

    from maavss_tpu_torch.data.frame_shards import FrameShardStore
    from maavss_tpu_torch.ops.flow import flow_magnitude
    from maavss_tpu_torch.ops.image import grayscale

    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    store = FrameShardStore(os.path.join(data_path, "frames"))
    rng = rng or np.random.default_rng()
    v = video if video is not None else int(rng.integers(0, len(store)))
    n = min(num_frames, store.num_frames(v))
    start = int(rng.integers(0, max(1, store.num_frames(v) - n + 1)))
    fr = torch.from_numpy(store.read(v, np.arange(start, start + n)))
    fr = fr.to(device).to(torch.float32) / 255.0
    if fr.ndim == 4:  # [n, H, W, 3]
        fr = grayscale(fr.permute(0, 3, 1, 2))[:, 0]
    return v, flow_magnitude(fr).cpu().numpy()


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", default="data/processed")
    p.add_argument("--video", type=int, default=None, help="video index (random)")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--out", default="flow_frames")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("flow_torch: CUDA is not available (pass --device "
                         "cpu to run on the CPU)")
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("flow_torch: matplotlib is not installed; it writes "
                         "the PNGs (flow_frames computes the frames without "
                         "it)")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    v, mag = flow_frames(args.data_path, args.video, args.num_frames,
                         device=args.device)
    os.makedirs(args.out, exist_ok=True)
    for t in range(mag.shape[0]):
        plt.imsave(os.path.join(args.out, f"flow_{t:03d}.png"), mag[t],
                   cmap="inferno")
    print(f"wrote {mag.shape[0]} flow-magnitude frames for video {v} to "
          f"{args.out}/")


if __name__ == "__main__":
    main()
