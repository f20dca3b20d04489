#!/usr/bin/env python
"""Precompute DINO attention frames for every ingested video with the
PyTorch port: the counterpart of save_attn_videos.py.

For each video of `<data_path>/frames/`, `--chunk` frames at a time go
through the frozen ViT (`ops/dino.VideoAttention`, one batched forward a
chunk): uint8 frames / 255 (a grayscale shard repeated to three
channels), ImageNet normalisation, then, with --autocontrast, the
per-channel min/max remap (after the normalisation, the reference's
order). The head-summed, max-normalized CLS->patch maps are written as
uint8 attention shards to `--out_path` (default `<data_path>/attn`), the
layout the frames regime reads.

Pass --weights dino_deitsmall8_pretrain.pth for pretrained attention
(loaded strictly, `module.`/`backbone.` stripped); without it a random
frozen ViT is used, and the tool says so. Runs on the card, with TF32
off, unless `--device cpu` is given.

Usage:
  python tools/save_attn_videos_torch.py --data_path data/processed
      --weights dino_deitsmall8_pretrain.pth
  python tools/save_attn_videos_torch.py --device cpu --data_path
      data/synthetic-p64 --chunk 8
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def save_attention(data_path: str, out_path=None, weights=None,
                   chunk: int = 64, patch_size: int = 8,
                   autocontrast: bool = False, device="cuda") -> str:
    """Write the attention shards of the module docstring; returns their
    directory."""
    import torch

    from maavss_tpu_torch.data.frame_shards import (
        FrameShardStore,
        write_frame_shard,
    )
    from maavss_tpu_torch.ops import image
    from maavss_tpu_torch.ops.dino import VideoAttention, load_torch_weights

    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    store = FrameShardStore(os.path.join(data_path, "frames"))
    out = out_path or os.path.join(data_path, "attn")
    state_dict = load_torch_weights(weights) if weights else None
    if state_dict is None:
        print("WARNING: no --weights given; using a random frozen ViT "
              "(pipeline smoke mode, not pretrained DINO attention)")
    va = VideoAttention(state_dict, patch_size=patch_size, device=device)
    for v in range(len(store)):
        vid = store.video_ids[v]
        n = store.num_frames(v)
        maps = []
        for s in range(0, n, chunk):
            fr = torch.from_numpy(store.read(v, np.arange(s, min(s + chunk, n))))
            fr = fr.to(device).to(torch.float32) / 255.0
            if fr.ndim == 3:  # grayscale shard -> 3-channel ViT input
                fr = fr[:, None].expand(-1, 3, -1, -1)
            else:
                fr = fr.permute(0, 3, 1, 2)
            fr = image.normalize_imagenet(fr)
            if autocontrast:
                fr = image.autocontrast(fr)
            maps.append(va(fr)[:, 0].cpu().numpy())
        attn = np.concatenate(maps, axis=0)
        write_frame_shard(out, vid, (np.clip(attn, 0, 1) * 255).astype(np.uint8),
                          store.fps(v), source=f"attn:{vid}")
        print(f"{vid}: {attn.shape[0]} attention frames")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", default="data/processed")
    p.add_argument("--out_path", default=None, help="default <data_path>/attn")
    p.add_argument("--weights", default=None,
                   help="path to dino_deitsmall8_pretrain.pth")
    p.add_argument("--chunk", type=int, default=64, help="frames per ViT batch")
    p.add_argument("--patch_size", type=int, default=8)
    p.add_argument("--autocontrast", action="store_true",
                   help="per-channel min/max contrast remap before the ViT, "
                        "after ImageNet normalisation (the reference's order)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("save_attn_videos_torch: CUDA is not available "
                         "(pass --device cpu to run on the CPU)")
    save_attention(args.data_path, args.out_path, args.weights, args.chunk,
                   args.patch_size, args.autocontrast, args.device)


if __name__ == "__main__":
    main()
