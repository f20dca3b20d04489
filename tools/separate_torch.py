#!/usr/bin/env python
"""Separate an audio file of any length with a trained fusion model and
the PyTorch port (the port's counterpart of `separate.py`).

Reads the wav and mixes it to mono (its sample rate must be
`--samplerate`), tiles it into clips of num_frames + num_seq frames'
samples (the last one zero-padded), runs the separator (train/infer.py)
over batches of `-b` tiles, the last batch padded with silent tiles,
stitches the separated tiles back together, cuts them to the input's
length and writes the result. `--frames DIR` reads the visual stream from
an ingested frame-shard store (tile k takes video 0's frames k * T ..
(k + 1) * T, clamped to its last frame, bilinearly resized to `--p_size`
where their size differs); without it the frames are zeros (audio-only
separation). The separator's additive noise is 0 unless `--noise_scalar`
is given. `--reference clean.wav` adds the SI-SDR of the output against it.
Prints one JSON line: out, n_samples, tiles, tile_samples, sr (and
si_sdr).

`-c` / `--checkpoint` load the weights as in tools/evaluate_torch.py.
Runs on the card unless `--device cpu` is given.

Usage:
  python tools/separate_torch.py --audio mix.wav --out sep.wav -c
  python tools/separate_torch.py --audio mix.wav --frames data/proc/frames
      --out sep.wav --checkpoint checkpoints/run.ckpt.pkl
  python tools/separate_torch.py --audio mix.wav --out sep.wav
      --reference clean.wav
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tile_frames(store_dir: str, n_tiles: int, t_total: int, fsize: int):
    """[n_tiles, t_total, fsize, fsize] float32 frames of video 0 of the
    frame-shard store at `store_dir`, aligned to the audio tiles."""
    import numpy as np
    import torch

    from maavss_tpu_torch.data.frame_shards import FrameShardStore
    from maavss_tpu_torch.ops.image import resize_bilinear

    store = FrameShardStore(store_dir)
    total = store.num_frames(0)
    frames = np.zeros((n_tiles, t_total, fsize, fsize), np.float32)
    for k in range(n_tiles):
        lo = k * t_total
        idx = np.clip(np.arange(lo, lo + t_total), 0, max(0, total - 1))
        fr = store.read(0, idx).astype(np.float32) / 255.0
        if fr.shape[-1] != fsize:
            fr = resize_bilinear(torch.from_numpy(fr), (fsize, fsize)).numpy()
        frames[k] = fr
    return frames


def separate_file(cfg, audio_path: str, out_path: str,
                  frames_dir=None, reference=None, device="cuda",
                  noise_given: bool = False) -> dict:
    """The run of the module docstring; returns the JSON line's dict."""
    import numpy as np
    import torch

    from maavss_tpu_torch.data.wavio import read_wav, write_wav
    from maavss_tpu_torch.ops.audio import mono_mix
    from maavss_tpu_torch.ops.metrics import si_sdr
    from maavss_tpu_torch.train.infer import make_separator
    from maavss_tpu_torch.train.setup import build_fusion
    from tools.evaluate_torch import cuda_device, load_weights

    device = cuda_device(device, "separate_torch")
    audio, sr = read_wav(audio_path)
    audio = mono_mix(torch.from_numpy(audio)).numpy()
    if sr != cfg.samplerate:
        raise SystemExit(f"{audio_path}: sample rate {sr} != --samplerate "
                         f"{cfg.samplerate}; resample during ingest "
                         f"(tools/ingest.py) or pass --samplerate {sr}")

    t_total = cfg.num_frames + cfg.num_seq
    s_total = cfg.hop * cfg.hops_per_frame * t_total
    n = audio.shape[-1]
    n_tiles = max(1, -(-n // s_total))
    padded = np.zeros(n_tiles * s_total, np.float32)
    padded[:n] = audio[:n_tiles * s_total]
    tiles = padded.reshape(n_tiles, s_total)
    fsize = cfg.p_size
    if frames_dir:
        frames = _tile_frames(frames_dir, n_tiles, t_total, fsize)
    else:
        frames = np.zeros((n_tiles, t_total, fsize, fsize), np.float32)

    # the separator adds the training-time noise to its input; a user's
    # mixture gets none unless asked for
    if not noise_given:
        cfg = cfg.replace(noise_scalar=0.0)
    b = cfg.batch_size
    model = build_fusion(cfg, b, device)
    load_weights(cfg, model)
    separate = make_separator(model, cfg)

    out = np.zeros_like(padded)
    pad_tiles = (-n_tiles) % b
    if pad_tiles:  # the last batch padded to the model's batch size
        tiles = np.concatenate([tiles, np.zeros((pad_tiles, s_total),
                                                np.float32)])
        frames = np.concatenate([frames, np.zeros(
            (pad_tiles, t_total, fsize, fsize), np.float32)])
    for k0 in range(0, n_tiles + pad_tiles, b):
        batch = {"audio": torch.from_numpy(tiles[k0:k0 + b]).to(device),
                 "frames": torch.from_numpy(frames[k0:k0 + b]).to(device)}
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        got = separate(batch, gen)["audio_out"].cpu().numpy()
        for j in range(b):
            k = k0 + j
            if k < n_tiles:
                out[k * s_total:(k + 1) * s_total] = got[j]
    out = out[:n]
    write_wav(out_path, out, cfg.samplerate)

    summary = {"out": out_path, "n_samples": int(n), "tiles": int(n_tiles),
               "tile_samples": int(s_total), "sr": cfg.samplerate}
    if reference:
        ref, _ = read_wav(reference)
        ref = mono_mix(torch.from_numpy(ref))[:n]
        summary["si_sdr"] = float(si_sdr(
            torch.from_numpy(out[:ref.shape[-1]]), ref))
    print(json.dumps(summary))
    return summary


def main(argv=None) -> dict:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--audio", required=True)
    pre.add_argument("--out", required=True)
    pre.add_argument("--frames", default=None,
                     help="ingested frame-shard dir for the visual stream")
    pre.add_argument("--reference", default=None,
                     help="clean wav to score SI-SDR against")
    pre.add_argument("--device", default="cuda")
    own, rest = pre.parse_known_args(argv)

    from maavss_tpu_torch.config import model_args

    noise_given = any(a == "--noise_scalar" or a.startswith("--noise_scalar=")
                      for a in rest)
    return separate_file(model_args(rest), own.audio, own.out, own.frames,
                         own.reference, own.device, noise_given)


if __name__ == "__main__":
    main()
