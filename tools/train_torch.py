#!/usr/bin/env python
"""Train the fusion or frames model with the PyTorch port for a few steps on
synthetic batches (the port's counterpart of `train.py` and
`train_avse_frames.py` with `--data_path synthetic`, up to the trainer,
which is ROADMAP M6).

Builds the model and its train state on the card (`--device cpu` runs the
plain PyTorch versions on the CPU), then takes `-s` steps of
`make_fusion_step` (`--model fusion`, the default) or `make_frames_step`
(`--model frames`: latent width 16, frames at --framesize) in mode 2
(audio + visual; the mode curriculum comes with the trainer) on
`synthetic_av_batch` batches seeded `--seed + step` (under --pgram_cache
the frames become their float16 phasegram rows, `with_pgram_rows`;
`--fusion_encode full` takes the full-encode step). Prints
one JSON line per step (loss, a_loss, v_loss, grad_norm, ms), then a final
line with the steps, the mean step time over the steps after the first (the
first builds the kernels) and clips/s.

Usage: python tools/train_torch.py [--model fusion|frames] [-s 3]
       [--device cuda] [model flags...]
  e.g. on the CPU at the small geometry:
  python tools/train_torch.py --device cpu -s 3 -b 2 --num_frames 4
      --fft_len 64 --p_size 16 --latent_chan 8 --fc_size 256 -lr 1e-3
  python tools/train_torch.py --device cpu -s 3 -b 2 --num_frames 4
      --fft_len 64 --p_size 16 --latent_chan 8 --fc_size 256 -lr 1e-3
      --fusion_encode full --pgram_cache
  python tools/train_torch.py --model frames --device cpu -s 3 -b 2
      --num_frames 2 --num_seq 2 -a 4 --fft_len 64 --framesize 24 -lr 1e-3
  `--dtype bfloat16` trains in bf16 (flax's mixed precision, as the JAX
  package's --dtype bfloat16), with every other flag.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", choices=("fusion", "frames"),
                     default="fusion")
    pre.add_argument("--device", default="cuda")
    own, rest = pre.parse_known_args(argv)
    frames_model = own.model == "frames"

    import torch

    from maavss_tpu_torch.config import model_args
    from maavss_tpu_torch.data.synthetic import (
        synthetic_av_batch,
        with_pgram_rows,
    )
    from maavss_tpu_torch.train.setup import (
        build_frames_state,
        build_fusion_state,
    )
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step

    cfg = model_args(rest)
    device = torch.device(own.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_torch: CUDA is not available (pass --device "
                         "cpu to train with the plain PyTorch versions)")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    init = torch.Generator().manual_seed(cfg.seed)
    if frames_model:
        _, state = build_frames_state(cfg, cfg.batch_size, device=device,
                                      generator=init)
        step = make_frames_step(state.model, cfg, device=device)
    else:
        _, state = build_fusion_state(cfg, cfg.batch_size, device, init)
        step = make_fusion_step(state.model, cfg, device=device)
    frame_size = cfg.framesize if frames_model else None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    times = []
    for i in range(cfg.steps_per_epoch):
        batch = synthetic_av_batch(cfg, cfg.batch_size, seed=cfg.seed + i,
                                   frame_size=frame_size)
        if cfg.pgram_cache and not frames_model:
            batch = with_pgram_rows(batch, device)
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, 2, generator)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        times.append(ms)
        line = {"step": state.step, "ms": ms}
        line.update({k: float(metrics[k]) for k in
                     ("loss", "a_loss", "v_loss", "grad_norm")})
        print(json.dumps(line), flush=True)
    steady = times[1:] or times
    mean_ms = sum(steady) / len(steady)
    print(json.dumps({
        "steps": len(times), "mean_step_ms": mean_ms,
        "clips_per_s": cfg.batch_size / (mean_ms / 1e3),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "model": own.model, "window_mode": cfg.window_mode,
        "fusion_encode": cfg.fusion_encode, "pgram_cache": cfg.pgram_cache,
        "batch": cfg.batch_size, "dtype": cfg.dtype}),
        flush=True)


if __name__ == "__main__":
    main()
