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
`--fusion_encode full` takes the full-encode step; `--frames_encode full`
and `--frames_halo k` the frames model's, on clips of num_frames +
num_seq + 2k frames; `--microbatch M` splits each batch into M chunks
before the one update). Prints
one JSON line per step (loss, a_loss, v_loss, grad_norm, ms), then a final
line with the steps, the mean step time over the steps after the first
dispatch (the first builds the kernels, and under --steps_per_dispatch
captures the CUDA graph) and clips/s.

`--steps_per_dispatch K` stacks K batches a dispatch (`stack_batches`) and
runs them as one K-step dispatch (one CUDA-graph replay on the card); `-s`
must be a multiple of K, as the JAX Trainer requires of steps_per_epoch.
Each optimizer step still prints its own line, its ms the dispatch's over
K. `--noise_schedule linear:<start>:<end>` (or cosine) anneals the
additive noise: the host evaluates the schedule at the global step before
each dispatch, as maavss_tpu/train/trainer.py does, and the K steps of a
dispatch share that value.

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
  python tools/train_torch.py --model frames -s 3 -b 8 --dtype bfloat16
      --frames_encode full --frames_halo 1 --microbatch 2
  `--dtype bfloat16` trains in bf16 (flax's mixed precision, as the JAX
  package's --dtype bfloat16), with every other flag.
  python tools/train_torch.py -s 8 --steps_per_dispatch 4
      --noise_schedule linear:0.1:0.0
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
        resolve_noise_schedule,
        stack_batches,
    )
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step

    cfg = model_args(rest)
    k = max(1, cfg.steps_per_dispatch)
    if cfg.steps_per_epoch % k:
        raise ValueError(
            f"steps_per_epoch={cfg.steps_per_epoch} must be a multiple of "
            f"steps_per_dispatch={k}")
    noise_fn = resolve_noise_schedule(cfg)
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

    def make_batch(i):
        batch = synthetic_av_batch(cfg, cfg.batch_size, seed=cfg.seed + i,
                                   frame_size=frame_size)
        if cfg.pgram_cache and not frames_model:
            batch = with_pgram_rows(batch, device)
        return batch

    times = []
    for i in range(0, cfg.steps_per_epoch, k):
        if k > 1:
            batch = stack_batches([make_batch(i + j) for j in range(k)])
        else:
            batch = make_batch(i)
        noise = None if noise_fn is None else noise_fn(state.step)
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, 2, generator, noise=noise)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / k
        host = {key: metrics[key].reshape(-1).tolist() for key in
                ("loss", "a_loss", "v_loss", "grad_norm")}
        for j in range(k):
            line = {"step": state.step - k + j + 1, "ms": ms}
            if noise is not None:
                line["noise"] = noise
            line.update({key: v[j] for key, v in host.items()})
            print(json.dumps(line), flush=True)
            times.append(ms)
    steady = times[k:] or times
    mean_ms = sum(steady) / len(steady)
    print(json.dumps({
        "steps": len(times), "mean_step_ms": mean_ms,
        "clips_per_s": cfg.batch_size / (mean_ms / 1e3),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "model": own.model, "window_mode": cfg.window_mode,
        "fusion_encode": cfg.fusion_encode, "pgram_cache": cfg.pgram_cache,
        "frames_encode": cfg.frames_encode, "frames_halo": cfg.frames_halo,
        "microbatch": cfg.microbatch,
        "batch": cfg.batch_size, "dtype": cfg.dtype,
        "steps_per_dispatch": k, "noise_schedule": cfg.noise_schedule}),
        flush=True)


if __name__ == "__main__":
    main()
