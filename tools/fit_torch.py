#!/usr/bin/env python
"""Train the fusion or frames model with the PyTorch port from an on-disk
store: the port's counterpart of `train.py` (`--model fusion`, the
default) and `train_avse_frames.py` (`--model frames`).

The chain is the JAX entries': `load_stores` -> `AVDataset` ->
`split_train_val` -> `make_stream` (train and validation, a prefetch
thread building numpy batches) -> `Trainer.fit` (epochs, the mode
curriculum, metrics in `<log_dir>/<run>/metrics.jsonl`, checkpoints in
`--cp_dir`, `-c` resume, SIGTERM drain) -> `save_model` into
`saved_models/<run>.params.pt` unless `--no_save`.

- fusion: clips of num_frames + num_seq frames (`--pgram_cache` reads the
  phasegram rows of `<data_root>/pgrams-p<p_size>/`, built by
  tools/save_phasegrams_torch.py), the fusion step and its eval every
  epoch, `--mode_schedule` default `cycle`, a checkpoint every epoch;
- frames: clips of num_frames + num_seq + 2 * frames_halo frames, the
  frame size read from the store, latent width 16, no eval,
  `--mode_schedule` default `random01`, a checkpoint every epoch.

Every flag of the run config applies (`--lr_schedule`,
`--steps_per_dispatch`, `--dtype bfloat16`, `--fusion_encode full`, ...).
Runs on the card unless `--device cpu` is given (the plain PyTorch
versions). `MAAVSS_MEDIA=1` (the JAX entries' media callback) is not
ported yet and raises.

Usage:
  python tools/fit_torch.py --data_path synthetic -e 2 -s 4 -b 8
  python tools/fit_torch.py --model frames --data_path data/processed
  on the CPU at the small geometry:
  python tools/fit_torch.py --device cpu --data_path synthetic -e 2 -s 2
      -v 1 -b 2 --num_frames 4 --fft_len 64 --p_size 16 --latent_chan 8
      --fc_size 256 -lr 1e-3
  python tools/fit_torch.py --model frames --device cpu --data_path
      synthetic -e 1 -s 2 -b 2 --num_frames 2 --num_seq 2 -a 4
      --fft_len 64 --p_size 24 -lr 1e-3
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def fit(cfg, model_name: str = "fusion", device="cuda"):
    """The run of the module docstring; returns the trained TrainState."""
    import torch

    from maavss_tpu_torch.data.dataset import AVDataset, split_train_val
    from maavss_tpu_torch.exp.checkpoint import save_model
    from maavss_tpu_torch.train.setup import (
        build_frames_state,
        build_fusion_state,
        load_pgram_store,
        load_stores,
        make_stream,
        run_name,
    )
    from maavss_tpu_torch.train.steps import (
        make_fusion_eval,
        make_frames_step,
        make_fusion_step,
    )
    from maavss_tpu_torch.train.trainer import Trainer

    if os.environ.get("MAAVSS_MEDIA") == "1":
        raise NotImplementedError(
            "MAAVSS_MEDIA (the training media callback) is not ported to "
            "maavss_tpu_torch yet (ROADMAP M6-rest (media))")
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    init = torch.Generator().manual_seed(cfg.seed)
    frames, audio = load_stores(cfg)
    eval_fn = None
    if model_name == "frames":
        clip_len = cfg.num_frames + cfg.num_seq + 2 * cfg.frames_halo
        dataset = AVDataset(cfg, frames, audio, clip_len)
        frame_size = dataset[0]["frames"].shape[-1]
        _, state = build_frames_state(cfg, cfg.batch_size, frame_size,
                                      device=device, generator=init)
        step = make_frames_step(state.model, cfg, device=device)
        name = run_name("avse-frames", cfg)
        schedule = cfg.mode_schedule or "random01"
    else:
        clip_len = cfg.num_frames + cfg.num_seq  # train.py:33-43
        dataset = AVDataset(cfg, frames, audio, clip_len,
                            pgrams=load_pgram_store(cfg))
        _, state = build_fusion_state(cfg, cfg.batch_size, device, init)
        step = make_fusion_step(state.model, cfg, device=device)
        eval_fn = make_fusion_eval(state.model, cfg, device=device)
        name = run_name("avf", cfg)
        schedule = cfg.mode_schedule or "cycle"
    tr_idx, va_idx = split_train_val(len(dataset), cfg.split, cfg.seed)
    trainer = Trainer(cfg, step, state, run_name=name, eval_fn=eval_fn,
                      mode_schedule=schedule, fixed_mode=2,
                      checkpoint_policy="epoch")
    state = trainer.fit(make_stream(cfg, dataset, tr_idx, cfg.seed,
                                    stack=cfg.steps_per_dispatch),
                        make_stream(cfg, dataset, va_idx, cfg.seed + 1))
    if not cfg.no_save:
        save_model(f"saved_models/{name}", state.model)  # train.py:243-244
    return state


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", choices=("fusion", "frames"),
                     default="fusion")
    pre.add_argument("--device", default="cuda")
    own, rest = pre.parse_known_args(argv)

    import torch

    from maavss_tpu_torch.config import model_args

    cfg = model_args(rest)
    if torch.device(own.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("fit_torch: CUDA is not available (pass --device "
                         "cpu to train with the plain PyTorch versions)")
    fit(cfg, own.model, own.device)


if __name__ == "__main__":
    main()
