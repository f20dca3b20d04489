#!/usr/bin/env python
"""Train with the PyTorch port from an on-disk store: the port's
counterpart of `train.py` (`--model fusion`, the default),
`train_avse_frames.py` (`--model frames`) and the staged recipe's
scripts: `train_audio_net.py` (`--model audio_net`),
`train_autoencoder.py` (`--model autoencoder`), `train_visual_net.py`
and `train_3d_conv_net.py` (`--model visual_net`, the same run) and
`train_av_net.py` (`--model av_net`).

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
  `--mode_schedule` default `random01`, a checkpoint every epoch;
- audio_net: the STFT autoencoder (`make_audio_ae_step` and its eval) on
  `AVDataset(mode="audio")` clips of num_frames frames, mode 0, a
  checkpoint at each best validation loss;
- autoencoder: the same step on `STFTDataset`'s random crops (no split:
  train and validation streams from the whole set), a checkpoint every
  epoch, then `save_model`;
- visual_net: the phasegram autoencoder (`make_visual_ae_step` and its
  eval) on `VideoDataset` clips, mode 1, best-validation checkpoints;
- av_net: the staged AV stage, the fusion step and eval with only
  FUSION_SUBNETS trainable (both autoencoders frozen: no update, no
  moments) after `--saved_model` (a `.params.pt` of the port or a JAX
  `.params.pkl`) is loaded, mode 2, best-validation checkpoints.

The staged recipe: `--model audio_net` (or `autoencoder`, which writes
`saved_models/stft-ae-<...>.params.pt`), `--model visual_net`, then
`--model av_net --saved_model <params file>`: as train_av_net.py, the
stage restores the parameters of one file (`load_model`; BatchNorm's
running statistics start fresh) and trains the fusion core and heads
with both autoencoders frozen.

Under `torchrun --nproc_per_node N` the run is one process a rank over
`--mesh_data` x `--mesh_model` = N ranks (parallel/, the JAX entries'
mesh): NCCL on the card (each rank on cuda:LOCAL_RANK), gloo with
`--device cpu`; every rank builds the seeded state, the split leaves
become its shards (`apply_mesh_model`), reads the global batches and
keeps its rows; rank 0 writes the metrics, checkpoints and saved model
(the whole state). A mesh that is not the world raises.

Every flag of the run config applies (`--lr_schedule`,
`--steps_per_dispatch`, `--dtype bfloat16`, `--fusion_encode full`, ...).
Runs on the card unless `--device cpu` is given (the plain PyTorch
versions). `MAAVSS_MEDIA=1` adds train.py's media callback to a fusion
run (`make_fusion_media_fn`: every --cb_freq steps the STFT panels of the
batch's first clip and its input and separated audio, under
`<log_dir>/<run>/media/`); the other models, like their JAX entries,
have none. `--native_loader` assembles the frames' batches in C++
(data/native_loader.py).

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
  python tools/fit_torch.py --model autoencoder --device cpu --data_path
      synthetic -e 1 -s 2 -v 1 -b 2 --num_frames 4 --fft_len 64
      --p_size 16 --latent_chan 8 --fc_size 256 -lr 1e-3
  python tools/fit_torch.py --model av_net --saved_model
      saved_models/<run>.params.pt ... (the same flags)
  data x tensor parallel, 4 ranks on 4 cards (2 x 2), or on the CPU:
  torchrun --nproc_per_node 4 tools/fit_torch.py --data_path synthetic
      -e 2 -s 4 -b 8 --mesh_data 2 --mesh_model 2
  torchrun --nproc_per_node 4 tools/fit_torch.py --device cpu ... (the
      small geometry flags) -b 4 --mesh_model 2
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


MODELS = ("fusion", "frames", "audio_net", "autoencoder", "visual_net",
          "av_net")


def fit(cfg, model_name: str = "fusion", device="cuda"):
    """The run of the module docstring; returns the trained TrainState."""
    import torch

    from maavss_tpu_torch.data.dataset import (
        AVDataset,
        STFTDataset,
        VideoDataset,
        split_train_val,
    )
    from maavss_tpu_torch.exp.checkpoint import load_model, save_model
    from maavss_tpu_torch.parallel.distributed import (
        initialize,
        rank_zero_first,
    )
    from maavss_tpu_torch.train.setup import (
        FUSION_SUBNETS,
        apply_mesh_model,
        build_frames_state,
        build_fusion_state,
        default_mesh,
        load_pgram_store,
        load_stores,
        make_fusion_media_fn,
        make_stream,
        run_name,
    )
    from maavss_tpu_torch.train import steps
    from maavss_tpu_torch.train.trainer import Trainer

    if model_name not in MODELS:
        raise SystemExit(f"fit_torch: unknown --model {model_name!r} "
                         f"({'|'.join(MODELS)})")
    device = initialize(device) or torch.device(device)
    mesh = default_mesh(cfg)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    init = torch.Generator().manual_seed(cfg.seed)
    frames, audio = rank_zero_first(lambda: load_stores(cfg))
    eval_fn, split, save = None, True, model_name in ("fusion", "frames",
                                                      "autoencoder")
    # (run-name prefix, mode schedule, fixed mode, checkpoint policy)
    if model_name == "frames":
        clip_len = cfg.num_frames + cfg.num_seq + 2 * cfg.frames_halo
        dataset = AVDataset(cfg, frames, audio, clip_len)
        frame_size = dataset[0]["frames"].shape[-1]
        _, state = build_frames_state(cfg, cfg.batch_size, frame_size,
                                      device=device, generator=init)
        apply_mesh_model(cfg, mesh, state)
        step = steps.make_frames_step(state.model, cfg, device=device)
        plan = ("avse-frames", cfg.mode_schedule or "random01", 2, "epoch")
    elif model_name in ("fusion", "av_net"):
        clip_len = cfg.num_frames + cfg.num_seq  # train.py:33-43
        dataset = AVDataset(cfg, frames, audio, clip_len,
                            pgrams=load_pgram_store(cfg))
        staged = model_name == "av_net"
        _, state = build_fusion_state(
            cfg, cfg.batch_size, device, init,
            trainable=FUSION_SUBNETS if staged else None)
        apply_mesh_model(cfg, mesh, state)
        if staged and cfg.saved_model:
            load_model(cfg.saved_model, state.model)  # train_av_net.py
        step = steps.make_fusion_step(state.model, cfg, device=device)
        eval_fn = steps.make_fusion_eval(state.model, cfg, device=device)
        plan = (("av-net", "fixed", 2, "best") if staged else
                ("avf", cfg.mode_schedule or "cycle", 2, "epoch"))
    else:
        if model_name == "audio_net":
            dataset = AVDataset(cfg, frames, audio, cfg.num_frames,
                                mode="audio")
        elif model_name == "autoencoder":
            dataset, split = STFTDataset(cfg, audio, seed=cfg.seed), False
        else:  # visual_net (train_3d_conv_net.py is the same run)
            dataset = VideoDataset(cfg, frames, cfg.num_frames)
        _, state = build_fusion_state(cfg, cfg.batch_size, device, init)
        apply_mesh_model(cfg, mesh, state)
        if model_name == "visual_net":
            step = steps.make_visual_ae_step(state.model, cfg, device=device)
            eval_fn = steps.make_visual_ae_eval(state.model, cfg,
                                                device=device)
            plan = ("visual-net", "fixed", 1, "best")
        else:
            step = steps.make_audio_ae_step(state.model, cfg, device=device)
            eval_fn = steps.make_audio_ae_eval(state.model, cfg,
                                               device=device)
            plan = (("audio-net", "fixed", 0, "best")
                    if model_name == "audio_net"
                    else ("stft-ae", "fixed", 0, "epoch"))
    prefix, schedule, fixed_mode, policy = plan
    name = run_name(prefix, cfg)
    tr_idx, va_idx = (split_train_val(len(dataset), cfg.split, cfg.seed)
                      if split else (None, None))
    media_fn = None
    if model_name == "fusion" and os.environ.get("MAAVSS_MEDIA") == "1":
        media_fn = make_fusion_media_fn(
            state.model, cfg, os.path.join(cfg.log_dir, name, "media"))
    trainer = Trainer(cfg, step, state, run_name=name, eval_fn=eval_fn,
                      mode_schedule=schedule, fixed_mode=fixed_mode,
                      checkpoint_policy=policy, media_fn=media_fn)
    state = trainer.fit(make_stream(cfg, dataset, tr_idx, cfg.seed,
                                    stack=cfg.steps_per_dispatch, mesh=mesh),
                        make_stream(cfg, dataset, va_idx, cfg.seed + 1,
                                    mesh=mesh))
    if save and not cfg.no_save:
        save_model(f"saved_models/{name}", state.model)  # train.py:243-244
    return state


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", choices=MODELS, default="fusion")
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
