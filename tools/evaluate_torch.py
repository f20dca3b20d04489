#!/usr/bin/env python
"""Separation evaluation with the PyTorch port: SI-SDR of a trained model's
separated audio over held-out clips, and the separated wav pairs (the
port's counterpart of `evaluate.py`).

The chain is evaluate.py's: `load_stores` -> `AVDataset` (clips of
num_frames + num_seq frames; the fusion model reads `--pgram_cache` rows
where set) -> the validation split of `split_train_val`, unshuffled (the
whole dataset when the split holds less than a batch) -> `max(1,
--val_steps)` batches through the separator (train/infer.py), the noise of
batch i drawn from a `torch.Generator` seeded `--seed + i` (the JAX tool's
`PRNGKey(seed + i)`; the draws differ, their distribution does not). The
first batch's first two clips are written as
`<log_dir>/separated/example_{1,2}_{output,ground_truth}.wav`. Prints one
JSON line: si_sdr_mean, si_sdr_gain_mean, n_clips, wav_dir.

`-c` resumes the newest checkpoint in `--cp_dir`, `--checkpoint PATH`
loads one file (exp/checkpoint.py: the port's `.ckpt.pt` or the JAX
package's `.ckpt.pkl`). `--model frames` evaluates the frames model
(latent width 16, the frame size read from the store). `--compare EST REF`
prints the SI-SDR and SDR of two wav files and exits. Runs on the card
unless `--device cpu` is given (the plain PyTorch versions).

Usage:
  python tools/evaluate_torch.py --data_path synthetic -c
  python tools/evaluate_torch.py --model frames --checkpoint run.ckpt.pkl
  python tools/evaluate_torch.py --compare out.wav ref.wav
  on the CPU at the small geometry:
  python tools/evaluate_torch.py --device cpu --data_path synthetic -b 2
      --num_frames 4 --fft_len 64 --p_size 16 --latent_chan 8
      --fc_size 256
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compare_wavs(est_path: str, ref_path: str) -> dict:
    """SI-SDR and SDR of the first channel of two wav files over their
    common length; prints and returns the JSON line of evaluate.py's
    --compare."""
    import torch

    from maavss_tpu_torch.data.wavio import read_wav
    from maavss_tpu_torch.ops.metrics import sdr, si_sdr

    est, sr1 = read_wav(est_path)
    ref, sr2 = read_wav(ref_path)
    n = min(est.shape[-1], ref.shape[-1])
    e = torch.from_numpy(est[0, :n].copy())
    r = torch.from_numpy(ref[0, :n].copy())
    out = {"si_sdr": float(si_sdr(e, r)), "sdr": float(sdr(e, r)),
           "n_samples": int(n), "sr": [sr1, sr2], "est": est_path,
           "ref": ref_path}
    print(json.dumps(out))
    return out


def cuda_device(device, tool: str):
    """torch.device(device); a CUDA device that is missing exits, and on
    one TF32 is turned off, so fp32 runs in fp32."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"{tool}: CUDA is not available (pass --device "
                             "cpu to run the plain PyTorch versions)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def load_weights(cfg, model) -> None:
    """-c / --checkpoint into `model`, in place (exp/checkpoint.py)."""
    from maavss_tpu_torch.exp.checkpoint import load_checkpoint

    if cfg.c or cfg.checkpoint:
        load_checkpoint(cfg.cp_dir, types.SimpleNamespace(model=model,
                                                          step=0),
                        auto=cfg.c, path=cfg.checkpoint)


def evaluate(cfg, model_kind: str = "fusion", device="cuda") -> dict:
    """The run of the module docstring; returns the JSON line's dict."""
    import numpy as np
    import torch

    from maavss_tpu_torch.data.dataset import (
        AVDataset,
        Subset,
        batches,
        split_train_val,
    )
    from maavss_tpu_torch.exp.viz import save_audio
    from maavss_tpu_torch.train.infer import make_separator
    from maavss_tpu_torch.train.setup import (
        build_frames_model,
        build_fusion,
        load_pgram_store,
        load_stores,
    )

    device = cuda_device(device, "evaluate_torch")
    frames, audio = load_stores(cfg)
    frames_model = model_kind == "frames"
    dataset = AVDataset(cfg, frames, audio, cfg.num_frames + cfg.num_seq,
                        pgrams=None if frames_model else load_pgram_store(cfg))
    _, va_idx = split_train_val(len(dataset), cfg.split, cfg.seed)
    val = Subset(dataset, va_idx if len(va_idx) >= cfg.batch_size else
                 np.arange(len(dataset)))
    if frames_model:
        model = build_frames_model(cfg, cfg.batch_size,
                                   dataset[0]["frames"].shape[-1],
                                   device=device)
    else:
        model = build_fusion(cfg, cfg.batch_size, device)
    load_weights(cfg, model)
    separate = make_separator(model, cfg, frames_model)

    it = batches(val, cfg.batch_size, shuffle=False)
    sdrs, gains = [], []
    out_dir = os.path.join(cfg.log_dir, "separated")
    for i in range(max(1, cfg.val_steps)):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(it).items()}
        gen = torch.Generator(device=device).manual_seed(cfg.seed + i)
        out = separate(batch, gen)
        sdrs.extend(out["si_sdr"].tolist())
        gains.extend(out["si_sdr_gain"].tolist())
        if i == 0:  # the reference's audio/ example pairs
            for b in range(min(2, out["audio_out"].shape[0])):
                save_audio(os.path.join(out_dir, f"example_{b+1}_output.wav"),
                           out["audio_out"][b].cpu().numpy(), cfg.samplerate)
                save_audio(
                    os.path.join(out_dir, f"example_{b+1}_ground_truth.wav"),
                    batch["audio"][b].cpu().numpy(), cfg.samplerate)
    summary = {"si_sdr_mean": float(np.mean(sdrs)),
               "si_sdr_gain_mean": float(np.mean(gains)),
               "n_clips": len(sdrs), "wav_dir": out_dir}
    print(json.dumps(summary))
    return summary


def main(argv=None) -> dict:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--compare", nargs=2, metavar=("EST", "REF"),
                     default=None,
                     help="score SI-SDR/SDR between two wav files and exit")
    pre.add_argument("--model", choices=("fusion", "frames"),
                     default="fusion")
    pre.add_argument("--device", default="cuda")
    own, rest = pre.parse_known_args(argv)
    if own.compare is not None:
        return compare_wavs(*own.compare)

    from maavss_tpu_torch.config import model_args

    return evaluate(model_args(rest), own.model, own.device)


if __name__ == "__main__":
    main()
