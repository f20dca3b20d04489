#!/usr/bin/env python
"""Legacy raw-FFT training with the PyTorch port: the counterpart of
main.py.

`DataGenerator` batches (random windows of the on-disk store, full-clip
FFT features, x = y + noise) go into `AVSEModel` (conv1d audio and conv3d
visual encoders, FC fusion), with the loss a_loss + loss_coeff * v_loss
(mse of the audio head against the clean features, of the visual head
against the frames) and SGD at the constant --learning_rate, as main.py
uses optax.sgd (the run config's --lr_schedule does not apply there).
Metrics go to `<log_dir>/legacy-<time>-s<seed>/metrics.jsonl`, one line a
step, with the clips/s of `Meter`; every --cb_freq steps a line is
printed. Runs on the card unless `--device cpu` is given.

Usage:
  python tools/train_legacy_torch.py --data_path data/processed -e 1 -s 50
  python tools/train_legacy_torch.py --data_path synthetic -b 4
  on the CPU at a small geometry:
  python tools/train_legacy_torch.py --device cpu --data_path synthetic
      -e 1 -s 2 -b 2 --num_frames 4 --p_size 32
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_legacy_model(a_shape, v_shape, seed: int, device="cuda"):
    """`AVSEModel` for batches of these shapes, flax's initialisers drawn
    from a CPU generator seeded with `seed` (one seed, the same weights on
    every device), on `device` in train mode."""
    import torch

    from maavss_tpu_torch.models.legacy import AVSEModel
    from maavss_tpu_torch.train.setup import init_flax_like

    model = AVSEModel(a_shape=a_shape, v_shape=v_shape)
    init_flax_like(model, torch.Generator().manual_seed(seed))
    return model.to(device).train()


def make_legacy_step(model, tx, loss_coeff: float):
    """main.py's step: (x_fft, y_fft, frames) tensors on the model's device
    -> {loss, a_loss, v_loss} (0-d tensors); one SGD update of `tx`."""
    import torch

    def step(x_a, y_a, x_v):
        tx.zero_grad()
        yh_a, yh_v = model(x_a, x_v)
        a_loss = torch.mean((yh_a - y_a) ** 2)
        v_loss = torch.mean((yh_v - x_v) ** 2)
        loss = a_loss + loss_coeff * v_loss
        loss.backward()
        tx.step()
        return {"loss": loss.detach(), "a_loss": a_loss.detach(),
                "v_loss": v_loss.detach()}

    return step


def train(cfg, device="cuda"):
    """The run of the module docstring; returns the trained model."""
    import torch

    from maavss_tpu_torch.data.generator import DataGenerator
    from maavss_tpu_torch.exp.metrics import Meter, MetricsLogger
    from maavss_tpu_torch.train.setup import load_stores, run_name
    from maavss_tpu_torch.train.state import make_optimizer

    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    frames, audio = load_stores(cfg)
    gen = DataGenerator(cfg, frames, audio, seed=cfg.seed).generator()
    x_fft, _, fr, _ = next(gen)
    model = build_legacy_model(x_fft.shape, fr.shape, cfg.seed, device)
    tx = make_optimizer(list(model.named_parameters()), cfg.learning_rate,
                        "sgd")
    step = make_legacy_step(model, tx, cfg.loss_coeff)
    logger = MetricsLogger(cfg.log_dir, run_name("legacy", cfg),
                           use_wandb=cfg.wandb)
    meter = Meter(1)
    gstep = 0
    for e in range(cfg.epochs):
        for i in range(cfg.steps_per_epoch):
            x_fft, y_fft, fr, _ = next(gen)
            metrics = step(*(torch.from_numpy(a).to(device)
                             for a in (x_fft, y_fft, fr)))
            meter.update(x_fft.shape[0])
            gstep += 1
            logger.log({**{k: float(v) for k, v in metrics.items()},
                        "clips_per_sec_per_chip": meter.clips_per_sec_per_chip},
                       step=gstep)
            if i % cfg.cb_freq == 0:
                print(f"epoch {e} step {i} loss {float(metrics['loss']):.6f}")
    logger.close()
    return model


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    own, rest = pre.parse_known_args(argv)

    import torch

    from maavss_tpu_torch.config import model_args

    cfg = model_args(rest)
    if torch.device(own.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("train_legacy_torch: CUDA is not available (pass "
                         "--device cpu to train on the CPU)")
    train(cfg, own.device)


if __name__ == "__main__":
    main()
