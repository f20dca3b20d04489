"""Model construction (counterpart of maavss_tpu/train/setup.py:build_fusion).

`build_fusion(cfg, batch_size, device="cuda", generator)` plans the fusion
model from the run config, initialises it from an explicit `torch.Generator`
with flax's distributions, and returns it on `device` in eval mode;
`build_fusion_state` also returns its `TrainState` (the JAX `build_fusion`'s
pair). The initialisation:

- conv, transposed-conv and dense kernels: lecun-normal (variance 1/fan_in,
  normal truncated at two standard deviations, flax's rescaled stddev);
  biases zero;
- LSTM w_i / w_h: U(-1/sqrt(H), 1/sqrt(H));
- BatchNorm: scale 1, bias 0, running mean 0, running variance 1.

The numbers differ from a flax init with the same seed (different
generators); `convert.from_flax` carries a flax init across exactly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.models.fusion import AVFusionModel, resolve_pgenc_kernel
from maavss_tpu_torch.models.layers import LSTM
from maavss_tpu_torch.train.state import TrainState, create_train_state

# flax's truncated_normal initializer rescales so the truncated
# distribution has the requested variance
_TRUNC_STD = 0.87962566103423978


def check_supported(cfg: RunConfig, train: bool = False) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for every option
    the port does not implement yet; `train=True` adds the train step's
    flags."""
    todo = [
        (cfg.rnn_cell != "lstm", f"--rnn_cell {cfg.rnn_cell}", "M2"),
        (cfg.mask_head, "--mask_head", "queue 2, K4"),
        (cfg.use_polar, "--use_polar", "queue 2, K4"),
        (cfg.fusion_encode != "window", "--fusion_encode full", "M4"),
        (cfg.pgram_cache, "--pgram_cache", "M4"),
        (cfg.compress_audio, "--compress_audio", "M9 (ops/audio.py)"),
        (cfg.attn_diff, "--attn_diff", "M4"),
        (cfg.dtype != "float32", f"--dtype {cfg.dtype}", "M5 (bf16 slice)"),
    ]
    if train:
        todo += [
            (cfg.microbatch > 1, f"--microbatch {cfg.microbatch}", "M3-rest"),
            (cfg.remat, "--remat", "M3-rest"),
            (bool(cfg.noise_schedule), "--noise_schedule", "M3-rest"),
            (cfg.lr_schedule != "constant",
             f"--lr_schedule {cfg.lr_schedule}", "M3-rest (LR schedules)"),
            (cfg.steps_per_dispatch > 1,
             f"--steps_per_dispatch {cfg.steps_per_dispatch}",
             "M5 (CUDA graphs)"),
            (cfg.fused_opt, "--fused_opt", "queue 1, 'Not carried'"),
        ]
    for missing, flag, item in todo:
        if missing:
            raise NotImplementedError(
                f"{flag} is not ported to maavss_tpu_torch yet (ROADMAP {item})")


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


@torch.no_grad()
def init_flax_like(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every parameter with flax's distributions (see module
    docstring), in module order."""
    for mod in model.modules():
        if isinstance(mod, nn.ConvTranspose2d):  # weight [in, out, kh, kw]
            kh, kw = mod.kernel_size
            _lecun_normal_(mod.weight, mod.weight.shape[0] * kh * kw, generator)
        elif isinstance(mod, nn.Conv2d):  # weight [out, in, kh, kw]
            kh, kw = mod.kernel_size
            _lecun_normal_(mod.weight, mod.weight.shape[1] * kh * kw, generator)
        elif isinstance(mod, nn.Linear):
            _lecun_normal_(mod.weight, mod.in_features, generator)
        elif isinstance(mod, LSTM):
            bound = 1.0 / math.sqrt(mod.hidden)
            nn.init.uniform_(mod.w_i, -bound, bound, generator=generator)
            nn.init.uniform_(mod.w_h, -bound, bound, generator=generator)
            continue
        else:
            continue
        if mod.bias is not None:
            nn.init.zeros_(mod.bias)


def build_fusion(cfg: RunConfig, batch_size: int, device="cuda",
                 generator: Optional[torch.Generator] = None) -> AVFusionModel:
    """The fusion model for `cfg`, seeded-initialised, on `device`, in eval
    mode. `generator` defaults to a CPU generator seeded with cfg.seed; the
    parameters are drawn on the CPU and then moved, so one seed gives the
    same weights on every device."""
    check_supported(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    t_stft = cfg.hops_per_frame * cfg.num_frames
    model = AVFusionModel(
        stft_shape=(batch_size, 2, t_stft, cfg.fft_len // 2),
        pgram_shape=(batch_size, 1, cfg.num_frames, cfg.p_size ** 2),
        latent_channels=cfg.latent_chan, fc_size=cfg.fc_size,
        rnn_cell=cfg.rnn_cell, mask_head=cfg.mask_head,
        pgenc_kernel=resolve_pgenc_kernel(cfg.pgenc_kernel, device),
        stft_fold=cfg.stft_fold)
    init_flax_like(model, generator)
    return model.to(device).eval()


def build_fusion_state(cfg: RunConfig, batch_size: int, device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[AVFusionModel, TrainState]:
    """(model, train state) for `cfg` on `device`: `build_fusion` and Adam
    with the --opt_kernel gate; the model is left in train mode."""
    check_supported(cfg, train=True)
    model = build_fusion(cfg, batch_size, device, generator)
    return model, create_train_state(model, cfg, device)
