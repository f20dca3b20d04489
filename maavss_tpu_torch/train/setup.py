"""Model construction (counterpart of maavss_tpu/train/setup.py:build_fusion
and build_frames_model).

`build_fusion(cfg, batch_size, device="cuda", generator)` plans the fusion
model from the run config, initialises it from an explicit `torch.Generator`
with flax's distributions, and returns it on `device` in eval mode;
`build_fusion_state` also returns its `TrainState` (the JAX `build_fusion`'s
pair). `build_frames_model` / `build_frames_state` do the same for the frames
model. The initialisation:

- conv (2-D and 3-D), transposed-conv and dense kernels: lecun-normal
  (variance 1/fan_in, normal truncated at two standard deviations, flax's
  rescaled stddev); biases zero;
- LSTM w_i / w_h: U(-1/sqrt(H), 1/sqrt(H)), drawn in fp32 and rounded to
  the parameters' dtype, so a bfloat16 model holds its float32 twin's
  weights rounded;
- BatchNorm: scale 1, bias 0, running mean 0, running variance 1.

`--dtype` picks the compute dtype (`compute_dtype`): float32, or bfloat16
with flax's mixed-precision semantics (models/layers.py).

`resolve_noise_schedule` (--noise_schedule) and `stack_batches` (the
[K, B, ...] dispatch batches of --steps_per_dispatch) are the counterparts
of maavss_tpu/train/setup.py:resolve_noise_schedule and make_stream's
`stacked`.

The numbers differ from a flax init with the same seed (different
generators); `convert.from_flax` carries a flax init across exactly.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.models.fusion import AVFusionModel, resolve_pgenc_kernel
from maavss_tpu_torch.models.fusion_frames import AVFusionFramesModel
from maavss_tpu_torch.models.layers import LSTM
from maavss_tpu_torch.train.state import TrainState, create_train_state

# flax's truncated_normal initializer rescales so the truncated
# distribution has the requested variance
_TRUNC_STD = 0.87962566103423978
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: RunConfig) -> torch.dtype:
    """The torch dtype of --dtype; any other than float32 and bfloat16
    raises NotImplementedError."""
    if cfg.dtype not in _DTYPES:
        raise NotImplementedError(
            f"--dtype {cfg.dtype} is not ported to maavss_tpu_torch yet "
            "(ROADMAP M5 (float16))")
    return _DTYPES[cfg.dtype]


def check_supported(cfg: RunConfig, train: bool = False) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for every option
    the port does not implement yet; `train=True` adds the train step's
    flags. Both families share them: the frames family's own options
    (--frames_encode, --frames_halo) are ported."""
    todo = [
        (cfg.rnn_cell != "lstm", f"--rnn_cell {cfg.rnn_cell}", "M2"),
        (cfg.compress_audio, "--compress_audio", "M9 (ops/audio.py)"),
        (cfg.attn_diff, "--attn_diff", "M4"),
        (cfg.dtype not in _DTYPES, f"--dtype {cfg.dtype}", "M5 (float16)"),
    ]
    if train:
        todo += [
            (cfg.remat, "--remat", "M3-rest"),
            (cfg.lr_schedule != "constant",
             f"--lr_schedule {cfg.lr_schedule}", "M3-rest (LR schedules)"),
            (cfg.fused_opt, "--fused_opt", "queue 1, 'Not carried'"),
        ]
    for missing, flag, item in todo:
        if missing:
            raise NotImplementedError(
                f"{flag} is not ported to maavss_tpu_torch yet (ROADMAP {item})")


def resolve_noise_schedule(cfg: RunConfig):
    """--noise_schedule: None (constant --noise_scalar, reference parity —
    av_dataset.py:217-220 applies a flat noise_std) or a step -> noise-std
    float over the run's total optimizer steps (a copy of
    maavss_tpu/train/setup.py:resolve_noise_schedule):

      linear:<start>:<end>   straight-line anneal start -> end
      cosine:<start>:<end>   half-cosine anneal start -> end

    The trainer evaluates it on the host once a dispatch, at the global
    step, and hands the value to the train step, which takes it as a 0-d
    device tensor (train/steps.py); eval and the separators keep
    cfg.noise_scalar."""
    spec = cfg.noise_schedule
    if not spec:
        return None
    try:
        kind, start_s, end_s = spec.split(":")
        start, end = float(start_s), float(end_s)
    except ValueError:
        raise SystemExit(
            f"bad --noise_schedule {spec!r}: want linear:<start>:<end> "
            "or cosine:<start>:<end>")
    total = max(cfg.epochs * cfg.steps_per_epoch - 1, 1)
    if kind == "linear":
        return lambda step: start + (end - start) * min(step, total) / total
    if kind == "cosine":
        return lambda step: end + (start - end) * 0.5 * (
            1.0 + math.cos(math.pi * min(step, total) / total))
    raise SystemExit(
        f"bad --noise_schedule {spec!r}: unknown kind {kind!r} "
        "(linear|cosine)")


def stack_batches(batches: Sequence[Mapping]) -> Dict:
    """K batches -> one dispatch batch, each leaf stacked on a new leading
    axis [K, B, ...] (make_stream's `stacked`,
    maavss_tpu/train/setup.py:320-325): numpy leaves (audio, uint8 frames,
    float16 phasegram rows) stay numpy in their dtype, tensor leaves are
    stacked with torch.stack."""
    keys = list(batches[0])
    if any(list(b) != keys for b in batches):
        raise ValueError("stack_batches: the batches hold different keys")
    out = {}
    for key in keys:
        leaves = [b[key] for b in batches]
        if any(isinstance(x, torch.Tensor) for x in leaves):
            out[key] = torch.stack([torch.as_tensor(x) for x in leaves])
        else:
            out[key] = np.stack([np.asarray(x) for x in leaves])
    return out


def _check_mask_head(cfg: RunConfig) -> None:
    """--mask_head multiplies rectangular features: the JAX builders refuse
    it with --use_polar, with this exit."""
    if cfg.mask_head and cfg.use_polar:
        raise SystemExit("--mask_head needs rectangular (re,im) STFT "
                         "features; drop --use_polar")


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
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d)):  # weight [out, in, k..]
            _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
        elif isinstance(mod, nn.Linear):
            _lecun_normal_(mod.weight, mod.in_features, generator)
        elif isinstance(mod, LSTM):
            bound = 1.0 / math.sqrt(mod.hidden)
            for w in (mod.w_i, mod.w_h):
                w.copy_(torch.empty(w.shape).uniform_(-bound, bound,
                                                      generator=generator))
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
    _check_mask_head(cfg)
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
        stft_fold=cfg.stft_fold, dtype=compute_dtype(cfg))
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


def build_frames_model(cfg: RunConfig, batch_size: int,
                       frame_size: Optional[int] = None,
                       latent_channels: int = 16, device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> AVFusionFramesModel:
    """The frames model for `cfg` (maavss_tpu/train/setup.py:262-281: the
    untrimmed STFT, F = fft_len/2 + 1; frames at `frame_size`, default
    cfg.framesize; latent width 16, the JAX function's default, not
    cfg.latent_chan), seeded-initialised as `build_fusion`, on `device`, in
    eval mode. With --mask_head the mask multiplies the middle frame of
    the window, (num_seq - 1) // 2, as the train step picks it."""
    _check_mask_head(cfg)
    check_supported(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    frame_size = frame_size or cfg.framesize
    t_stft = cfg.hops_per_frame * cfg.num_frames
    model = AVFusionFramesModel(
        stft_shape=(batch_size, 2, t_stft, cfg.fft_len // 2 + 1),
        frame_shape=(batch_size, 1, cfg.num_frames, frame_size, frame_size),
        hops_per_frame=cfg.hops_per_frame, latent_channels=latent_channels,
        rnn_cell=cfg.rnn_cell, mask_head=cfg.mask_head,
        mask_mid_frame=(cfg.num_seq - 1) // 2, dtype=compute_dtype(cfg))
    init_flax_like(model, generator)
    return model.to(device).eval()


def build_frames_state(cfg: RunConfig, batch_size: int,
                       frame_size: Optional[int] = None,
                       latent_channels: int = 16, device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[AVFusionFramesModel, TrainState]:
    """(frames model, train state) on `device`: `build_frames_model` and
    Adam with the --opt_kernel gate; the model is left in train mode."""
    check_supported(cfg, train=True)
    model = build_frames_model(cfg, batch_size, frame_size, latent_channels,
                               device, generator)
    return model, create_train_state(model, cfg, device)
