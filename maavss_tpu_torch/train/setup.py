"""Model construction (counterpart of maavss_tpu/train/setup.py:build_fusion
and build_frames_model).

`build_fusion(cfg, batch_size, device="cuda", generator)` plans the fusion
model from the run config, initialises it from an explicit `torch.Generator`
with flax's distributions, and returns it on `device` in eval mode;
`build_fusion_state` also returns its `TrainState` (the JAX `build_fusion`'s
pair). `build_frames_model` / `build_frames_state` do the same for the frames
model. The initialisation:

- conv (1-D to 3-D), transposed-conv (2-D and 3-D) and dense kernels:
  lecun-normal
  (variance 1/fan_in, normal truncated at two standard deviations, flax's
  rescaled stddev); biases zero;
- LSTM and GRU w_i / w_h: U(-1/sqrt(H), 1/sqrt(H)), drawn in fp32 and
  rounded to the parameters' dtype, so a bfloat16 model holds its float32
  twin's weights rounded;
- BatchNorm: scale 1, bias 0, running mean 0, running variance 1.

`--dtype` picks the compute dtype (`compute_dtype`): float32, or bfloat16
with flax's mixed-precision semantics (models/layers.py).

`resolve_noise_schedule` (--noise_schedule) and `stack_batches` (the
[K, B, ...] dispatch batches of --steps_per_dispatch) are the counterparts
of maavss_tpu/train/setup.py:resolve_noise_schedule and make_stream's
`stacked`. The data plumbing of the entry tools, `resolve_data_root`,
`load_stores`, `load_pgram_store`, `make_stream` and `run_name`, is that of
maavss_tpu/train/setup.py:63-122, 284-318 and 352-355, with its exits word
for word.

The numbers differ from a flax init with the same seed (different
generators); `convert.from_flax` carries a flax init across exactly.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.data.audio_memmap import AudioMemmap
from maavss_tpu_torch.data.dataset import AVDataset, Subset, batches, prefetch
from maavss_tpu_torch.data.frame_shards import FrameShardStore
from maavss_tpu_torch.models.fusion import AVFusionModel, resolve_pgenc_kernel
from maavss_tpu_torch.models.fusion_frames import AVFusionFramesModel
from maavss_tpu_torch.models.layers import GRU, LSTM
from maavss_tpu_torch.train.state import TrainState, create_train_state

# the staged AV stage's trainable subnets (train_av_net.py: the fusion
# core and heads; both autoencoders frozen)
FUSION_SUBNETS = ("lstm", "fc1", "fc2", "a_fc1", "v_fc1")

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
    (--frames_encode, --frames_halo) are ported, and so are --rnn_cell
    gru|none, --attn_diff, --compress_audio and --remat."""
    todo = [
        (cfg.dtype not in _DTYPES, f"--dtype {cfg.dtype}", "M5 (float16)"),
    ]
    if train:
        todo += [
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
        if isinstance(mod, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
            # weight [in, out, k..]
            _lecun_normal_(mod.weight, mod.weight.shape[0]
                           * math.prod(mod.kernel_size), generator)
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            # weight [out, in, k..]
            _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
        elif isinstance(mod, nn.Linear):
            _lecun_normal_(mod.weight, mod.in_features, generator)
        elif isinstance(mod, (LSTM, GRU)):
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
                       generator: Optional[torch.Generator] = None,
                       trainable: Optional[Sequence[str]] = None,
                       optimizer: str = "adam"
                       ) -> Tuple[AVFusionModel, TrainState]:
    """(model, train state) for `cfg` on `device`: `build_fusion` and the
    optimizer (adam, sgd or adamw) with the --opt_kernel gate, every leaf
    trainable or, with `trainable` (top-level module prefixes, e.g.
    FUSION_SUBNETS), those alone (maavss_tpu/train/setup.py:238-259); the
    model is left in train mode."""
    check_supported(cfg, train=True)
    model = build_fusion(cfg, batch_size, device, generator)
    return model, create_train_state(model, cfg, device, optimizer,
                                     trainable)


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


def resolve_data_root(cfg: RunConfig) -> str:
    """The on-disk store root for cfg.data_path ('synthetic[:N]' resolves to
    its per-geometry fixture directory)."""
    if cfg.data_path.startswith("synthetic"):
        return os.path.join("data", f"synthetic-p{cfg.p_size}")
    return cfg.data_path


def load_stores(cfg: RunConfig, frames_dir: str = "frames",
                audio_dir: str = "audio",
                ) -> Tuple[Optional[FrameShardStore], Optional[AudioMemmap]]:
    """Open the ingested data stores under cfg.data_path.

    `--data_path synthetic[:N]` builds an on-the-fly synthetic store (no
    MUSICES download needed) under ./data/synthetic-p<p_size>, N videos
    (default 4) of 2 s, frames at p_size: the CI/smoke path.
    """
    if cfg.autocontrast:
        # the reference applies autocontrast inside its on-the-fly attention
        # extraction (av_dataset.py:318-319); here attention is precomputed
        # offline, so a train-time flag would silently do nothing
        raise SystemExit(
            "--autocontrast acts during attention extraction, which happens "
            "at ingest here: pass it to save_attn_videos.py instead")
    if cfg.data_path.startswith("synthetic"):
        from maavss_tpu_torch.data.synthetic import build_synthetic_store

        n = int(cfg.data_path.split(":", 1)[1]) if ":" in cfg.data_path else 4
        # one store per frame size so geometry changes never alias
        out = resolve_data_root(cfg)
        frames_path = os.path.join(out, "frames")
        audio_path = os.path.join(out, "audio")
        if not os.path.exists(os.path.join(frames_path, "meta.json")):
            build_synthetic_store(out, cfg, n_videos=n, seconds=2.0,
                                  frame_size=cfg.p_size)
        return FrameShardStore(frames_path), AudioMemmap(audio_path)

    frames_path = os.path.join(cfg.data_path, frames_dir)
    audio_path = os.path.join(cfg.data_path, audio_dir)
    frames = FrameShardStore(frames_path) if os.path.isdir(frames_path) else None
    audio = AudioMemmap(audio_path) if os.path.isdir(audio_path) else None
    if frames is None and audio is None:
        raise SystemExit(
            f"no ingested data under {cfg.data_path} (expected {frames_dir}/ "
            f"and {audio_dir}/ from tools/ingest.py) — or pass "
            f"--data_path synthetic for the built-in fixture dataset")
    return frames, audio


def load_pgram_store(cfg: RunConfig) -> Optional[FrameShardStore]:
    """Open the precomputed-phasegram shard store when --pgram_cache is set
    (fusion regimes; build with tools/save_phasegrams_torch.py, or the JAX
    package's save_phasegrams.py: the same layout). None when the flag is
    off; a clear SystemExit when the flag is set but the store is
    missing, JAX's message naming the port's tool."""
    if not cfg.pgram_cache:
        return None
    d = os.path.join(resolve_data_root(cfg), f"pgrams-p{cfg.p_size}")
    if not os.path.exists(os.path.join(d, "meta.json")):
        raise SystemExit(
            f"--pgram_cache set but no store at {d} — build it once with: "
            f"python tools/save_phasegrams_torch.py --data_path "
            f"{cfg.data_path} --p_size {cfg.p_size}")
    return FrameShardStore(d)


def make_stream(cfg: RunConfig, dataset, indices=None, seed: int = 0,
                stack: int = 1):
    """Batch stream for a train/val split (maavss_tpu/train/setup.py:
    make_stream, without its mesh, ROADMAP M11): the Python pipeline,
    `batches` in a `prefetch` thread that only builds numpy batches (the
    steps copy them to the device on the main thread). `stack > 1` groups
    that many consecutive batches into one [K, B, ...] dispatch batch
    (`stack_batches`, --steps_per_dispatch). --native_loader on an AV
    dataset, where the JAX package takes its C++ loader, raises."""
    if cfg.native_loader and isinstance(dataset, AVDataset) \
            and dataset.mode == "av":
        raise NotImplementedError(
            "--native_loader is not ported to maavss_tpu_torch yet (ROADMAP "
            "M6-rest (native loader))")
    ds = dataset if indices is None else Subset(dataset, indices)
    it = prefetch(batches(ds, cfg.batch_size, seed=seed))
    if stack > 1:
        def stacked(src):
            while True:
                yield stack_batches([next(src) for _ in range(stack)])
        it = stacked(it)
    return it


def run_name(prefix: str, cfg: RunConfig) -> str:
    return f"{prefix}-{time.strftime('%Y%m%d-%H%M%S')}-s{cfg.seed}"
