"""Separation + SI-SDR evaluation (counterpart of
maavss_tpu/train/infer.py:make_separator and make_frames_separator, window
mode and --fusion_encode / --frames_encode full).

The fusion separator runs the fusion model over every sliding window of a
clip (a Python loop in place of `lax.scan`), overlap-averages the predicted
STFT on the shared hops, and resynthesizes audio through the exact-inverse
iSTFT. Under --fusion_encode full both encoders run once over the clip's
span and the heads once over its B * num_seq latent windows, as the
full-encode train step does; the overlap-average is the same. The visual
input is frames or, where the batch holds `pgram`, precomputed phasegram
rows (--pgram_cache). The frames separator runs the frames model over every
window and writes each window's predicted middle-frame columns into the
mixture's untrimmed spectrogram (columns no window predicts keep the
mixture), then resynthesizes; under --frames_encode full its visual trunk
runs once over the clip's frames, as the full-encode train step's does. Feature preparation is the train step's
`_prep_stft_pair`, as in the JAX package; under --use_polar the features
are (magnitude, phase), averaged and stitched as such, and resynthesized
through the polar kernel. The visual input is `_vis_frames` (their
temporal difference under --attn_diff). Under --compress_audio the model
sees the compressed clip's features while the SI-SDR reference stays
`batch['audio']`, uncompressed, as in the JAX package
(maavss_tpu/train/infer.py:90, 197). Under --dtype bfloat16 or float16 the
model's outputs are cast to the features' fp32 before the overlap-add or the
stitch, so the average, the polar kernel and the iSTFT run in fp32
(maavss_tpu/train/infer.py:67,77,161).

Under a mesh (parallel/) each rank separates its rows of the global batch
(`parallel.mesh.shard_batch`) on its shards of the model: the phasegram's
max-norm is the global batch's (ops/phasegram.py), the split heads are
column-parallel (models/layers.py:dense), and the input noise is each
row's draw from one global draw (train/steps.py:_noisy), so that every
row's audio is the one-process separator's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.ops.metrics import si_sdr
from maavss_tpu_torch.ops.phasegram import phasegram_window
from maavss_tpu_torch.ops.stft import istft_features
from maavss_tpu_torch.train.setup import check_supported
from maavss_tpu_torch.train.steps import (
    _fusion_full_geometry,
    _pflat_from_batch,
    _prep_stft_pair,
    _vis_frames,
    _windows,
)


def separate_windows(model, cfg: RunConfig, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch = {'audio': [B, S], 'frames': [B, T_total, H, W] float in
    [0, 1] or 'pgram': [B, T_total, p^2] phasegram rows} ->
    (separated audio [B, S],
    the model's input features x_full [B, 2, T, F]).

    x_full is the clean STFT plus noise_scalar-scaled gaussian noise drawn
    from `generator` (required when noise_scalar != 0). The model runs in
    eval mode (its mode is restored afterwards), as the JAX separator
    applies it with train=False."""
    a, nf, ns = cfg.hops_per_frame, cfg.num_frames, cfg.num_seq
    audio = batch["audio"]
    x_full, y_full = _prep_stft_pair(audio, cfg, generator, trim_end=True,
                                     max_norm=cfg.normalize_output_fft)
    p_flat = _pflat_from_batch(batch, cfg)

    t_total = y_full.shape[2]
    acc = torch.zeros_like(y_full)
    cnt = torch.zeros(t_total, dtype=y_full.dtype, device=y_full.device)
    was_training = model.training
    model.eval()
    try:
        if cfg.fusion_encode == "full":
            hop_a, hop_v, t_win = _fusion_full_geometry(model, cfg)
            a_lat, v_lat = model.encode_both(
                x_full[:, :, :(nf + ns - 1) * a],
                phasegram_window(p_flat[:, :nf + ns - 1]))
            yh_b, _, _ = model.heads_from_latents(
                _windows(a_lat, ns, hop_a, t_win),
                _windows(v_lat, ns, hop_v, t_win),
                _windows(x_full, ns, a, nf * a))
            yh_wins = yh_b.reshape((-1, ns) + yh_b.shape[1:]).unbind(1)
        else:
            yh_wins = (model(x_full[:, :, j * a:(j + nf) * a],
                             phasegram_window(p_flat[:, j:j + nf]))[0]
                       for j in range(ns))
        for j, yh in enumerate(yh_wins):
            win = slice(j * a, (j + nf) * a)
            acc[:, :, win] += yh.to(acc.dtype)
            cnt[win] += 1.0
    finally:
        model.train(was_training)
    yh_full = acc / torch.clamp(cnt, min=1.0)[:, None]
    yh_audio = istft_features(yh_full, cfg.fft_len, cfg.hop,
                              normalized=cfg.normalize_fft, trim_end=True,
                              polar=cfg.use_polar, length=audio.shape[-1])
    return yh_audio, x_full


def separate_frames_windows(model, cfg: RunConfig,
                            batch: Dict[str, torch.Tensor],
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch = {'audio': [B, S], 'frames': raw frames [B, T_total, H, W]
    (uint8, or float in [0, 1])} -> (separated audio [B, S], the model's
    input features x_full [B, 2, T, F], F = fft_len/2 + 1). The model runs
    in eval mode (its mode is restored afterwards), as the JAX separator
    applies it with train=False. Under --frames_encode full the visual
    trunk runs once over all T_total frames of the request and window j
    reads latent frames j .. j + num_frames (served clips carry no halo),
    as maavss_tpu/train/infer.py:53-67 does."""
    a, nf, ns = cfg.hops_per_frame, cfg.num_frames, cfg.num_seq
    mid = (ns - 1) // 2
    audio = batch["audio"]
    x_full, _ = _prep_stft_pair(audio, cfg, generator, trim_end=False,
                                max_norm=cfg.normalize_output_fft)
    frames = _vis_frames(batch, cfg).unsqueeze(2)  # [B,T,1,H,W]
    yh_full = x_full.clone()
    was_training = model.training
    model.eval()
    try:
        if cfg.frames_encode == "full":
            v_lat = model.encode_frames(frames.transpose(1, 2))  # [B,C,T,S]
        for j in range(ns):
            xs = x_full[:, :, j * a:(j + nf) * a]
            if cfg.frames_encode == "full":
                yh_mid, _, _ = model.forward_with_visual_latent(
                    xs, v_lat[:, :, j:j + nf])
            else:
                x_v = frames[:, j:j + nf].transpose(1, 2)  # [B,1,nf,H,W]
                yh_mid, _, _ = model(xs, x_v)
            yh_full[:, :, (j + mid) * a:(j + mid + 1) * a] = yh_mid.to(
                yh_full.dtype)
    finally:
        model.train(was_training)
    yh_audio = istft_features(yh_full, cfg.fft_len, cfg.hop,
                              normalized=cfg.normalize_fft, trim_end=False,
                              polar=cfg.use_polar, length=audio.shape[-1])
    return yh_audio, x_full


def _input_audio(cfg: RunConfig, x_full: torch.Tensor, length: int,
                 frames_model: bool) -> torch.Tensor:
    """The separator's noisy input features resynthesized: the audio its
    `si_sdr_noisy` scores."""
    return istft_features(x_full, cfg.fft_len, cfg.hop,
                          normalized=cfg.normalize_fft,
                          trim_end=not frames_model, polar=cfg.use_polar,
                          length=length)


def noisy_si_sdr(cfg: RunConfig, audio: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 frames_model: bool = False) -> torch.Tensor:
    """The separator's `si_sdr_noisy` [B] of `audio` [B, S] without a
    model: the input features drawn from `generator` as the separator
    draws them, resynthesized and scored against `audio`. It does not
    depend on the weights (the eval anchor of
    tools/quality_curve_torch.py)."""
    x_full, _ = _prep_stft_pair(audio, cfg, generator,
                                trim_end=not frames_model,
                                max_norm=cfg.normalize_output_fft)
    return si_sdr(_input_audio(cfg, x_full, audio.shape[-1], frames_model),
                  audio)


def make_separator(model, cfg: RunConfig, frames_model: bool = False):
    """`separate(batch, generator=None) -> dict` over batch =
    {'audio': [B, S_total], 'frames': [B, T_total, p, p]} tensors on the
    model's device ('pgram': [B, T_total, p^2] phasegram rows in place of
    the frames; raw [B, T_total, H, W] frames for the frames model);
    returns audio_out, audio_in, si_sdr, si_sdr_noisy and si_sdr_gain like
    the JAX separator."""
    check_supported(cfg)
    windows = separate_frames_windows if frames_model else separate_windows

    @torch.inference_mode()
    def separate(batch, generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
        audio = batch["audio"]
        yh_audio, x_full = windows(model, cfg, batch, generator)
        x_audio = _input_audio(cfg, x_full, audio.shape[-1], frames_model)
        sdr_out = si_sdr(yh_audio, audio)
        sdr_in = si_sdr(x_audio, audio)
        return {"audio_out": yh_audio, "audio_in": x_audio,
                "si_sdr": sdr_out, "si_sdr_noisy": sdr_in,
                "si_sdr_gain": sdr_out - sdr_in}

    return separate


def make_frames_separator(model, cfg: RunConfig):
    """The frames model's separator (maavss_tpu/train/infer.py:26-96):
    `make_separator(model, cfg, frames_model=True)`."""
    return make_separator(model, cfg, frames_model=True)
