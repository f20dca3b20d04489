"""Serving function and its input specs (counterpart of
maavss_tpu/exp/export.py: make_serving_fn, serving_input_specs,
random_serving_inputs).

The serving function receives the mixture directly (noise_scalar forced to
0) and returns only the separated waveform. It closes over the model, whose
weights live on its device; there is no exported artifact yet (a
`torch.export` artifact is ROADMAP M10). `serving_info` is what the JAX
package's artifact sidecar records (maavss_tpu/exp/export.py:135-150), the
compute dtype among it; the daemon serves it on /healthz.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.train.infer import separate_frames_windows, separate_windows
from maavss_tpu_torch.train.setup import check_supported


# the run-config fields the JAX artifact's sidecar records
# (maavss_tpu/exp/export.py:43-49)
GEOMETRY_FIELDS = (
    "fft_len", "hop", "hops_per_frame", "num_frames", "num_seq", "p_size",
    "framesize", "samplerate", "latent_chan", "fc_size", "use_polar",
    "normalize_fft", "normalize_output_fft", "mask_head", "rnn_cell",
    "pgram_cache", "frames_encode", "fusion_encode",
)


class TensorSpec(NamedTuple):
    """Shape and numpy dtype of one serving input (jax.ShapeDtypeStruct's
    role in the JAX package)."""

    shape: Tuple[int, ...]
    dtype: np.dtype


def make_serving_fn(model, cfg: RunConfig, frames_model: bool = False):
    """Mixture in, separated audio out: fn(audio [B, S_total], visual) ->
    [B, S_total], tensors on the model's device; visual is frames
    [B, T_total, p, p] for the fusion model, or its float16 phasegram rows
    [B, T_total, p^2] under --pgram_cache, and raw uint8 frames
    [B, T_total, framesize, framesize] for the frames model."""
    serve_cfg = cfg.replace(noise_scalar=0.0)
    check_supported(serve_cfg)
    windows = separate_frames_windows if frames_model else separate_windows
    visual_key = "pgram" if (cfg.pgram_cache and not frames_model) \
        else "frames"

    @torch.inference_mode()
    def serving_fn(audio: torch.Tensor, visual: torch.Tensor) -> torch.Tensor:
        out, _ = windows(model, serve_cfg, {"audio": audio,
                                            visual_key: visual})
        return out

    return serving_fn


def serving_input_specs(cfg: RunConfig, batch: int, frames_model: bool = False
                        ) -> Tuple[TensorSpec, TensorSpec]:
    """(audio, visual) specs at the sweep's clip geometry: float32 audio;
    float32 frames in [0, 1] for the fusion model, or float16 phasegram
    rows [batch, T_total, p^2] under --pgram_cache, and uint8 frames at
    framesize for the frames model (its wire format, converted on the
    device, maavss_tpu/exp/export.py:83-92)."""
    check_supported(cfg)
    t_total = cfg.num_frames + cfg.num_seq
    s_total = cfg.hop * cfg.hops_per_frame * t_total
    audio = TensorSpec((batch, s_total), np.dtype(np.float32))
    if frames_model:
        return audio, TensorSpec((batch, t_total, cfg.framesize,
                                  cfg.framesize), np.dtype(np.uint8))
    if cfg.pgram_cache:
        return audio, TensorSpec((batch, t_total, cfg.p_size * cfg.p_size),
                                 np.dtype(np.float16))
    return audio, TensorSpec((batch, t_total, cfg.p_size, cfg.p_size),
                             np.dtype(np.float32))


def serving_info(cfg: RunConfig, batch: int, frames_model: bool = False
                 ) -> Dict[str, Any]:
    """The served model's description: batch, compute dtype, the input
    specs and the geometry flags the JAX sidecar keeps."""
    audio, visual = serving_input_specs(cfg, batch, frames_model)
    return {"batch": int(batch), "frames_model": bool(frames_model),
            "compute_dtype": cfg.dtype,
            "audio_shape": list(audio.shape),
            "visual_shape": list(visual.shape),
            "visual_dtype": str(visual.dtype),
            "geometry": {k: getattr(cfg, k) for k in GEOMETRY_FIELDS}}


def random_serving_inputs(cfg: RunConfig, batch: int,
                          frames_model: bool = False, seed: int = 0):
    """(audio, visual) numpy payloads at the serving specs, the same draws
    as the JAX package's random_serving_inputs: uint8 frames over [0, 255],
    float ones small gaussians."""
    a_spec, v_spec = serving_input_specs(cfg, batch, frames_model)
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal(a_spec.shape) * 0.1).astype(a_spec.dtype)
    if np.issubdtype(v_spec.dtype, np.integer):
        visual = rng.integers(0, 256, v_spec.shape).astype(v_spec.dtype)
    else:
        visual = (rng.standard_normal(v_spec.shape) * 0.1).astype(
            v_spec.dtype)
    return audio, visual
