"""Serving function and its input specs (counterpart of
maavss_tpu/exp/export.py: make_serving_fn, serving_input_specs,
random_serving_inputs).

The serving function receives the mixture directly (noise_scalar forced to
0) and returns only the separated waveform. It closes over the model, whose
weights live on its device; there is no exported artifact yet (a
`torch.export` artifact is ROADMAP M10).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.train.infer import separate_windows
from maavss_tpu_torch.train.setup import check_supported


class TensorSpec(NamedTuple):
    """Shape and numpy dtype of one serving input (jax.ShapeDtypeStruct's
    role in the JAX package)."""

    shape: Tuple[int, ...]
    dtype: np.dtype


def make_serving_fn(model, cfg: RunConfig):
    """Mixture in, separated audio out: fn(audio [B, S_total],
    visual [B, T_total, p, p]) -> [B, S_total], tensors on the model's
    device. The fusion model only (the frames model is ROADMAP M7)."""
    serve_cfg = cfg.replace(noise_scalar=0.0)
    check_supported(serve_cfg)

    @torch.inference_mode()
    def serving_fn(audio: torch.Tensor, visual: torch.Tensor) -> torch.Tensor:
        out, _ = separate_windows(model, serve_cfg, audio, visual)
        return out

    return serving_fn


def serving_input_specs(cfg: RunConfig, batch: int
                        ) -> Tuple[TensorSpec, TensorSpec]:
    """(audio, visual) specs at the sweep's clip geometry: float32 audio
    and float32 frames in [0, 1] (the fusion model's wire)."""
    check_supported(cfg)
    t_total = cfg.num_frames + cfg.num_seq
    s_total = cfg.hop * cfg.hops_per_frame * t_total
    return (TensorSpec((batch, s_total), np.dtype(np.float32)),
            TensorSpec((batch, t_total, cfg.p_size, cfg.p_size),
                       np.dtype(np.float32)))


def random_serving_inputs(cfg: RunConfig, batch: int, seed: int = 0):
    """(audio, visual) numpy payloads at the serving specs; the same draws
    as the JAX package's random_serving_inputs for the fusion model."""
    a_spec, v_spec = serving_input_specs(cfg, batch)
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal(a_spec.shape) * 0.1).astype(a_spec.dtype)
    visual = (rng.standard_normal(v_spec.shape) * 0.1).astype(v_spec.dtype)
    return audio, visual
