"""Serving function, its input specs and its `torch.export` artifact
(counterpart of maavss_tpu/exp/export.py: make_serving_fn,
serving_input_specs, random_serving_inputs, export_separator,
save_artifact; the load side is exp/artifact.py).

The serving function receives the mixture directly (noise_scalar forced to
0) and returns only the separated waveform: `ServingModule`, the windowed
separator of either family in eval mode under torch.no_grad.
`export_separator` traces it with `torch.export` at a pinned batch into an
ExportedProgram whose state is the model's weights. The kernel gates
resolve at trace time, as the JAX module says of its own: a program traced
on the card carries the hand-written kernels as registered ops
(ops/registry.py) and runs on the card alone; one traced on the CPU
carries the plain versions. `save_artifact` writes it with its JSON
sidecar (exp/artifact.py); `serving_info` is the sidecar's description of
the served model, the compute dtype among it, which the daemon serves on
/healthz.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.exp.artifact import (  # noqa: F401 (re-exported)
    GEOMETRY_FIELDS,
    META_SUFFIX,
    TensorSpec,
    artifact_path,
    graph_op_counts,
    load_artifact,
    weight_shapes,
)
from maavss_tpu_torch.train.infer import separate_frames_windows, separate_windows
from maavss_tpu_torch.train.setup import check_supported


class ServingModule(torch.nn.Module):
    """(audio [B, S_total], visual) -> separated audio [B, S_total]: the
    windowed separator of `model` (held as `self.model`) with noise_scalar
    0, under torch.no_grad; the separators run the model in eval mode."""

    def __init__(self, model: torch.nn.Module, cfg: RunConfig,
                 frames_model: bool = False):
        super().__init__()
        self.model = model
        self.cfg = cfg.replace(noise_scalar=0.0)
        check_supported(self.cfg)
        self.windows = (separate_frames_windows if frames_model
                        else separate_windows)
        self.visual_key = ("pgram" if (cfg.pgram_cache and not frames_model)
                           else "frames")

    def forward(self, audio: torch.Tensor, visual: torch.Tensor
                ) -> torch.Tensor:
        with torch.no_grad():
            out, _ = self.windows(self.model, self.cfg,
                                  {"audio": audio, self.visual_key: visual})
        return out


def make_serving_fn(model, cfg: RunConfig, frames_model: bool = False):
    """Mixture in, separated audio out: fn(audio [B, S_total], visual) ->
    [B, S_total], tensors on the model's device; visual is frames
    [B, T_total, p, p] for the fusion model, or its float16 phasegram rows
    [B, T_total, p^2] under --pgram_cache, and raw uint8 frames
    [B, T_total, framesize, framesize] for the frames model."""
    module = ServingModule(model, cfg, frames_model)

    @torch.inference_mode()
    def serving_fn(audio: torch.Tensor, visual: torch.Tensor) -> torch.Tensor:
        return module(audio, visual)

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


def export_separator(model: torch.nn.Module, cfg: RunConfig, batch: int,
                     frames_model: bool = False
                     ) -> torch.export.ExportedProgram:
    """`ServingModule(model, ...)` traced by torch.export (non-strict) on
    inputs at `serving_input_specs(cfg, batch, frames_model)`, the batch
    pinned, on the model's device; the model is left in the mode it had."""
    a_spec, v_spec = serving_input_specs(cfg, batch, frames_model)
    device = next(model.parameters()).device
    audio = torch.zeros(a_spec.shape, dtype=torch.float32, device=device)
    visual = torch.zeros(v_spec.shape, device=device,
                         dtype=getattr(torch, v_spec.dtype.name))
    was_training = model.training
    module = ServingModule(model.eval(), cfg, frames_model)
    try:
        return torch.export.export(module, (audio, visual), strict=False)
    finally:
        model.train(was_training)


def save_artifact(path: str, program: torch.export.ExportedProgram,
                  cfg: RunConfig, batch: int, frames_model: bool = False
                  ) -> str:
    """Write `<path>.pt2` (torch.export.save) and its JSON sidecar
    (exp/artifact.py); returns the artifact's path."""
    path = artifact_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    device = next(iter(program.state_dict.values())).device
    meta = {
        "torch_version": torch.__version__,
        "device": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        **serving_info(cfg, batch, frames_model),
        "ops": graph_op_counts(program),
        "weights": weight_shapes(program),
    }
    with open(path + META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=1)
    return path
