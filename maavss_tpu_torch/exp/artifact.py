"""Serving artifacts: load a `torch.export` program of the separator and
serve it (the load side of maavss_tpu/exp/export.py:160-189).

An artifact is `<name>.pt2`, written by `exp/export.save_artifact` with
`torch.export.save`, and its JSON sidecar `<name>.pt2.json`: the torch
version, the device the program was traced on and its name, the batch,
`frames_model`, `compute_dtype`, the input specs, the `GEOMETRY_FIELDS`,
each registered op in the graph with its count, and the keys and shapes of
the weights. The weights are the program's state: `load_artifact(...,
weights=)` copies a flax npz checkpoint of the same geometry into it, so
one artifact serves any checkpoint without being exported again.

A program traced on the card holds the hand-written kernels as registered
ops (ops/registry.py), whose only implementation is CUDA: it runs on CUDA
tensors and raises on CPU ones. One traced on the CPU holds the plain
versions. Nothing falls back from one to the other.

This module imports the op registry, the weight converter and torch, and
nothing of `models`, `train` or `exp/export.py`: a serving process loads
an artifact without the model's code.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

ARTIFACT_SUFFIX = ".pt2"
META_SUFFIX = ".json"
# the serving module holds the model under this name, so a program's state
# keys are the model's state_dict keys behind it
MODEL_PREFIX = "model."

# the run-config fields an artifact's checkpoint must agree on
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


def artifact_path(path: str) -> str:
    return path if path.endswith(ARTIFACT_SUFFIX) else path + ARTIFACT_SUFFIX


def graph_op_counts(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """{registered op name: calls in the program's graph}, the graphs of its
    higher-order ops (the no_grad region) included."""
    from maavss_tpu_torch.ops.registry import registered_op_name

    counts: Dict[str, int] = collections.Counter()
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                name = (registered_op_name(node.target)
                        if node.op == "call_function" else None)
                if name:
                    counts[name] += 1
    return dict(sorted(counts.items()))


def weight_shapes(program: torch.export.ExportedProgram
                  ) -> Dict[str, list]:
    """{model state_dict key: shape} of the program's weights."""
    return {k[len(MODEL_PREFIX):]: list(v.shape)
            for k, v in program.state_dict.items()}


def input_specs(meta: Dict[str, Any]) -> Tuple[TensorSpec, TensorSpec]:
    """(audio, visual) specs from a sidecar."""
    return (TensorSpec(tuple(meta["audio_shape"]), np.dtype(np.float32)),
            TensorSpec(tuple(meta["visual_shape"]),
                       np.dtype(meta["visual_dtype"])))


def check_geometry(meta: Dict[str, Any], cfg, path: str) -> None:
    """Raise ValueError where a sidecar's geometry differs from cfg's."""
    geometry = meta.get("geometry") or {}
    mismatches = {k: (geometry[k], getattr(cfg, k)) for k in GEOMETRY_FIELDS
                  if k in geometry and str(geometry[k]) != str(getattr(cfg, k))}
    if mismatches:
        raise ValueError(f"artifact geometry mismatch vs run config: "
                         f"{mismatches} (artifact: {path + META_SUFFIX})")


def load_weights(program: torch.export.ExportedProgram, weights: str) -> None:
    """Copy a flax npz checkpoint (convert.save_npz) into the program's
    weights, in place and strictly: a missing, extra or misshaped leaf
    raises ValueError and nothing is copied."""
    from maavss_tpu_torch.convert import from_flax, load_npz

    state = from_flax(*load_npz(weights))
    want = {k[len(MODEL_PREFIX):]: v for k, v in program.state_dict.items()}
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    misshaped = {k: (tuple(state[k].shape), tuple(v.shape))
                 for k, v in want.items()
                 if k in state and tuple(state[k].shape) != tuple(v.shape)}
    if missing or extra or misshaped:
        raise ValueError(f"weights {weights} do not fit the artifact: "
                         f"missing {missing}, unexpected {extra}, "
                         f"misshaped (file, artifact) {misshaped}")
    with torch.no_grad():
        for k, v in want.items():
            v.copy_(state[k])


def load_artifact(path: str, cfg=None, weights: Optional[str] = None
                  ) -> Tuple[torch.export.ExportedProgram, Dict[str, Any]]:
    """(program, sidecar) of an exported separator. With `cfg`, the
    sidecar's geometry is checked against it first (ValueError on a
    mismatch); with `weights`, a flax npz checkpoint is loaded into the
    program strictly (`load_weights`), before any call."""
    from maavss_tpu_torch.ops import registry  # noqa: F401 (the graph's ops)

    path = artifact_path(path)
    meta: Dict[str, Any] = {}
    if os.path.exists(path + META_SUFFIX):
        with open(path + META_SUFFIX) as f:
            meta = json.load(f)
    if cfg is not None:
        check_geometry(meta, cfg, path)
    program = torch.export.load(path)
    if weights:
        load_weights(program, weights)
    return program, meta


def artifact_serving_fn(program: torch.export.ExportedProgram):
    """`fn(audio, visual) -> audio_out`: the program's module called under
    torch.inference_mode(), on tensors on the device it was traced on."""
    module = program.module()

    @torch.inference_mode()
    def serving_fn(audio: torch.Tensor, visual: torch.Tensor) -> torch.Tensor:
        return module(audio, visual)

    return serving_fn
