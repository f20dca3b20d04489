"""Weights across frameworks: a flax variable tree (as numpy) -> the port's
`state_dict` (`from_flax`) and back (`to_flax`), and an npz file format for
flax trees.

Works on numpy trees only, so a process without jax can load weights that a
JAX process saved with `save_npz`. Mapping (generalised from
benchmarks/torch_baseline.py:89-148), path component by component:

- `Conv_i/kernel` [kh,kw,in,out] -> `Conv_i.weight` [out,in,kh,kw]; a
  conv3d kernel [kd,kh,kw,in,out] -> [out,in,kd,kh,kw] (the frames model's
  visual encoder)
- `ConvTranspose_i/kernel` [kh,kw,in,out] -> spatially flipped,
  `ConvTranspose_i.weight` [in,out,kh,kw] (flax's ConvTranspose is a conv of
  the dilated input with the unflipped kernel)
- Dense `kernel` [in,out] -> `weight` [out,in]
- `BatchNorm_0/scale|bias` -> `BatchNorm_0.weight|bias`; batch_stats
  `mean|var` -> `running_mean|running_var`
- LSTM `w_i` [D,4H] / `w_h` [H,4H] are kept in flax's layout: the recurrence
  kernel reads w_h as [H,4H], row k holding the four gates' weights of h[k];
  so are the GRU's (--rnn_cell gru) `w_i` [D,3H] / `w_h` [H,3H], gate
  columns (r, z, n); the ParallelMixer's (--rnn_cell none)
  `lstm/Dense_0/kernel` is a Dense kernel like any other
- every `bias` maps 1:1

The phasegram kernel stack's w2 [Co, 9*Cin] is not stored: the module
derives it from `Conv_i.weight` per call, with column k*Cin + ci, the order
maavss_tpu/models/layers.py:205-207 builds from the flax kernel.

Arrays are float32 on the numpy side: numpy has no bfloat16, so a
bfloat16 leaf (the LSTM's w_i and w_h under --dtype bfloat16) crosses as
its exact float32 upcast: `load_state_dict` casts it back to the
parameter's dtype (exact, for values a bfloat16 holds), and `to_flax`
upcasts such leaves to float32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Tree = Mapping[str, object]


def flatten_tree(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': array}."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, object]:
    tree: Dict[str, object] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_npz(path: str, params: Tree, batch_stats: Optional[Tree] = None) -> None:
    """Write a flax (params, batch_stats) pair as one npz of '/' keys."""
    arrays = {f"params/{k}": v for k, v in flatten_tree(params).items()}
    arrays.update({f"batch_stats/{k}": v
                   for k, v in flatten_tree(batch_stats or {}).items()})
    np.savez(path, **arrays)


def load_npz(path: str) -> Tuple[Dict[str, object], Dict[str, object]]:
    """Read what `save_npz` wrote -> (params, batch_stats) numpy trees."""
    parts: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "batch_stats": {}}
    with np.load(path) as z:
        for key in z.files:
            top, rest = key.split("/", 1)
            if top not in parts:
                raise ValueError(f"{path}: unexpected top-level key {top!r}")
            parts[top][rest] = z[key]
    return unflatten_tree(parts["params"]), unflatten_tree(parts["batch_stats"])


def _param_leaf(parts, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """(torch leaf name, torch-layout value) for one flax param leaf."""
    parent, leaf = parts[-2] if len(parts) > 1 else "", parts[-1]
    if leaf == "kernel":
        if parent.startswith("ConvTranspose_"):
            return "weight", value[::-1, ::-1].transpose(2, 3, 0, 1)
        if parent.startswith("Conv_"):
            spatial = tuple(range(value.ndim - 2))
            return "weight", value.transpose(
                (value.ndim - 1, value.ndim - 2) + spatial)
        if value.ndim == 2:  # Dense
            return "weight", value.T
        raise ValueError(f"unmapped kernel {'/'.join(parts)} {value.shape}")
    if leaf == "scale":
        return "weight", value
    if leaf in ("bias", "w_i", "w_h"):
        return leaf, value
    raise ValueError(f"unmapped flax param {'/'.join(parts)}")


_STATS = {"mean": "running_mean", "var": "running_var"}


def from_flax(params: Tree, batch_stats: Optional[Tree] = None
              ) -> Dict[str, torch.Tensor]:
    """flax numpy trees -> a state_dict for the port's modules (CPU tensors;
    `load_state_dict` copies them to the model's device)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in flatten_tree(params).items():
        parts = path.split("/")
        name, arr = _param_leaf(parts, value)
        out[".".join(parts[:-1] + [name])] = torch.tensor(
            np.ascontiguousarray(arr, dtype=np.float32))
    for path, value in flatten_tree(batch_stats or {}).items():
        parts = path.split("/")
        if parts[-1] not in _STATS:
            raise ValueError(f"unmapped flax batch_stats leaf {path}")
        out[".".join(parts[:-1] + [_STATS[parts[-1]]])] = torch.tensor(
            np.ascontiguousarray(value, dtype=np.float32))
    return out


def _flax_leaf(parts, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """(flax leaf name, flax-layout value) for one torch param leaf: the
    inverse of `_param_leaf`."""
    parent, leaf = parts[-2] if len(parts) > 1 else "", parts[-1]
    if leaf == "weight":
        if parent.startswith("ConvTranspose_"):
            return "kernel", value.transpose(2, 3, 0, 1)[::-1, ::-1]
        if parent.startswith("Conv_"):
            spatial = tuple(range(2, value.ndim))
            return "kernel", value.transpose(spatial + (1, 0))
        if parent == "BatchNorm_0":
            return "scale", value
        if value.ndim == 2:  # Dense
            return "kernel", value.T
        raise ValueError(f"unmapped weight {'.'.join(parts)} {value.shape}")
    if leaf in ("bias", "w_i", "w_h"):
        return leaf, value
    raise ValueError(f"unmapped torch param {'.'.join(parts)}")


def to_flax(state_dict: Mapping[str, torch.Tensor]
            ) -> Tuple[Dict[str, object], Dict[str, object]]:
    """A state_dict of the port's modules -> flax (params, batch_stats)
    numpy trees, the inverse of `from_flax`; a bfloat16 leaf becomes its
    float32 upcast (a copy), a float32 leaf shares the tensor's memory on
    the CPU."""
    stats = {v: k for k, v in _STATS.items()}
    params: Dict[str, np.ndarray] = {}
    batch_stats: Dict[str, np.ndarray] = {}
    for name, tensor in state_dict.items():
        parts = name.split(".")
        value = tensor.detach().cpu().float().numpy()
        if parts[-1] in stats:
            batch_stats["/".join(parts[:-1] + [stats[parts[-1]]])] = value
            continue
        leaf, arr = _flax_leaf(parts, value)
        params["/".join(parts[:-1] + [leaf])] = np.ascontiguousarray(arr)
    return unflatten_tree(params), unflatten_tree(batch_stats)


def random_flax_tree(shapes: Mapping[str, Tuple[int, ...]], seed: int
                     ) -> Dict[str, np.ndarray]:
    """Seeded numpy values for a flattened flax tree, the same on any host
    (numpy's legacy RandomState stream is frozen across versions). Leaves are
    drawn in sorted path order: kernels and LSTM weights ~ N(0, 1/fan_in),
    biases and BN shifts small, BN scales and running variances near 1,
    running means small, so a random model exercises every normalisation."""
    rng = np.random.RandomState(seed)
    out: Dict[str, np.ndarray] = {}
    for path in sorted(shapes):
        shape = tuple(shapes[path])
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("kernel", "w_i", "w_h"):
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif leaf == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = rng.standard_normal(shape) * 0.1
        out[path] = v.astype(np.float32)
    return out
