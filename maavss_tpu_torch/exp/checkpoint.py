"""Checkpoints with the reference's resume semantics (counterpart of
maavss_tpu/exp/checkpoint.py:55-149, in PyTorch's idiom).

- `save_checkpoint(cp_dir, name, state, epoch, loss)` writes
  `<cp_dir>/<name>.ckpt.pt` through a temporary file and `os.replace`:
  epoch, loss, the step, the model's `state_dict` (parameters and BatchNorm
  buffers) and the optimizer's count, m and v (by parameter name),
  overwriting the run's previous checkpoint like the reference's single
  `<name>.pt` (utilities.py:165-204);
- `latest_checkpoint(cp_dir)`: the newest `.ckpt.pt`, or the JAX
  package's `.ckpt.pkl`, by mtime (`-c`);
- `load_checkpoint(..., auto, path, load_opt)` -> (state, epoch), the
  optimizer's count and moments only under `load_opt`
  (utilities.py:193-197); nothing found prints the reference's message and
  returns (state, 0). A JAX `.ckpt.pkl` (its pickle backend:
  params, batch_stats, step, epoch and the optax state) loads through
  `convert.from_flax`; its Adam count and moments are the optax
  ScaleByAdamState's (the trainable leaves' alone under the staged
  freeze's multi_transform, as the port's own checkpoint of a staged run
  keeps them);
- `save_model` / `load_model`: the parameters alone (utilities.py:165-169).
  `load_model` also reads the JAX package's pickle-backend file
  (`<path>.params.pkl`, a numpy tree) through `convert.from_flax`, so a
  model trained by either package loads into the port.

Under a mesh (parallel/) every rank calls save and load: a checkpoint is
the whole state in this one format, the split leaves and their moments
joined over the model group (`parallel.mesh.gather_named`), written by
rank 0 alone, so a sharded run's checkpoint loads in one process and,
through the converter, in the JAX package; a load cuts each split leaf
back to this rank's shard (`parallel.mesh.shard_of`). `save_model` is the
same.

Every load restores IN PLACE: it `copy_`s into the existing parameter,
buffer, moment and count tensors and never rebinds them, because a CUDA
graph that captured the train step (train/cuda_graph.py) holds their
addresses. A key missing from either side, or a shape that differs,
raises; no leaf is skipped. The optimizer's [c1, c2, lr] is rewritten from
the restored count by the next step.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from maavss_tpu_torch.convert import from_flax
from maavss_tpu_torch.parallel.distributed import is_main
from maavss_tpu_torch.parallel.mesh import (
    current,
    gather_named,
    model_split,
    shard_of,
)

SUFFIX = ".ckpt.pt"
JAX_SUFFIX = ".ckpt.pkl"
MODEL_SUFFIX = ".params.pt"


def _param_names(state) -> list:
    names = [n for n, _ in state.model.named_parameters()]
    if len(names) != len(state.tx.params) or any(
            p is not q for (_, p), q in zip(state.model.named_parameters(),
                                            state.tx.params)):
        raise ValueError("checkpoint: the optimizer's parameters are not the "
                         "model's, in the model's order")
    return names


def _payload(state, epoch: int, loss: float) -> Dict[str, Any]:
    names = _param_names(state)
    mesh, model = current(), state.model
    whole = gather_named(mesh, model, model.state_dict())
    return {
        "epoch": int(epoch), "loss": float(loss), "step": int(state.step),
        "model": {k: v.detach().cpu() for k, v in whole.items()},
        "opt": {"count": int(state.tx.count),
                "m": _cpu(gather_named(mesh, model,
                                       _moments(names, state.tx.m))),
                "v": _cpu(gather_named(mesh, model,
                                       _moments(names, state.tx.v)))},
    }


def _cpu(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: t.detach().cpu() for k, t in tensors.items()}


def _resharded(model, tensors: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Whole leaves of a checkpoint -> this rank's shards of the leaves the
    model holds split."""
    split = model_split(model)
    if not split:
        return tensors
    mesh = current()
    return {k: (shard_of(t, split[k], mesh) if k in split else t)
            for k, t in tensors.items()}


def _moments(names, moments, cpu: bool = False) -> Dict[str, torch.Tensor]:
    """{name: moment} of the leaves that keep moments: every leaf's under
    Adam, the trainable leaves' under the staged freeze, none under
    SGD."""
    return {n: (t.detach().cpu() if cpu else t)
            for n, t in zip(names, moments) if t is not None}


def save_checkpoint(cp_dir: str, name: str, state, epoch: int = 0,
                    loss: float = 0.0) -> str:
    path = os.path.join(cp_dir, name + SUFFIX)
    payload = _payload(state, epoch, loss)  # every rank: the gathers
    if not is_main():
        return path
    os.makedirs(cp_dir, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(cp_dir: str) -> Optional[str]:
    """Newest `.ckpt.pt` or `.ckpt.pkl` in cp_dir by mtime
    (utilities.py:199-204)."""
    if not os.path.isdir(cp_dir):
        return None
    candidates = [os.path.join(cp_dir, d) for d in os.listdir(cp_dir)
                  if d.endswith((SUFFIX, JAX_SUFFIX))
                  and os.path.isfile(os.path.join(cp_dir, d))]
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)


@torch.no_grad()
def _copy_into(what: str, dst: Mapping[str, torch.Tensor],
               src: Mapping[str, torch.Tensor]) -> None:
    """Copy every tensor of `src` into the tensor of the same name in `dst`,
    in place; the key sets and shapes must agree."""
    missing, extra = set(dst) - set(src), set(src) - set(dst)
    if missing or extra:
        raise KeyError(f"{what}: missing {sorted(missing)}, unexpected "
                       f"{sorted(extra)}")
    for k, t in dst.items():
        if tuple(src[k].shape) != tuple(t.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(src[k].shape)}, "
                             f"want {tuple(t.shape)}")
        t.copy_(src[k])


def load_checkpoint(cp_dir: str, state, auto: bool = True,
                    path: Optional[str] = None, load_opt: bool = False
                    ) -> Tuple[Any, int]:
    """Restore (state, epoch) in place; returns the input unchanged if
    nothing is found."""
    target = latest_checkpoint(cp_dir) if auto else path
    if target is None:
        print("checkpoint not found, aborting cp load")  # utilities.py:183
        return state, 0
    print(f"loading model checkpoint from {target}")
    if target.endswith(JAX_SUFFIX):
        saved = _jax_checkpoint(target, load_opt)
    else:
        saved = torch.load(target, map_location="cpu", weights_only=True)
    model = state.model
    _copy_into("checkpoint model", model.state_dict(keep_vars=True),
               _resharded(model, saved["model"]))
    state.step = int(saved["step"])
    if load_opt:
        names = _param_names(state)
        _copy_into("checkpoint m", _moments(names, state.tx.m),
                   _resharded(model, saved["opt"]["m"]))
        _copy_into("checkpoint v", _moments(names, state.tx.v),
                   _resharded(model, saved["opt"]["v"]))
        state.tx.count = int(saved["opt"]["count"])
    return state, int(saved["epoch"])


def _opt_states(node, kind: str):
    """Every optax state node of class `kind` in an optax state tree (the
    chain's tuples, multi_transform's dict of masked states)."""
    if isinstance(node, _OptaxState):
        if type(node).__name__ == kind:
            return [node.fields]
        node = node.fields
    if isinstance(node, Mapping):
        node = list(node.values())
    if isinstance(node, (tuple, list)):
        return [s for n in node for s in _opt_states(n, kind)]
    return []


def _unmasked(tree):
    """A moment tree without optax's MaskedNode leaves: under the staged
    freeze (optax.multi_transform) the frozen leaves keep no moments."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            v = _unmasked(v)
            if v:
                out[k] = v
        elif not (isinstance(v, _OptaxState)
                  and type(v).__name__ == "MaskedNode"):
            out[k] = v
    return out


def _jax_checkpoint(path: str, load_opt: bool) -> Dict[str, Any]:
    """A JAX `.ckpt.pkl` in the form of the port's payload: the model's
    state_dict from params and batch_stats, the step and epoch, and under
    `load_opt` the optimizer's count and Adam's moments by parameter name:
    those of its one ScaleByAdamState (optax.adam, optax.adamw, or either
    inside the staged freeze's multi_transform, whose frozen leaves hold
    no moments), or none under optax.sgd, whose count is its schedule's,
    else the step."""
    with open(path, "rb") as f:
        tree = _NumpyTreeUnpickler(f, optax=True).load()
    saved = {"epoch": int(tree["epoch"]), "step": int(tree["step"]),
             "model": from_flax(tree["params"], tree["batch_stats"])}
    if load_opt:
        adam = _opt_states(tree["opt_state"], "ScaleByAdamState")
        if len(adam) > 1:
            raise ValueError(f"{path}: {len(adam)} Adam states in the "
                             "optimizer state, want at most 1")
        if adam:
            count, mu, nu = adam[0]
            saved["opt"] = {"count": int(count),
                            "m": from_flax(_unmasked(mu)),
                            "v": from_flax(_unmasked(nu))}
        else:
            sched = _opt_states(tree["opt_state"], "ScaleByScheduleState")
            count = int(sched[0][0]) if sched else saved["step"]
            saved["opt"] = {"count": count, "m": {}, "v": {}}
    return saved


def save_model(path: str, model: torch.nn.Module) -> str:
    """Whole-model save, the parameters only (reference save_model parity):
    `<path>.params.pt`."""
    path = path if path.endswith(MODEL_SUFFIX) else path + MODEL_SUFFIX
    whole = gather_named(current(), model, dict(model.named_parameters()))
    if not is_main():
        return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in whole.items()}, path)
    return path


class _OptaxState:
    """An optax state node of a JAX checkpoint, unpickled without optax:
    its class name and its fields in order."""

    def __new__(cls, *fields):
        obj = super().__new__(cls)
        obj.fields = fields
        return obj


class _NumpyTreeUnpickler(pickle.Unpickler):
    """The JAX package's pickle-backend files hold numpy arrays in dicts;
    a flax FrozenDict, where one occurs, comes back as a plain dict, and
    with `optax` an optax state node as an `_OptaxState` of that name, so
    no jax, flax or optax is imported to read them."""

    def __init__(self, f, optax: bool = False):
        super().__init__(f)
        self.optax = optax

    def find_class(self, module, name):
        if module.startswith("flax") and name == "FrozenDict":
            return dict
        if self.optax and module.split(".")[0] == "optax":
            return type(name, (_OptaxState,), {})
        if module.split(".")[0] not in ("numpy", "builtins", "collections"):
            raise pickle.UnpicklingError(
                f"load_model: {module}.{name} is not part of a numpy tree")
        return super().find_class(module, name)


def load_model(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load saved parameters into `model` in place: the port's
    `<path>.params.pt`, or the JAX package's `<path>.params.pkl` (a flax
    params tree of numpy arrays, converted by `from_flax`). The buffers
    (BatchNorm's running statistics) are not part of either file and stay
    as they are. Returns `model`. An orbax directory (the JAX package's
    default backend) raises."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"load_model: {path} is an orbax directory, which "
            "maavss_tpu_torch does not read yet (ROADMAP M6-rest (orbax)); "
            "save with MAAVSS_CKPT_BACKEND=pkl")
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            tree = _NumpyTreeUnpickler(f).load()
        src = from_flax(tree)
    else:
        src = torch.load(path, map_location="cpu", weights_only=True)
    _copy_into("load_model", dict(model.named_parameters()),
               _resharded(model, src))
    return model
