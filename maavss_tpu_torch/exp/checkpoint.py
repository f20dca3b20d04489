"""Checkpoints with the reference's resume semantics (counterpart of
maavss_tpu/exp/checkpoint.py:55-149, in PyTorch's idiom).

- `save_checkpoint(cp_dir, name, state, epoch, loss)` writes
  `<cp_dir>/<name>.ckpt.pt` through a temporary file and `os.replace`:
  epoch, loss, the step, the model's `state_dict` (parameters and BatchNorm
  buffers) and the optimizer's count, m and v (by parameter name),
  overwriting the run's previous checkpoint like the reference's single
  `<name>.pt` (utilities.py:165-204);
- `latest_checkpoint(cp_dir)`: the newest `.ckpt.pt` by mtime (`-c`);
- `load_checkpoint(..., auto, path, load_opt)` -> (state, epoch), the
  optimizer's count and moments only under `load_opt`
  (utilities.py:193-197); nothing found prints the reference's message and
  returns (state, 0);
- `save_model` / `load_model`: the parameters alone (utilities.py:165-169).
  `load_model` also reads the JAX package's pickle-backend file
  (`<path>.params.pkl`, a numpy tree) through `convert.from_flax`, so a
  model trained by either package loads into the port.

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

SUFFIX = ".ckpt.pt"
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
    return {
        "epoch": int(epoch), "loss": float(loss), "step": int(state.step),
        "model": {k: v.detach().cpu()
                  for k, v in state.model.state_dict().items()},
        "opt": {"count": int(state.tx.count),
                "m": {n: t.detach().cpu() for n, t in zip(names, state.tx.m)},
                "v": {n: t.detach().cpu()
                      for n, t in zip(names, state.tx.v)}},
    }


def save_checkpoint(cp_dir: str, name: str, state, epoch: int = 0,
                    loss: float = 0.0) -> str:
    os.makedirs(cp_dir, exist_ok=True)
    path = os.path.join(cp_dir, name + SUFFIX)
    tmp = path + ".tmp"
    torch.save(_payload(state, epoch, loss), tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(cp_dir: str) -> Optional[str]:
    """Newest `.ckpt.pt` in cp_dir by mtime (utilities.py:199-204)."""
    if not os.path.isdir(cp_dir):
        return None
    candidates = [os.path.join(cp_dir, d) for d in os.listdir(cp_dir)
                  if d.endswith(SUFFIX)
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
    saved = torch.load(target, map_location="cpu", weights_only=True)
    _copy_into("checkpoint model", state.model.state_dict(keep_vars=True),
               saved["model"])
    state.step = int(saved["step"])
    if load_opt:
        names = _param_names(state)
        _copy_into("checkpoint m", dict(zip(names, state.tx.m)),
                   saved["opt"]["m"])
        _copy_into("checkpoint v", dict(zip(names, state.tx.v)),
                   saved["opt"]["v"])
        state.tx.count = int(saved["opt"]["count"])
    return state, int(saved["epoch"])


def save_model(path: str, model: torch.nn.Module) -> str:
    """Whole-model save, the parameters only (reference save_model parity):
    `<path>.params.pt`."""
    path = path if path.endswith(MODEL_SUFFIX) else path + MODEL_SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.named_parameters()},
               path)
    return path


class _NumpyTreeUnpickler(pickle.Unpickler):
    """The JAX package's pickle-backend file holds numpy arrays in dicts;
    a flax FrozenDict, where one occurs, comes back as a plain dict, so no
    jax or flax is imported to read it."""

    def find_class(self, module, name):
        if module.startswith("flax") and name == "FrozenDict":
            return dict
        if module.split(".")[0] not in ("numpy", "builtins", "collections"):
            raise pickle.UnpicklingError(
                f"load_model: {module}.{name} is not part of a numpy tree")
        return super().find_class(module, name)


def load_model(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load saved parameters into `model` in place: the port's
    `<path>.params.pt`, or the JAX package's `<path>.params.pkl` (a flax
    params tree of numpy arrays, converted by `from_flax`). The buffers
    (BatchNorm's running statistics) are not part of either file and stay
    as they are. Returns `model`."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            tree = _NumpyTreeUnpickler(f).load()
        src = from_flax(tree)
    else:
        src = torch.load(path, map_location="cpu", weights_only=True)
    _copy_into("load_model", dict(model.named_parameters()), src)
    return model
