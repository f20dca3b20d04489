"""The system under test: the port's RunConfig from a configuration's
`run` keys and a traffic, its train state and step over a family's model
loaded with the benchmark's weights, and its kernels' launch counters.

This module and the families (perfbench/families/) are the benchmark's
only modules that import `maavss_tpu_torch`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch


def run_config(run: Dict, traffic: Dict):
    """The port's RunConfig: the configuration's keys that RunConfig has,
    then the traffic's batch, dispatch and visual input."""
    from maavss_tpu_torch.config import RunConfig

    fields = {f.name for f in dataclasses.fields(RunConfig)}
    cfg = RunConfig(**{k: v for k, v in run.items() if k in fields})
    return cfg.replace(
        batch_size=traffic["batch_size"],
        steps_per_dispatch=traffic.get("steps_per_dispatch", 1),
        pgram_cache=traffic["visual"] == "pgram_rows",
        noise_scalar=traffic.get("noise_scalar", cfg.noise_scalar))


def train(fam, run: Dict, traffic: Dict, weights: Dict[str, torch.Tensor],
          device) -> Tuple[object, Callable, int]:
    """(train state, step, steps a dispatch): the family's model loaded
    with `weights`, its Adam state, and the family's step (a K-step
    CUDA-graph dispatch where the traffic's steps_per_dispatch > 1)."""
    from maavss_tpu_torch.train.state import create_train_state

    cfg = run_config(run, traffic)
    model = fam.model(cfg, run, device)
    model.load_state_dict(weights)
    state = create_train_state(model, cfg, device)
    return state, fam.make_step(model, cfg, device), cfg.steps_per_dispatch


def kernel_counters() -> Dict[str, int]:
    """Each hand-written kernel's launches so far (ops/counters.py)."""
    from maavss_tpu_torch.ops.counters import kernel_counters as counters

    return {name: int(getattr(obj, attr))
            for name, (obj, attr) in counters().items()}
