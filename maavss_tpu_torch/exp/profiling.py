"""Profiling / tracing (counterpart of maavss_tpu/exp/profiling.py:27-80).

- `trace(log_dir)`: a `torch.profiler` capture of the host and, on a card,
  the device (CUPTI), written to `log_dir` as a Chrome trace (view in
  Perfetto or chrome://tracing); the profile object is yielded for
  `key_averages()`.
- `PhaseTimer`: per-phase wall timers that land in the metrics JSONL.
- `annotate(name)`: a named region, an NVTX range on the card (and a
  `record_function` label in a `trace`).

`compile_report` (XLA's static cost analysis of a jitted step) has no
counterpart yet (ROADMAP M6-rest).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace into `log_dir`/trace.json.

    with profiling.trace('runs/myrun/trace') as prof:
        for _ in range(20): step(...)
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Named wall-clock phases; `summary()` returns mean seconds per phase.

    timer = PhaseTimer()
    with timer.phase('data'):   batch = next(it)
    with timer.phase('step'):   state, m = step(...); torch.cuda.synchronize()
    """

    def __init__(self):
        self._tot: Dict[str, float] = {}
        self._cnt: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._tot[name] = self._tot.get(name, 0.0) + dt
            self._cnt[name] = self._cnt.get(name, 0) + 1

    def summary(self, prefix: str = "time_") -> Dict[str, float]:
        return {f"{prefix}{k}": self._tot[k] / self._cnt[k] for k in self._tot}

    def reset(self) -> None:
        self._tot.clear()
        self._cnt.clear()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region: an NVTX range on the card and a profiler label."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
