"""Metrics / observability spine.

The reference logs unconditionally to wandb (train.py:163-178 etc.); here the
always-on sink is a local JSONL stream (one line per log call) + stdout
prints, with wandb as an opt-in mirror (`--wandb`). This keeps training fully
offline-capable (the TPU pods this targets often have no egress) while
preserving the reference's metric names (loss/a_loss/v_loss/mode/cache_ratio,
train_avse_frames.py:183-189).

`Meter` is the clips/sec/chip throughput counter — the benchmark metric the
reference never had (BASELINE.md requires the rebuild to ship it).

A copy of maavss_tpu/exp/metrics.py, pinned to it by tests/test_torch_data.py.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: str, use_wandb: bool = False,
                 wandb_project: str = "maavss-tpu", config: Optional[Dict] = None):
        self.run_name = run_name
        self.dir = os.path.join(log_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project, name=run_name, config=config or {})
            except Exception as e:  # wandb optional: offline pods
                print(f"wandb unavailable, continuing with jsonl only: {e}")
        if config is not None:
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"ts": time.time()}
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_histograms(self, hists: Dict[str, Any], step: Optional[int] = None
                       ) -> None:
        """Histogram channel (reference: wandb.watch(log="all") records
        gradient/param histograms, train.py:109). `hists` maps name ->
        (counts, bin_edges); records land in histograms.jsonl next to the
        scalar stream, mirrored to wandb as native Histogram objects."""
        rec: Dict[str, Any] = {"ts": time.time()}
        if step is not None:
            rec["step"] = int(step)
        for name, (counts, edges) in hists.items():
            rec[name] = {"counts": [int(c) for c in counts],
                         "edges": [float(e) for e in edges]}
        path = os.path.join(self.dir, "histograms.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(
                {name: self._wandb.Histogram(np_histogram=(list(counts),
                                                           list(edges)))
                 for name, (counts, edges) in hists.items()},
                step=step)

    def close(self) -> None:
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


class Meter:
    """Throughput meter: clips/sec (and per-chip), wall-clock windowed.

    This is DISPATCH-side wall clock: it is bounded by the per-cb_freq
    metric fetch (which forces execution), but between fetches it can run
    transiently optimistic on relay-attached backends where dispatch
    returns before the device finishes. Quotable numbers come from
    bench.py's fetch-closed windows, never from this meter."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = max(1, n_chips)
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._clips = 0

    def update(self, clips: int) -> None:
        self._clips += clips

    @property
    def clips_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._clips / dt if dt > 0 else 0.0

    @property
    def clips_per_sec_per_chip(self) -> float:
        return self.clips_per_sec / self.n_chips
