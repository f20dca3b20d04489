"""What a per-layer metric's reader gets (`Context`), and the arithmetic the
readers share. A reader returns None where it finds nothing to read: the
harness then leaves its metric out of the line."""

from __future__ import annotations

import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, Optional, Sequence

from perfbench.core.trace import Trace
from perfbench.core.work import BF16_FLOP_PER_S


@dataclass
class Context:
    fam: ModuleType  # the configuration's family, perfbench/families/
    cfg: Dict  # the configuration's `run` keys
    traffic: Dict
    trace: Trace
    units: int  # the runner's units (train steps) in the traced window
    counters: Dict[str, int]  # hand-written kernels' launches in the window


def idle_percent(ctx: Context) -> float:
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu_percent(ctx: Context, flops_per_unit: float) -> float:
    """Model FLOPs of the window's units over its seconds at the dense bf16
    peak."""
    return 100.0 * flops_per_unit * ctx.units / (ctx.trace.window_s
                                                 * BF16_FLOP_PER_S)


def roofline_percent(ctx: Context, what: str, kernels: Sequence[str],
                     launches: Dict[str, int], bound_per_unit: float
                     ) -> Optional[float]:
    """The least time of the window's units over the device time of
    `kernels`. `launches` maps a launch counter of the program to the
    kernels a counted call launches. None when those kernels did not run,
    or when the profiler saw another number of launches than the counters
    give (a dropped launch would make the share read high)."""
    seen = sum(ctx.trace.kernels.get(k, (0, 0.0))[0] for k in kernels)
    seconds = sum(ctx.trace.kernels.get(k, (0, 0.0))[1] for k in kernels)
    want = sum(ctx.counters.get(c, 0) * n for c, n in launches.items())
    if want == 0 or seconds <= 0.0:
        return None
    if seen != want:
        print(f"perfbench: {what}: the profiler saw {seen} launches of "
              f"{list(kernels)}, the counters give {want}; not read",
              file=sys.stderr)
        return None
    return 100.0 * bound_per_unit * ctx.units / seconds
