"""A traced window: torch.profiler over the host and the device, its Chrome
trace written to a temporary directory under TMPDIR, read, and deleted.

From the trace (`reduce`):
- the window: the span of the `perfbench.window` annotation around it;
- the device's clock put on the host's: the trace's device timestamps
  are shifted, where needed, so that no device operation starts before
  the host call that launched it began (matched by correlation id);
- device busy time: the union of the intervals of kernels, copies and sets
  inside the window (overlapping operations count once);
- per kernel name (the function's own name, without namespace, template
  arguments or parameters): launches and device seconds;
- idle gaps: the stretches of the window in which no device operation
  runs, each named by the innermost host event spanning its middle
  ("host" where none does), summed by name;
- device seconds of kernels launched under a host op matching a
  predicate (for example the 5-D convolutions), by the launches'
  correlation ids.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
WINDOW = "perfbench.window"


def kernel_name(full: str) -> str:
    """'void (anonymous namespace)::grads_kernel<float, 2>(...)' ->
    'grads_kernel'; a library kernel keeps its named namespaces."""
    s = full[5:] if full.startswith("void ") else full
    s = s.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", s, maxsplit=1)[0].strip()


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]  # name -> (launches, seconds)
    gaps: List[Tuple[str, float]]  # (host activity, seconds), longest first
    device_ops: List[Tuple[str, float]]  # (op, seconds), most first
    under: Dict[str, float] = field(default_factory=dict)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(host: List[Tuple[float, float, str]], starts: List[float],
               t: float) -> str:
    """The shortest host event containing t (host sorted by start)."""
    best, best_len = "host", float("inf")
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(host[max(0, i - 4000):i]):
        if a <= t <= b and b - a < best_len:
            best, best_len = name, b - a
    return best


def reduce(events: List[Dict],
           under: Optional[Dict[str, Callable[[Dict], bool]]] = None
           ) -> Trace:
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace has no perfbench.window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    shift = _device_shift(events)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = a + shift, b + shift
            if b > w0 and a < w1:
                dev.append((max(a, w0), min(b, w1), e))
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((a, b, e["name"]))
    busy = _union([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    ops: Dict[str, float] = defaultdict(float)
    for a, b, e in dev:
        name = kernel_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        ops[name] += (b - a) / 1e6
        if e["cat"] == "kernel":
            kernels[name][0] += 1
            kernels[name][1] += (b - a) / 1e6
    host.sort()
    starts = [a for a, _, _ in host]
    gaps: Dict[str, float] = defaultdict(float)
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            doing = _innermost(host, starts, 0.5 * (edge + a))
            gaps[doing] += (a - edge) / 1e6
        edge = max(edge, b)
    out_under = {}
    for key, pred in (under or {}).items():
        out_under[key] = _under_seconds(events, dev, pred)
    return Trace(
        window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        kernels={k: (int(v[0]), v[1]) for k, v in kernels.items()},
        gaps=sorted(gaps.items(), key=lambda kv: -kv[1]),
        device_ops=sorted(ops.items(), key=lambda kv: -kv[1]),
        under=out_under)


def _device_shift(events: List[Dict]) -> float:
    """Microseconds to add to the device's timestamps: how far the
    earliest device operation starts before the host call that launched
    it (0 where none does)."""
    launched = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and e.get("ph") == "X":
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
    early = 0.0
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            corr = (e.get("args") or {}).get("correlation")
            if corr in launched:
                early = min(early, float(e["ts"]) - launched[corr])
    return -early


def _under_seconds(events, dev, pred: Callable[[Dict], bool]) -> float:
    """Device seconds of the kernels whose launch lies inside a host op for
    which `pred` holds (same thread, by time), matched by correlation."""
    ops = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("ph") == "X" and pred(e):
            ops[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    hits = set()
    for e in events:
        if e.get("cat") != "cuda_runtime" or e.get("ph") != "X":
            continue
        spans = ops.get((e.get("pid"), e.get("tid")))
        if not spans:
            continue
        t = float(e["ts"])
        if any(a <= t <= b for a, b in spans):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                hits.add(corr)
    return sum((b - a) / 1e6 for a, b, e in dev
               if (e.get("args") or {}).get("correlation") in hits)


def traced(fn: Callable[[], object], device, record_shapes: bool = False,
           under: Optional[Dict[str, Callable[[Dict], bool]]] = None
           ) -> Tuple[object, Trace, float]:
    """Run `fn` under the profiler inside the `perfbench.window`
    annotation, synchronised at both ends; return (fn's result, the
    reduced trace, seconds spent reading the trace). On a CPU device the
    trace holds the host alone (for tests)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    if on_card:
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as d:
        with profile(activities=acts, record_shapes=record_shapes) as prof:
            with record_function(WINDOW):
                out = fn()
                if on_card:
                    torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    tr = reduce(events, under)
    del events
    return out, tr, time.perf_counter() - t0
