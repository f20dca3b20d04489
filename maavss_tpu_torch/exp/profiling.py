"""Profiling / tracing (counterpart of maavss_tpu/exp/profiling.py:27-80).

- `trace(log_dir)`: a `torch.profiler` capture of the host and, on a card,
  the device (CUPTI), written to `log_dir` as a Chrome trace (view in
  Perfetto or chrome://tracing); the profile object is yielded for
  `key_averages()`.
- `PhaseTimer`: per-phase wall timers that land in the metrics JSONL.
- `annotate(name)`: a named host range, the port's one way to mark a
  region; `SPANS` holds the names the program marks (the layers of its
  train step). In a profiler trace a range is a `cpu_op` event, so device
  work launched inside it can be attributed to it by correlation id;
  with no profiler running it costs about 0.4 us.
- `compile_report(fn, *args)`: a static roofline of a step (the
  counterpart of XLA's cost analysis of a jitted step,
  maavss_tpu/exp/profiling.py:82-131), from one pass of `fn` over fake
  tensors on the CPU; `format_report` renders it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.utils._python_dispatch import TorchDispatchMode


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


# the program's span names, by layer: the train step's frontend (the
# batch to the device, STFT pair, phasegram rows and windows, the input
# masks; train/steps.py), the models' encoders, fusion core and output
# heads (models/fusion.py, models/fusion_frames.py), and the optimizer
# (the gradients' zeroing, their division and all-reduce, the watch
# metrics, the update; train/steps.py)
SPANS = {
    "frontend": "maavss.frontend",
    "encoders": "maavss.encoders",
    "fusion_core": "maavss.fusion_core",
    "heads": "maavss.heads",
    "update": "maavss.update",
}


def annotate(name: str) -> _RecordFunctionFast:
    """A named host range, `with annotate(SPANS["heads"]): ...`: a
    `cpu_op` event of that name in a torch.profiler trace (with its count
    in `key_averages()`), and with no profiler running a no-op of about
    0.4 us. It is the range torch's own generated code uses
    (`_RecordFunctionFast`): it dispatches no op, so it adds no node to a
    `torch.export` graph and no `user_annotation` event."""
    return _RecordFunctionFast(name)


# published H100 SXM peaks (NVIDIA's data sheet; PERF.md section 6): HBM
# bytes/s, fp32 FLOP/s outside the tensor cores, dense bf16 FLOP/s on them
H100_HBM_GBPS = 3350.0
H100_FP32_TFLOPS = 67.0
H100_BF16_TFLOPS = 989.0


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched op's tensor inputs and outputs,
    views (which move nothing) aside."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += _tensor_bytes((args, kwargs, out))
        return out


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _module_bytes(args) -> int:
    """Bytes of the parameters and buffers of the nn.Modules among `args`
    or held by them as dataclass fields."""
    found = []
    for a in args:
        fields = ([getattr(a, f.name) for f in dataclasses.fields(a)]
                  if dataclasses.is_dataclass(a) else [])
        found += [m for m in [a] + fields if isinstance(m, torch.nn.Module)]
    return sum(_tensor_bytes(list(m.parameters()) + list(m.buffers()))
               for m in found)


def compile_report(fn, *args: Any, peak_tflops: Optional[float] = None,
                   hbm_gbps: Optional[float] = None,
                   measured_ms: Optional[float] = None,
                   compute_dtype: str = "float32") -> Dict[str, Any]:
    """Static cost of `fn(*args)`, e.g. a train step (forward, backward and
    optimizer update), and its roofline on one card. `fn` never runs on
    data and nothing touches a card: it runs once, on a deep copy of
    `args` (the arguments are never touched), under a FakeTensorMode on
    the CPU, where every op that reads a fake tensor (the batch, and all
    that follows from it) computes its output's shape alone. CPU tensors
    take the kernels' plain versions, so the count is the same whatever
    route the card runs.

    - `flops`: torch.utils.flop_counter.FlopCounterMode's count (matrix
      products and convolutions, forward and backward; no elementwise op);
    - `bytes_accessed`: the sum of each dispatched op's input and output
      bytes (views aside): an upper bound of the traffic of the step run
      op by op, with nothing fused and nothing cached;
    - `arithmetic_intensity`, `sol_compute_ms` and `sol_memory_ms` (the
      speed-of-light times at `peak_tflops` and `hbm_gbps`, by default the
      H100's: 3.35 TB/s, and 67 TFLOP/s at float32 or 989 at bfloat16 and
      float16, the tensor cores' one rate for both, by `compute_dtype`)
      and `bound`;
    - `argument_bytes` (the tensors among `args`, with the parameters and
      buffers of the nn.Modules among them or held by them as dataclass
      fields) and `output_bytes`;
    - with `measured_ms` (a step's time on the card), the achieved shares
      `compute_pct` and `hbm_pct`.

    XLA's temp size (the compiled program's scratch) has no counterpart:
    nothing is compiled here."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    if peak_tflops is None:
        peak_tflops = (H100_BF16_TFLOPS
                       if compute_dtype in ("bfloat16", "float16")
                       else H100_FP32_TFLOPS)
    hbm_gbps = H100_HBM_GBPS if hbm_gbps is None else hbm_gbps
    args = copy.deepcopy(args)
    arg_bytes = _tensor_bytes(args) + _module_bytes(args)
    counter = _ByteCounter()
    with FakeTensorMode(allow_non_fake_inputs=True), \
            FlopCounterMode(display=False) as flop_mode, counter:
        out_bytes = _tensor_bytes(fn(*args))
    flops = float(flop_mode.get_total_flops())
    moved = float(counter.bytes)
    report: Dict[str, Any] = {
        "flops": flops, "gflops": flops / 1e9, "bytes_accessed": moved,
        "arithmetic_intensity": flops / moved if moved else 0.0,
        "sol_compute_ms": flops / (peak_tflops * 1e12) * 1e3,
        "sol_memory_ms": moved / (hbm_gbps * 1e9) * 1e3,
        "peak_tflops": peak_tflops, "hbm_gbps": hbm_gbps,
        "argument_bytes": float(arg_bytes), "output_bytes": float(out_bytes),
    }
    report["bound"] = ("compute" if report["sol_compute_ms"]
                       >= report["sol_memory_ms"] else "memory")
    if measured_ms:
        report["measured_ms"] = float(measured_ms)
        report["compute_pct"] = 100.0 * report["sol_compute_ms"] / measured_ms
        report["hbm_pct"] = 100.0 * report["sol_memory_ms"] / measured_ms
    return report


def format_report(r: Dict[str, Any]) -> str:
    """Human-readable multi-line rendering of a compile_report dict."""
    lines = [
        f"flops            {r['gflops']:.2f} GFLOP",
        f"bytes accessed   {r['bytes_accessed'] / 1e9:.3f} GB "
        f"(op by op, an upper bound)",
        f"intensity        {r['arithmetic_intensity']:.1f} FLOP/B",
        f"speed-of-light   compute {r['sol_compute_ms']:.3f} ms | "
        f"memory {r['sol_memory_ms']:.3f} ms -> {r['bound']}-bound",
        f"arguments        {r['argument_bytes'] / 2**30:.2f} GiB | out "
        f"{r['output_bytes'] / 2**30:.4f} GiB",
    ]
    if "measured_ms" in r:
        lines.append(
            f"measured         {r['measured_ms']:.2f} ms -> "
            f"compute {r['compute_pct']:.1f}% | HBM {r['hbm_pct']:.1f}%")
    return "\n".join(lines)
