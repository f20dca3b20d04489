#!/usr/bin/env python3
"""Benchmark of the PyTorch port: A/V clips/s on one NVIDIA GPU for the
flagship train step (the port's counterpart of bench.py).

    python3 tools/bench_torch.py

It reads bench.py's variables, with its defaults and semantics
(bench.py:99-224,227-329): MAAVSS_BENCH_BATCH (256), MAAVSS_BENCH_STEPS
(50), MAAVSS_BENCH_WINDOWS (3, a count), MAAVSS_BENCH_REGIME (fusion |
frames), MAAVSS_BENCH_FUSION_ENCODE (full), MAAVSS_BENCH_PGRAM (1: float16
phasegram rows in place of raw frames, fusion only), MAAVSS_BENCH_WINDOW_MODE
(vectorized; the full-encode step supersedes it), MAAVSS_BENCH_MASK_HEAD (0),
MAAVSS_BENCH_RNN (lstm), MAAVSS_BENCH_PGENC (auto), MAAVSS_BENCH_STFT_FOLD
(auto), MAAVSS_BENCH_FRAMES_ENCODE (window), MAAVSS_BENCH_FRAMES_HALO (0),
MAAVSS_BENCH_MICROBATCH (1), MAAVSS_BENCH_MULTISTEP (1), MAAVSS_BENCH_REMAT
(0), MAAVSS_BENCH_FUSED_OPT (0), MAAVSS_BENCH_DTYPE and
MAAVSS_BENCH_OPT_KERNEL; MAAVSS_LSTM and MAAVSS_FULLENC_LOSS reach the model
and step as in the JAX package. The model is built at the default RunConfig's
widths with seeded random weights; one synthetic batch (seed 0) is moved to
the device once and reused; mode 2. After 5 warm-up dispatches it times
MAAVSS_BENCH_WINDOWS windows of MAAVSS_BENCH_STEPS steps, each closed by
torch.cuda.synchronize() and a host fetch of the last step's loss, and
reports the median window, the spread and the windows.

MAAVSS_BENCH_MULTISTEP=K (--steps_per_dispatch) runs K optimizer steps a
dispatch, one CUDA-graph replay on the card (train/cuda_graph.py; the first
warm-up dispatch captures it), over K stacked copies of the batch, as
bench.py:167-217 does: MAAVSS_BENCH_STEPS must be a multiple of K, a window
is STEPS / K dispatches, and `kernels` stays per optimizer step.

MAAVSS_BENCH_DTYPE defaults to bfloat16, as bench.py's does
(bench.py:233): the number of record is the bf16 step;
MAAVSS_BENCH_DTYPE=float32 measures the fp32 step. float16 raises
"M5 (float16)".

Where it differs from bench.py (also listed under `differs_from_bench_py`
in its JSON line):
- MAAVSS_BENCH_OPT_KERNEL defaults to auto, so K3 (csrc/adam.cu) runs;
  xla is the plain formula.
- MAAVSS_BENCH_REMAT=1 and MAAVSS_BENCH_FUSED_OPT=1 raise by their
  ROADMAP labels (check_supported);
  MAAVSS_BENCH_UNROLL has no counterpart (K1 runs the recurrence in one
  launch) and is not read.
- vs_baseline divides by benchmarks/baseline_pin.json (read as plain JSON);
  no fresh torch-CPU leg runs, so vs_baseline_fresh is null.
- stft_impl, mask_impl and epilogue name the route the port takes (its
  kernels on the card, their plain versions on the CPU), which reads no
  variable for them.

Its JSON line carries bench.py's keys (microbatch, frames_encode and
frames_halo among them: the values it ran) and the torch and CUDA versions,
the card's name and power limit (nvidia-smi), peak device memory allocated
and reserved, the median
step's ms, and `kernels`: each hand-written kernel's launches per step over
the timed windows, from the wrappers' counters (no profiler runs in them).
`--profile` adds one dispatch (one step, or K under MULTISTEP) under
torch.profiler after the windows (`profile`: device busy, idle share,
launches, top kernels, and the host ops' self time, in all and for the top
ops; `steps` the optimizer steps it covers).

`--device cpu` runs the plain versions on the CPU, for the tests only: its
value is then named av_clips_per_sec_cpu_plain, not a device metric. On
the card, a machine without CUDA makes it fail.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Dict, Mapping, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from maavss_tpu_torch.ops.counters import kernel_counters  # noqa: E402
PIN = os.path.join(ROOT, "benchmarks", "baseline_pin.json")
WARMUP = 5
MODE = 2
# the kernels of the frames encoder's fused epilogue (K5, csrc/epilogue.cu)
EPILOGUE_KERNELS = ("partials_kernel", "stats_combine_kernel",
                    "apply_kernel", "apply_vec_kernel", "bwd_partials_kernel",
                    "bwd_combine_kernel", "dy_kernel")
DIFFERS = (
    "MAAVSS_BENCH_OPT_KERNEL defaults to auto (K3; xla is the plain formula)",
    "REMAT=1 and FUSED_OPT=1 raise by their ROADMAP labels; UNROLL is not "
    "read",
    "MULTISTEP=K replays one CUDA graph of K steps a dispatch",
    "windows closed by torch.cuda.synchronize() and a host fetch of the loss",
    "vs_baseline from benchmarks/baseline_pin.json; no fresh torch-CPU leg",
    "stft_impl, mask_impl and epilogue name the route the port takes",
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def smi() -> Optional[Dict[str, str]]:
    """The card's name and power limit as nvidia-smi gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (s.strip() for s in line.splitlines()[0].split(","))
    return {"name": name, "power_limit": limit}


def bench_config(env: Mapping[str, str], batch_size: int,
                 geometry: Optional[Mapping] = None):
    """(RunConfig, regime, window mode) from bench.py's variables, with
    `geometry` (RunConfig fields; the tests' small widths) over the
    defaults. Options the port lacks raise NotImplementedError naming their
    ROADMAP item."""
    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.train.setup import check_supported

    regime = env.get("MAAVSS_BENCH_REGIME", "fusion")
    if regime not in ("fusion", "frames"):
        raise SystemExit(f"MAAVSS_BENCH_REGIME={regime!r} (fusion|frames)")
    frames = regime == "frames"
    window_mode = None if frames else env.get("MAAVSS_BENCH_WINDOW_MODE",
                                              "vectorized")
    cfg = RunConfig(**dict(geometry or {})).replace(
        batch_size=batch_size,
        dtype=env.get("MAAVSS_BENCH_DTYPE", "bfloat16"),
        pgram_cache=env.get("MAAVSS_BENCH_PGRAM", "1") == "1" and not frames,
        microbatch=int(env.get("MAAVSS_BENCH_MICROBATCH", "1")),
        remat=env.get("MAAVSS_BENCH_REMAT", "0") == "1",
        frames_encode=env.get("MAAVSS_BENCH_FRAMES_ENCODE", "window"),
        frames_halo=int(env.get("MAAVSS_BENCH_FRAMES_HALO", "0")),
        fusion_encode=env.get("MAAVSS_BENCH_FUSION_ENCODE", "full"),
        window_mode=window_mode or "scan",
        rnn_cell=env.get("MAAVSS_BENCH_RNN", "lstm"),
        mask_head=env.get("MAAVSS_BENCH_MASK_HEAD", "0") == "1",
        pgenc_kernel=env.get("MAAVSS_BENCH_PGENC", "auto"),
        stft_fold=env.get("MAAVSS_BENCH_STFT_FOLD", "auto"),
        opt_kernel=env.get("MAAVSS_BENCH_OPT_KERNEL", "auto"),
        fused_opt=env.get("MAAVSS_BENCH_FUSED_OPT", "0") == "1",
        steps_per_dispatch=int(env.get("MAAVSS_BENCH_MULTISTEP", "1")))
    check_supported(cfg, train=True)
    return cfg, regime, window_mode


def _kernel_name(key: str) -> str:
    """A profiler kernel key's name, without namespace, template arguments
    and parameters."""
    m = re.search(r"::(\w+)[<(]", key)
    return m.group(1) if m else key


def profile_step(fn, steps: int = 1) -> Dict:
    """One call of `fn` (a dispatch of `steps` optimizer steps) under
    exp/profiling.trace (torch.profiler; its Chrome trace in a temporary
    directory), after the timed windows:
    device busy ms (CUDA kernel time summed), the host-clock wall ms of the
    same window, the device's idle share, kernel launches, the 12 kernels
    with the most device time, and on the host the ops' self time summed
    (`host_op_ms`; the Python between them is the rest of the wall) and
    the 12 ops with the most of it (`host_top`, each with its calls);
    `epilogue`: K5's kernels, their device ms and share of the busy time,
    and each by name (with its template arguments) and launches."""
    import tempfile

    import torch
    from torch.autograd import DeviceType

    from maavss_tpu_torch.exp.profiling import trace

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir, trace(log_dir) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    host_top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]
    epi = [e for e in kernels if _kernel_name(e.key) in EPILOGUE_KERNELS]
    epi_ms = sum(e.device_time_total for e in epi) / 1e3
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "launches": sum(e.count for e in kernels),
            "top": [{"kernel": e.key[:80], "ms": e.device_time_total / 1e3,
                     "count": e.count} for e in top],
            "host_op_ms": sum(e.self_cpu_time_total for e in ops) / 1e3,
            "host_top": [{"op": e.key[:80], "ms": e.self_cpu_time_total / 1e3,
                          "count": e.count} for e in host_top],
            "epilogue": {"ms": epi_ms, "share": epi_ms / busy_ms,
                         "kernels": [{"kernel": e.key[:100],
                                      "ms": e.device_time_total / 1e3,
                                      "count": e.count} for e in epi]}}


def measure(batch_size: int = 256, steps: int = 50, windows: int = 3,
            warmup: int = WARMUP, device: str = "cuda",
            env: Optional[Mapping[str, str]] = None,
            geometry: Optional[Mapping] = None,
            profile: bool = False) -> Dict:
    """Build, warm up and time the train step as the module docstring says;
    returns the JSON line's fields (without the baseline ones). With
    `profile` (on the card), one more step runs after the windows under
    torch.profiler (`profile_step`)."""
    import numpy as np
    import torch

    from maavss_tpu_torch.data.synthetic import (
        synthetic_av_batch,
        with_pgram_rows,
    )
    from maavss_tpu_torch.train.setup import (
        build_frames_state,
        build_fusion_state,
    )
    from maavss_tpu_torch.train.steps import (
        fullenc_loss_impl,
        make_frames_step,
        make_fusion_step,
    )

    env = os.environ if env is None else env
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench_torch: CUDA is not available; the port's "
                         "number is taken on an NVIDIA GPU")
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, regime, window_mode = bench_config(env, batch_size, geometry)
    k_steps = cfg.steps_per_dispatch
    if steps % k_steps:
        raise SystemExit(f"MAAVSS_BENCH_STEPS={steps} must be a multiple "
                         f"of MAAVSS_BENCH_MULTISTEP={k_steps}")
    init = torch.Generator().manual_seed(cfg.seed)
    if regime == "frames":
        _, state = build_frames_state(cfg, batch_size, device=dev,
                                      generator=init)
        step = make_frames_step(state.model, cfg, device=dev)
        batch = synthetic_av_batch(cfg, batch_size, seed=0,
                                   frame_size=cfg.framesize)
    else:
        _, state = build_fusion_state(cfg, batch_size, dev, init)
        step = make_fusion_step(state.model, cfg, window_mode=window_mode,
                                device=dev)
        batch = synthetic_av_batch(cfg, batch_size, seed=0)
        if cfg.pgram_cache:
            batch = with_pgram_rows(batch, dev)
    if k_steps > 1:
        batch = {k: np.stack([v] * k_steps) for k, v in batch.items()}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    noise = torch.Generator(device=dev).manual_seed(0)
    log(f"bench_torch: regime={regime} batch={batch_size} "
        f"fusion_encode={cfg.fusion_encode} pgram={cfg.pgram_cache} "
        f"multistep={k_steps} device={dev}")

    def last_loss(metrics) -> float:
        # stacked [K] metrics under MULTISTEP: the last step's loss
        return float(metrics["loss"].reshape(-1)[-1])

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(warmup):
        state, metrics = step(state, batch, MODE, noise)
    sync()
    last_loss(metrics)
    counters = kernel_counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    window_cps = []
    for w in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps // k_steps):
            state, metrics = step(state, batch, MODE, noise)
        sync()
        loss = last_loss(metrics)  # the host fetch closes the window
        dt = time.perf_counter() - t0
        window_cps.append(batch_size * steps / dt)
        log(f"bench_torch: window {w}: {window_cps[-1]:.1f} clips/s "
            f"({dt / steps * 1e3:.2f} ms/step, loss {loss:.5f})")
    timed = steps * windows
    kernels = {name: getattr(obj, attr) / timed
               for name, (obj, attr) in counters.items()}
    med = statistics.median(window_cps)
    route = "kernel" if on_card else "plain"
    prof = None
    if profile and on_card:
        prof = profile_step(lambda: step(state, batch, MODE, noise),
                            k_steps)
    return {
        "metric": ("av_clips_per_sec_per_chip" if on_card
                   else "av_clips_per_sec_cpu_plain"),
        "value": med,
        "unit": "clips/s/chip" if on_card else "clips/s (cpu, plain)",
        "spread": (max(window_cps) - min(window_cps)) / med if med else 0.0,
        "windows": window_cps,
        "step_ms": batch_size / med * 1e3,
        "batch": batch_size, "steps": steps, "warmup": warmup,
        "n_windows": windows, "mode": MODE, "dtype": cfg.dtype,
        "regime": regime, "window_mode": window_mode, "multistep": k_steps,
        "pgram_cache": cfg.pgram_cache,
        "lstm": env.get("MAAVSS_LSTM", "auto"),
        "microbatch": cfg.microbatch, "fused_opt": cfg.fused_opt,
        "opt_kernel": cfg.opt_kernel, "pgenc_kernel": cfg.pgenc_kernel,
        "stft_fold": cfg.stft_fold, "stft_impl": route, "mask_impl": route,
        "epilogue": route, "frames_encode": cfg.frames_encode,
        "frames_halo": cfg.frames_halo, "fusion_encode": cfg.fusion_encode,
        "fullenc_loss": env.get("MAAVSS_FULLENC_LOSS", "auto"),
        "fullenc_loss_resolved": (fullenc_loss_impl()
                                  if cfg.fusion_encode == "full"
                                  and regime == "fusion" else None),
        "mask_head": cfg.mask_head, "remat": False,
        "kernels": kernels, "profile": prof,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if on_card else None),
        "peak_reserved_bytes": (torch.cuda.max_memory_reserved(dev)
                                if on_card else None),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": torch.cuda.device_count() if on_card else 0},
        **(smi() if on_card else {"name": None, "power_limit": None}),
        "differs_from_bench_py": list(DIFFERS),
    }


def with_baseline(result: Dict) -> Dict:
    """bench.py's baseline keys: vs_baseline against the pinned torch-CPU
    leg of benchmarks/baseline_pin.json, no fresh leg."""
    with open(PIN) as f:
        pinned = json.load(f)["torch_cpu_clips_per_sec"]
    return {**result, "vs_baseline": result["value"] / pinned,
            "vs_baseline_fresh": None, "baseline_pinned_cps": pinned,
            "baseline_fresh_cps": None}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the benchmark); cpu runs the plain versions "
                        "for the tests")
    p.add_argument("--profile", action="store_true",
                   help="after the timed windows, one more step under "
                        "torch.profiler: device busy, idle share, launches, "
                        "the top kernels")
    own = p.parse_args(argv)
    windows_raw = os.environ.get("MAAVSS_BENCH_WINDOWS", "3")
    try:
        windows = int(windows_raw)
    except ValueError:
        raise SystemExit(
            f"MAAVSS_BENCH_WINDOWS={windows_raw!r} must be an integer window "
            "COUNT; the window MODE (scan|vectorized) is "
            "MAAVSS_BENCH_WINDOW_MODE")
    load_before = os.getloadavg()[0]
    result = measure(int(os.environ.get("MAAVSS_BENCH_BATCH", "256")),
                     int(os.environ.get("MAAVSS_BENCH_STEPS", "50")),
                     windows, device=own.device, profile=own.profile)
    host_load = max(load_before, os.getloadavg()[0])
    result = with_baseline(result)
    result.update(host_load=host_load, host_contended=host_load > 1.6)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
