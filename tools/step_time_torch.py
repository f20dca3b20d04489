#!/usr/bin/env python3
"""End-to-end times of a tree of the port on the card: the fusion train
step, the direct serving call and the frames train step, each with its
device busy time and the K1 kernels' share of it; then the fusion step with
`--mask_head` and the fusion serving call with `--use_polar` (K4's paths).

    python3 tools/step_time_torch.py [--tree DIR]

`--tree` imports `maavss_tpu_torch` from DIR (default: this checkout), so
that two trees (say a parent commit unpacked into a git-ignored directory
and the change) can be compared on one card in one call, in turns: parent,
change, change, parent. Each tree builds its kernels into its own
`build/`. The flagships at full width with seeded random weights, batch 8,
mode 2: the fusion step (scan windows) and the serving function timed by
CUDA events (median of 3 rounds of 2 steps / 5 calls, after a warm-up),
the frames step (median of 3 single steps), the --mask_head fusion step
and the --use_polar serving call as their default-head counterparts; then
one torch.profiler window of each gives the device busy ms (CUDA kernel
time summed), the kernel launches, the K1 kernels' ms (names starting
`lstm`) and, for the fusion model, K2's (`K2_KERNELS`). Before them, the host microseconds of
one call of the K1 forward's wrapper, `lstm_bidir` at B = 8, T = 8,
H = 256 fp32, as serving calls it (no_grad) and as training does (w_h
requires a gradient): the median of 5 rounds of 200 calls enqueued without
a sync, on the host clock. One JSON line, then the card's name and power
limit.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(fn, reps: int, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


# K2's kernels in either form: the three-launch forward and the earlier
# K2-eval (pgenc_eval_kernel, conv_kernel, stats_kernel, apply_kernel), the
# one-launch forms (conv_bn_eval_kernel, conv_bn_train_kernel), and
# K2-bwd (bn_bwd_kernel, grads_kernel); read on the fusion model only (K5
# of the frames model has an apply_kernel too)
K2_KERNELS = re.compile(r"\b(pgenc_eval_kernel|conv_kernel|stats_kernel|"
                        r"apply_kernel|conv_bn_\w+_kernel|bn_bwd_kernel|"
                        r"grads_kernel)\b")


def busy_ms(fn):
    """(device busy ms, K1 device ms, wall ms, kernel launches, K2 device
    ms) of one call of `fn`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    k1 = [e for e in ev if "lstm" in e.key]
    k2 = [e for e in ev if K2_KERNELS.search(e.key)]
    return (sum(e.device_time_total for e in ev) / 1e3,
            sum(e.device_time_total for e in k1) / 1e3, wall,
            sum(e.count for e in ev),
            sum(e.device_time_total for e in k2) / 1e3)


def wrapper_host_us(fn, rounds: int = 5, calls: int = 200) -> float:
    """Median host microseconds per call of `fn` (enqueue only)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=ROOT)
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    import maavss_tpu_torch
    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.exp.export import (
        make_serving_fn,
        random_serving_inputs,
    )
    from maavss_tpu_torch.train.setup import (
        build_frames_state,
        build_fusion,
        build_fusion_state,
    )
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step

    if not maavss_tpu_torch.__file__.startswith(tree + os.sep):
        raise SystemExit(f"imported {maavss_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("step_time: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"tree": os.path.relpath(tree, ROOT)}
    from maavss_tpu_torch.ops.cuda_lstm import lstm_bidir

    g = torch.Generator(device="cuda").manual_seed(0)
    xw = torch.randn(8, 8, 1024, device="cuda", generator=g)
    wh = torch.randn(256, 1024, device="cuda", generator=g) / 16
    with torch.no_grad():
        out["k1_fwd_host_us_eval"] = wrapper_host_us(
            lambda: lstm_bidir(xw, xw, wh, wh, backend="kernel"))
    wh_g = wh.clone().requires_grad_(True)
    out["k1_fwd_host_us_train"] = wrapper_host_us(
        lambda: lstm_bidir(xw, xw, wh_g, wh_g, backend="kernel"))
    batch = 8
    cfg = RunConfig(batch_size=batch, noise_scalar=0.0, learning_rate=1e-3)

    model, state = build_fusion_state(cfg, batch, "cuda",
                                      torch.Generator().manual_seed(cfg.seed))
    step = make_fusion_step(model, cfg, device="cuda")
    data = synthetic_av_batch(cfg, batch, seed=cfg.seed)
    out["fusion_step_ms"] = cuda_ms(lambda: step(state, data, 2), 3, 2)
    (out["fusion_device_busy_ms"], out["fusion_k1_device_ms"],
     out["fusion_traced_wall_ms"], out["fusion_launches"],
     out["fusion_k2_device_ms"]) = busy_ms(lambda: step(state, data, 2))
    serve = make_serving_fn(model, cfg)
    dev = [torch.from_numpy(x).cuda()
           for x in random_serving_inputs(cfg, batch)]
    out["serve_ms"] = cuda_ms(lambda: serve(*dev), 3, 5)
    (out["serve_device_busy_ms"], out["serve_k1_device_ms"],
     out["serve_traced_wall_ms"], out["serve_launches"],
     out["serve_k2_device_ms"]) = busy_ms(lambda: serve(*dev))
    del model, state, step, serve

    model, state = build_frames_state(
        cfg, batch, generator=torch.Generator().manual_seed(cfg.seed))
    step = make_frames_step(model, cfg)
    data = synthetic_av_batch(cfg, batch, seed=cfg.seed,
                              frame_size=cfg.framesize)
    out["frames_step_ms"] = cuda_ms(lambda: step(state, data, 2), 3, 1)
    (out["frames_device_busy_ms"], out["frames_k1_device_ms"],
     out["frames_traced_wall_ms"], out["frames_launches"],
     _) = busy_ms(lambda: step(state, data, 2))
    del model, state, step

    mask_cfg = cfg.replace(mask_head=True)
    model, state = build_fusion_state(mask_cfg, batch, "cuda",
                                      torch.Generator().manual_seed(cfg.seed))
    step = make_fusion_step(model, mask_cfg, device="cuda")
    data = synthetic_av_batch(cfg, batch, seed=cfg.seed)
    out["mask_fusion_step_ms"] = cuda_ms(lambda: step(state, data, 2), 3, 2)
    (out["mask_fusion_device_busy_ms"], _, out["mask_fusion_traced_wall_ms"],
     out["mask_fusion_launches"], _) = busy_ms(lambda: step(state, data, 2))
    del model, state, step
    polar_cfg = cfg.replace(use_polar=True)
    model = build_fusion(polar_cfg, batch, "cuda",
                         torch.Generator().manual_seed(cfg.seed))
    serve = make_serving_fn(model, polar_cfg)
    out["polar_serve_ms"] = cuda_ms(lambda: serve(*dev), 3, 5)
    (out["polar_serve_device_busy_ms"], _, out["polar_serve_traced_wall_ms"],
     out["polar_serve_launches"], _) = busy_ms(lambda: serve(*dev))
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
