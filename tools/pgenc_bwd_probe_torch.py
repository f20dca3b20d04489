#!/usr/bin/env python3
"""Where K2-bwd's device time goes, layer by layer, on the card.

    python3 tools/pgenc_bwd_probe_torch.py [--rows 64] [--iters 50]

Builds csrc/pgenc_train.cu six times with nvcc (into build/pgenc_probe/):
as it is; with the grads kernel's dx role, its dW2 role or both compiled
out (the BatchNorm kernel always runs); with dW2's last-block sum of the
split tiles cut (`no_last_sum`), and with everything after its in-block
tree cut (`no_split_tail`: no partial tile, counter or sum; one value is
stored so that the work stays live). For each of the fusion
flagship's 10 encoder layers at R = --rows, fp32, it times `--iters`
back-to-back calls of each build's `maavss_pgenc_train_bwd` on the same
buffers with CUDA events (bounded below by the host's ~15 us per call) and
takes the grads kernel's device time per launch from torch.profiler over
10 calls; it prints one JSON line per layer with microseconds per call per
variant, the SM clocks and power sampled meanwhile, and the card's name
and power limit. The variants' differences split a layer's time between
the BN kernel, dx, dW2 and dW2's split-K tail.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DX_CALL = "dx_role<T, TM>(dyc, w2, dx, d, px, b, smem);"
DW_CALL = ("dw_role<T, TMO, TCI>(dyc, x, dw2, partial, counts, d, pw, "
           "t / pw.splits,\n                       t % pw.splits, smem);")
LAST = ("  if (!last) return;", "  return;")
TAIL = ("  float* mine = partial",
        "  if (threadIdx.x == 0) store_f(dw2, red[0]);\n  return;\n"
        "  float* mine = partial")
VARIANTS = {"full": (), "no_dw2": ((DW_CALL, ""),), "no_dx": ((DX_CALL, ""),),
            "bn_only": ((DX_CALL, ""), (DW_CALL, "")),
            "no_last_sum": (LAST,), "no_split_tail": (TAIL,)}


def grads_us(call, calls: int = 10) -> float:
    """Mean device microseconds per launch of grads_kernel over `calls`
    calls, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "grads_kernel" in e.key]
    return sum(e.device_time_total for e in ev) / max(1, sum(e.count
                                                          for e in ev))


def build(out_dir: str) -> dict:
    from maavss_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "pgenc_train.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, cut in VARIANTS.items():
        text = src
        for old, new in cut:
            if text.count(old) != 1:
                raise SystemExit(f"probe: {old!r} not once in pgenc_train.cu")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.maavss_pgenc_train_bwd.argtypes = [p] * 12 + [i] * 5 + [p]
        lib.maavss_pgenc_train_bwd.restype = i
        lib.maavss_pgenc_train_bwd_scratch.argtypes = [i] * 4
        lib.maavss_pgenc_train_bwd_scratch.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.models.shape_plan import plan_phasegram_encoder
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_train

    if not torch.cuda.is_available():
        raise SystemExit("pgenc_bwd_probe: needs an NVIDIA GPU")
    libs = build(os.path.join(ROOT, "build", "pgenc_probe"))
    # the SM clock and power, sampled every 200 ms while the layers run
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "200"], stdout=subprocess.PIPE,
        text=True)
    cfg = RunConfig()
    specs, _ = plan_phasegram_encoder(
        (8, 1, cfg.num_frames, cfg.p_size ** 2), cfg.latent_chan, cfg.fc_size)
    g = torch.Generator(device="cuda").manual_seed(11)
    s, r = cfg.p_size ** 2, args.rows
    stream = torch.cuda.current_stream().cuda_stream
    for layer, sp in enumerate(specs):
        c, co = sp.in_ch, sp.out_ch
        x = torch.randn(c, r, s, device="cuda", generator=g)
        w2 = torch.randn(co, 9 * c, device="cuda", generator=g) / (3 * c ** .5)
        cb, beta = (torch.randn(co, device="cuda", generator=g) * 0.1
                    for _ in range(2))
        gamma = 1.0 + 0.1 * torch.randn(co, device="cuda", generator=g)
        y, mu, var, yc = pgenc_train(x, w2, cb, gamma, beta, backend="kernel")
        dy = torch.randn(y.shape, device="cuda", generator=g)
        scratch = torch.empty(
            libs["full"].maavss_pgenc_train_bwd_scratch(c, r, s, co),
            dtype=torch.uint8, device="cuda")
        dx, dw2 = torch.empty_like(x), torch.empty_like(w2)
        vec3 = torch.empty(3, co, device="cuda")
        ptrs = [t.data_ptr() for t in (x, w2, yc, gamma, beta, mu, var, dy,
                                       scratch, dx, dw2, vec3)]
        row = {"layer": layer, "C": c, "Co": co, "S": s, "R": r}
        for name, lib in libs.items():
            def call():
                err = lib.maavss_pgenc_train_bwd(*ptrs, c, r, s, co, 0,
                                                 stream)
                if err:
                    raise SystemExit(f"probe: {name} layer {layer}: {err}")
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                call()
            stop.record()
            torch.cuda.synchronize()
            row[f"{name}_us"] = start.elapsed_time(stop) * 1e3 / args.iters
            row[f"{name}_grads_kernel_us"] = grads_us(call)
        print(json.dumps(row), flush=True)
        s //= 2
    smi.terminate()
    samples = smi.communicate()[0].split("\n")
    print(json.dumps({"clocks.sm, clocks.max.sm, power.draw": sorted(
        set(x.strip() for x in samples if x.strip()))}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
