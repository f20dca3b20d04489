#!/usr/bin/env python3
"""Where K2's forward device time goes, layer by layer, on the card.

    python3 tools/pgenc_fwd_probe_torch.py [--tree DIR] [--rows 64 256]
        [--iters 50] [--sweep]

`--tree` imports `maavss_tpu_torch` from DIR (default: this checkout), so
that the parent's sources (a commit unpacked into a git-ignored directory)
and the change's can be probed in one call; each tree builds its kernels
into its own `build/`. For each of the fusion flagship's 10 encoder layers
at every R of `--rows`, fp32, it prints one JSON line: the device
microseconds per call of K2-eval (`pgenc_layer`) and of K2-train's forward
(`pgenc_train`), from CUDA events around `--iters` back-to-back calls
queued behind `torch.cuda._sleep` (the card's work alone), and each
kernel's device microseconds per launch from torch.profiler (three for
the three-launch forward, one for the one-launch forward). Where the
tree's `pgenc_train.cu` holds the one-launch forward
(`conv_bn_train_kernel`), it also builds three cut copies of that source
with nvcc into `build/pgenc_fwd_probe/`: `conv` returns at the grid
barrier (the conv, yc and the tiles' partial sums), `conv_sync` just after
it, `conv_stats` skips the normalise (adds the channel statistics); with
the full kernel their times split the forward into conv, barrier,
statistics and normalise.
`--sweep` also times, for each layer, every tile plan that `pgenc_plan`
gives when this process sets its aims (TARGET_TILES, MIN_CI, BC_MAX, with
BC_MAX then for every R) to other values, eval and train, and after each R
the settings whose plans give the least time over the ten layers. Then the SM clocks and power
sampled meanwhile, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRID_SYNC = "  cg::this_grid().sync();\n"
PHASE_2 = "  int cb = -1;\n"
NORMALISE = ("    normalise<T, TC>(a, t, q, acc, ti == t1 - 1, cmu, cinv, "
             "cgam, cbet);\n")
VARIANTS = {"conv": (GRID_SYNC, "  return;\n" + GRID_SYNC),
            "conv_sync": (PHASE_2, "  return;\n" + PHASE_2),
            "conv_stats": (NORMALISE, "")}
KNOBS = [(target, min_ci, bc_max) for target in (16, 33, 66, 132, 264, 528)
         for min_ci in (1, 2, 4, 8, 16) for bc_max in (4, 8, 16, 32)]


def device_us(fn, iters: int) -> float:
    """Device microseconds per call: `iters` calls queued behind a
    torch.cuda._sleep long enough that the host runs ahead, so the events
    around them see only the card's work."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(3 * host * 2e9) + 200_000)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(stop) * 1e3 / iters
        best = us if best is None else min(best, us)
    return best


def kernel_us(fn, calls: int = 10) -> dict:
    """{kernel name: device microseconds per launch} from torch.profiler."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            name = re.search(r"(\w+)(<[^(]*)?\(", e.key)
            out[name.group(1) if name else e.key[:40]] = round(
                e.device_time_total / e.count, 3)
    return out


def build_variants(tree: str) -> dict:
    """The cut copies of the tree's pgenc_train.cu, each its own library;
    {} where the tree has no one-launch forward."""
    csrc = os.path.join(tree, "maavss_tpu_torch", "csrc")
    with open(os.path.join(csrc, "pgenc_train.cu")) as f:
        src = f.read()
    if "conv_bn_train_kernel" not in src:
        return {}
    from maavss_tpu_torch.ops import _build

    out_dir = os.path.join(tree, "build", "pgenc_fwd_probe")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise SystemExit(f"probe: {old!r} not once in pgenc_train.cu")
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src.replace(old, new))
        so = os.path.join(out_dir, f"{name}.so")
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-shared", "-o",
             so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.maavss_pgenc_train_fwd.argtypes = [p] * 10 + [i] * 11 + [p]
        lib.maavss_pgenc_train_fwd.restype = i
        lib.maavss_pgenc_train_resident.argtypes = [i] * 4
        lib.maavss_pgenc_train_resident.restype = i
        libs[name] = lib
    return libs


def variant_call(lib, name, x, w2, vecs, plan):
    """A call of a cut copy's train forward at `plan`, on its own grid."""
    import torch

    c, r, s = x.shape
    co = w2.shape[0]
    resident = lib.maavss_pgenc_train_resident(plan.tc, 0, plan.threads,
                                               plan.smem)
    if resident <= 0:
        raise SystemExit(f"probe: {name}: resident {resident}")
    grid = min(plan.tiles, resident)
    yc = torch.empty(co, r, s // 2, device="cuda")
    y = torch.empty_like(yc)
    stats = torch.empty(2 * co * (1 + plan.per_cb), device="cuda")
    ptrs = [t.data_ptr() for t in (x, w2, *vecs, yc, y)] + [
        stats.data_ptr(), stats[co:].data_ptr(), stats[2 * co:].data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.maavss_pgenc_train_fwd(*ptrs, c, r, s, co, 0, plan.tc,
                                         plan.bc, plan.br, plan.bs, plan.g,
                                         grid, stream)
        if err:
            raise SystemExit(f"probe: {name}: cudaError_t {err}")
    return call


def knob_plan(mod, c, r, s, co, target, min_ci, bc_max):
    """pgenc_plan's plan with its aims set to (target, min_ci, bc_max) and
    bc_max taken for every R; the module's constants are restored."""
    names = ("TARGET_TILES", "MIN_CI", "BC_MAX", "WIDE_CHANNEL")
    saved = [getattr(mod, n) for n in names]
    for n, v in zip(names, (target, min_ci, bc_max, 0)):
        setattr(mod, n, v)
    try:
        return mod.pgenc_plan.__wrapped__(c, r, s, co)
    finally:
        for n, v in zip(names, saved):
            setattr(mod, n, v)


def sweep(mod, x, w2, vecs5, iters):
    """Every plan of the KNOBS settings for this layer -> its eval and
    train device us, with the settings that give it."""
    c, r, s = x.shape
    co = w2.shape[0]
    plans = {}
    for knobs in KNOBS:
        try:
            p = knob_plan(mod, c, r, s, co, *knobs)
        except ValueError:
            continue
        plans.setdefault(p, []).append(knobs)
    rows = []
    for p, knobs in plans.items():
        grid = mod.train_grid(p, mod._resident_blocks(0, p.tc, 0, p.threads,
                                                      p.smem))
        rows.append({
            "plan": [p.tc, p.bc, p.br, p.bs, p.g], "threads": p.threads,
            "smem": p.smem, "tiles": p.tiles, "grid": grid, "knobs": knobs,
            "eval_us": round(device_us(
                lambda: mod._eval_launch(x, w2, vecs5, p), iters), 2),
            "train_us": round(device_us(
                lambda: mod._train_launch(x, w2, vecs5[:3], p, grid), iters),
                2)})
    return sorted(rows, key=lambda d: d["eval_us"] + d["train_us"])


def best_knobs(rows_by_layer, top=8):
    """The knob settings with the least eval + train us over the layers."""
    total = {}
    for rows in rows_by_layer:
        for row in rows:
            for knobs in row["knobs"]:
                e, t, n = total.get(tuple(knobs), (0.0, 0.0, 0))
                total[tuple(knobs)] = (e + row["eval_us"],
                                       t + row["train_us"], n + 1)
    return sorted(([list(k), round(e, 2), round(t, 2)]
                   for k, (e, t, n) in total.items()
                   if n == len(rows_by_layer)),
                  key=lambda v: v[1] + v[2])[:top]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--rows", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import maavss_tpu_torch
    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.models.shape_plan import plan_phasegram_encoder
    from maavss_tpu_torch.ops import cuda_pgenc
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer, pgenc_train

    if not maavss_tpu_torch.__file__.startswith(tree + os.sep):
        raise SystemExit(f"imported {maavss_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("pgenc_fwd_probe: needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    libs = build_variants(tree)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "200"], stdout=subprocess.PIPE,
        text=True)
    cfg = RunConfig()
    specs, _ = plan_phasegram_encoder(
        (8, 1, cfg.num_frames, cfg.p_size ** 2), cfg.latent_chan, cfg.fc_size)
    g = torch.Generator(device="cuda").manual_seed(11)
    tag = os.path.relpath(tree, ROOT)
    for r in args.rows:
        s = cfg.p_size ** 2
        totals = {"eval_us": 0.0, "train_us": 0.0}
        swept = []
        for layer, sp in enumerate(specs):
            c, co = sp.in_ch, sp.out_ch
            x = torch.randn(c, r, s, device="cuda", generator=g)
            w2 = torch.randn(co, 9 * c, device="cuda", generator=g) / (
                3 * c ** 0.5)
            cb, beta, mean = (torch.randn(co, device="cuda", generator=g)
                              * 0.1 for _ in range(3))
            gamma = 1.0 + 0.1 * torch.randn(co, device="cuda", generator=g)
            var = 0.5 + torch.rand(co, device="cuda", generator=g)
            vecs = (cb, gamma, beta)

            def ev():
                return pgenc_layer(x, w2, *vecs, mean, var, backend="kernel")

            def tr():
                return pgenc_train(x, w2, *vecs, backend="kernel")

            row = {"tree": tag, "layer": layer, "C": c, "Co": co, "S": s,
                   "R": r, "eval_us": round(device_us(ev, args.iters), 2),
                   "train_us": round(device_us(tr, args.iters), 2),
                   "eval_kernels_us": kernel_us(ev),
                   "train_kernels_us": kernel_us(tr)}
            totals["eval_us"] += row["eval_us"]
            totals["train_us"] += row["train_us"]
            if hasattr(cuda_pgenc, "pgenc_plan"):
                p = cuda_pgenc.pgenc_plan(c, r, s, co)
                row["plan"] = [p.tc, p.bc, p.br, p.bs, p.g]
                row["threads"], row["smem"], row["tiles"] = (
                    p.threads, p.smem, p.tiles)
                row["grid"] = cuda_pgenc.train_grid(
                    p, cuda_pgenc._resident_blocks(0, p.tc, 0, p.threads,
                                                   p.smem))
                for name, lib in libs.items():
                    row[f"train_{name}_us"] = round(device_us(
                        variant_call(lib, name, x, w2, vecs, p), args.iters),
                        2)
                if args.sweep:
                    row["sweep"] = sweep(cuda_pgenc, x, w2,
                                         (*vecs, mean, var), args.iters)
                    swept.append(row["sweep"])
            print(json.dumps(row), flush=True)
            s //= 2
        print(json.dumps({"tree": tag, "R": r, "layers": len(specs),
                          **{k: round(v, 2) for k, v in totals.items()}}),
              flush=True)
        if swept:
            print(json.dumps({"R": r, "best_knobs (target, min_ci, bc_max), "
                              "eval us, train us": best_knobs(swept)}),
                  flush=True)
    smi.terminate()
    samples = smi.communicate()[0].split("\n")
    print(json.dumps({"clocks.sm, clocks.max.sm, power.draw": sorted(
        set(x.strip() for x in samples if x.strip()))}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
