#!/usr/bin/env python3
"""K5's device times at the frames flagship's stages 0 and 1, and the
choices of its apply and bwd-reduce designs, on the card.

    python3 tools/k5_probe_torch.py [--tree DIR] [--iters 20]

`--tree` imports `maavss_tpu_torch` from DIR (default: this checkout), so
that a parent's sources (a commit unpacked into a git-ignored directory)
and the change's can be probed in one call; each tree builds its kernels
into its own `build/`. For fp32 and bf16 it prints one JSON line: the
device ms of each of K5's four wrappers summed over the stage-0 and
stage-1 shapes (8, 16, 8, 256, 256) and (8, 32, 8, 128, 128), gaussian y,
a third of gamma negative (`iters` back-to-back calls queued behind
torch.cuda._sleep, so the events see only the card's work; median of 5).
Where the tree plans apply (`apply_plan`), the line also holds apply at
each APPLY_ROW_STEPS of 1, 2, 4 and 8, and apply and bwd reduce from a
copy of `csrc/epilogue.cu` built with cache hints (16-byte loads by
`ld.global.nc.L1::no_allocate`, apply's sel stored by `st.global.cs`) into
`build/k5_probe/`. Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((8, 16, 8, 256, 256), (8, 32, 8, 128, 128))
# the copy with cache hints: the 16-byte loads not kept in L1
# (ld.global.nc.L1::no_allocate) and apply's sel stored as read once, later
# (st.global.cs)
STORE4_CS = """__device__ __forceinline__ void store4_cs(float* p,
                                          const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store4_cs(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&lo);
  q.y = *reinterpret_cast<const unsigned*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), q);
}

"""
HINTS = (
    ("  return __ldg(static_cast<const uint4*>(p));\n",
     "  uint4 v;\n"
     "  asm(\"ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\"\n"
     "      : \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), \"=r\"(v.w) : \"l\"(p));\n"
     "  return v;\n"),
    ("      store4(sp + at, s);", "      store4_cs(sp + at, s);"),
    ("// apply's vector path:", STORE4_CS + "// apply's vector path:"))


def device_ms(fn, iters: int) -> float:
    """Device ms per call: `iters` calls queued behind a torch.cuda._sleep
    long enough that the host runs ahead; median of 5."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(3 * host * 2e9) + 200_000)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


def hints_library(tree: str):
    """`csrc/epilogue.cu` of `tree` with the cache hints, built alone into
    a shared library with the epilogue launchers' argtypes."""
    from maavss_tpu_torch.ops import _build

    with open(os.path.join(tree, "maavss_tpu_torch", "csrc",
                           "epilogue.cu")) as f:
        src = f.read()
    for old, new in HINTS:
        if old not in src:
            raise SystemExit(f"k5 probe: {old!r} is not in epilogue.cu")
        src = src.replace(old, new)
    out = os.path.join(tree, "build", "k5_probe")
    os.makedirs(out, exist_ok=True)
    cu, lib = os.path.join(out, "epilogue.cu"), os.path.join(out, "lib.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
                    cu], check=True, capture_output=True, text=True)
    variant = ctypes.CDLL(lib)
    for name in ("maavss_epilogue_apply", "maavss_epilogue_bwd_reduce"):
        real = getattr(_build.library(), name)
        fn = getattr(variant, name)
        fn.argtypes, fn.restype = real.argtypes, real.restype
    return variant


def probe(dtype, iters: int, variant) -> dict:
    import torch

    from maavss_tpu_torch.ops import _build
    from maavss_tpu_torch.ops import cuda_epilogue as ep

    g = torch.Generator(device="cuda").manual_seed(6)
    planned = hasattr(ep, "apply_plan")
    res = {"dtype": str(dtype), "shapes": [list(s) for s in SHAPES]}

    def add(key, ms):
        res[key] = res.get(key, 0.0) + ms

    for shape in SHAPES:
        b, c, t, h, w = shape
        y = (torch.randn(shape, device="cuda", generator=g) * 0.7).to(dtype)
        gamma = 0.8 * torch.randn(c, device="cuda", generator=g)
        gamma[: c // 3] = -gamma[: c // 3].abs() - 0.1
        beta = 0.3 * torch.randn(c, device="cuda", generator=g)
        g_out = torch.randn((b, c, t, h // 2, w // 2), device="cuda",
                            generator=g).to(dtype)
        g_mu, g_var = (torch.randn(c, device="cuda", generator=g)
                       for _ in range(2))
        mu, _, rstd = ep.epilogue_stats(y)
        _, sel = ep.epilogue_apply(y, gamma, beta, mu, rstd)
        red_args = (g_out, sel, gamma, beta, mu, rstd, g_mu, g_var)
        k = ep.epilogue_bwd_reduce(*red_args)[2]
        calls = {
            "stats": lambda: ep.epilogue_stats(y),
            "apply": lambda: ep.epilogue_apply(y, gamma, beta, mu, rstd),
            "bwd_reduce": lambda: ep.epilogue_bwd_reduce(*red_args),
            "bwd_dy": lambda: ep.epilogue_bwd_dy(y, g_out, sel, gamma, beta,
                                                 mu, rstd, k)}
        for name, fn in calls.items():
            add(f"{name}_ms", device_ms(fn, iters))
        if not planned:
            continue
        kept = ep.APPLY_ROW_STEPS
        try:
            for steps in (1, 2, 4, 8):
                ep.APPLY_ROW_STEPS = steps
                add(f"apply_row_steps_{steps}_ms",
                    device_ms(calls["apply"], iters))
        finally:
            ep.APPLY_ROW_STEPS = kept
        library = _build.library
        _build.library = lambda: variant
        try:
            for name in ("apply", "bwd_reduce"):
                add(f"{name}_hints_ms", device_ms(calls[name], iters))
        finally:
            _build.library = library
    if planned:
        res.update(apply_row_steps=ep.APPLY_ROW_STEPS)
    return res


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=ROOT)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from maavss_tpu_torch.ops import cuda_epilogue as ep

    if not torch.cuda.is_available():
        raise SystemExit("k5 probe: needs an NVIDIA GPU")
    variant = hints_library(tree) if hasattr(ep, "apply_plan") else None
    for dtype in (torch.float32, torch.bfloat16):
        print(json.dumps({"tree": tree, **probe(dtype, args.iters,
                                                 variant)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
