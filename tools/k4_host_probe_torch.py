#!/usr/bin/env python3
"""Where the host time of the K4 polar wrapper goes, on the card.

    python3 tools/k4_host_probe_torch.py [--calls 1000]

Times, with time.perf_counter around `--calls` back-to-back calls (no
synchronisation inside the loop), the host cost per call of each piece of
`ops/cuda_complex.polar_spectrum_fwd` at the fusion flagship's clip
features [8, 2, 96, 128] (Nyquist trimmed, one zero bin padded), of the
whole wrapper, of `torch.polar` on the same planes, and of the iSTFT
prelude the spectrum form replaces (planar (re, im), here `polar_to_rect`,
the spectrum's real view, then two plane copies, torch.complex and
F.pad). Prints one JSON line, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def per_call_us(fn, calls: int) -> float:
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _in_device(torch, dev) -> None:
    with torch.cuda.device(dev):
        pass


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    from maavss_tpu_torch.ops import _build
    from maavss_tpu_torch.ops import cuda_complex as cc

    if not torch.cuda.is_available():
        raise SystemExit("k4_host_probe: needs an NVIDIA GPU")
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randn(8, 2, 96, 128, device=dev)
    lay = cc._layout(x)
    out = torch.empty(8, 96, 129, dtype=torch.complex64, device=dev)
    fn = _build.library().maavss_polar_spectrum
    launch_args = (x.data_ptr(), *lay[1:], out.data_ptr(), lay[0], 96, 128,
                   129)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def old_prelude():
        rect = cc.polar_to_rect(x)
        spec = torch.complex(rect[..., 0, :, :].contiguous(),
                             rect[..., 1, :, :].contiguous())
        return F.pad(spec, (0, 1))

    pieces = {
        "torch.empty complex64": lambda: torch.empty(
            (8, 96, 129), dtype=torch.complex64, device=dev),
        "x.device": lambda: x.device,
        "x.is_contiguous()": x.is_contiguous,
        "x.data_ptr()": x.data_ptr,
        "_layout(x)": lambda: cc._layout(x),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "raw current stream": lambda: _build._raw_stream(dev.index),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "with torch.cuda.device": lambda: _in_device(torch, dev),
        "ctypes launch (10 args + stream)": lambda: fn(*launch_args, stream),
        "_build.launch": lambda: _build.launch(
            "maavss_polar_spectrum", dev, launch_args),
        "polar_spectrum_fwd (whole wrapper)": lambda: cc.polar_spectrum_fwd(
            x, 1),
        "polar_to_rect (the spectrum's planar view)":
            lambda: cc.polar_to_rect(x),
        "torch.polar": lambda: torch.polar(x[:, 0], x[:, 1]),
        "planar iSTFT prelude (polar_to_rect + 2 copies + complex + pad)":
            old_prelude,
    }
    us = {k: per_call_us(v, args.calls) for k, v in pieces.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"probe": "k4_host", "calls": args.calls,
                      "host_us_per_call": us}))
    print(smi)


if __name__ == "__main__":
    main()
