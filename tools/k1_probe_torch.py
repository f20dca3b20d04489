#!/usr/bin/env python3
"""K1's cluster geometry on the card: device time of the LSTM forward and
its BPTT (sweep and dW_h apart) for each cluster size and rows per cluster.

    python3 tools/k1_probe_torch.py [--calls 20] [--shapes 8x8,32x8]

For each (B, T) of `--shapes` (default chip_smoke.py's K1_SHAPES) at
H = 256, fp32, both directions, and each geometry with a cluster of 8 or
16 CTAs and 1, 2, 4 or 8 batch rows per cluster that fits shared memory,
it runs both kernels with that geometry in place of `lstm_geometry`'s
choice, holds them against the plain versions (chip_smoke's fp32
tolerances), and takes each kernel's mean device microseconds per launch
over `--calls` calls from torch.profiler. The cluster size is a constant
of csrc/lstm_cluster.cuh: the 8-CTA runs use a second build of the K1
sources with it set to 8 (into build/k1_probe/), loaded in place of the
kernel library. First a line with the count of 16-CTA clusters the card
runs side by side; then one JSON line per (shape, geometry), marking the
geometry `lstm_geometry` picks on this card; then ptxas' registers and
spills of the K1 kernels, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


CLUSTER_LINE = "constexpr int kCluster = 16;"


def candidates(h: int):
    from maavss_tpu_torch.ops import cuda_lstm

    for cluster in (8, 16):
        for rows in (1, 2, 4, 8):
            fwd, bwd = cuda_lstm._smem_bytes(h, rows, cluster)
            if max(fwd, bwd) > cuda_lstm.SMEM_MAX:
                continue
            yield cluster, rows, fwd, bwd


def cluster8_library():
    """The K1 launchers built with kCluster = 8, loaded with the kernel
    library's argument types."""
    import ctypes

    from maavss_tpu_torch.ops import _build

    out = os.path.join(ROOT, "build", "k1_probe")
    os.makedirs(out, exist_ok=True)
    for name in ("lstm_cluster.cuh", "lstm_fwd.cu", "lstm_bwd.cu"):
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            text = f.read()
        if name == "lstm_cluster.cuh":
            if text.count(CLUSTER_LINE) != 1:
                raise SystemExit(f"probe: {CLUSTER_LINE!r} not once in "
                                 f"{name}")
            text = text.replace(CLUSTER_LINE, "constexpr int kCluster = 8;")
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    so = os.path.join(out, "lstm_c8.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
           os.path.join(out, "lstm_fwd.cu"), os.path.join(out, "lstm_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise SystemExit(f"probe: nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib, main_lib = ctypes.CDLL(so), _build.library()
    for sym in ("maavss_lstm_fwd", "maavss_lstm_bwd"):
        getattr(lib, sym).argtypes = getattr(main_lib, sym).argtypes
        getattr(lib, sym).restype = getattr(main_lib, sym).restype
    return lib


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--shapes", default=None,
                        help="comma-separated BxT (default: K1_SHAPES)")
    args = parser.parse_args()

    import torch

    from chip_smoke import K1_SHAPES, _k1_inputs, check_close, kernel_us
    from maavss_tpu_torch.ops import _build, cuda_lstm

    if not torch.cuda.is_available():
        raise SystemExit("k1_probe: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    build = _build.build()
    libs = {16: _build.library(), 8: cluster8_library()}
    h = 256
    at_once = cuda_lstm._clusters_at_once(0)
    print(json.dumps({"clusters_at_once": at_once}), flush=True)
    chosen, library = cuda_lstm.lstm_geometry, _build.library
    g = torch.Generator(device="cuda").manual_seed(11)
    rev = [False, True]
    shapes = K1_SHAPES if args.shapes is None else [
        tuple(int(v) for v in bt.split("x")) for bt in args.shapes.split(",")]
    for b, t_len in shapes:
        xws, whs, dys = _k1_inputs(b, t_len, torch.float32, g, h)
        want_f = [cuda_lstm.lstm_recurrence_plain(x, w, r)
                  for x, w, r in zip(xws, whs, rev)]
        want_b = [cuda_lstm.lstm_recurrence_bwd_plain(f[2], w, f[0], f[1],
                                                      d, r)
                  for f, w, d, r in zip(want_f, whs, dys, rev)]
        pick = chosen(b, h, clusters=at_once)
        for cluster, rows, fwd_smem, bwd_smem in candidates(h):
            geo = cuda_lstm.LstmGeometry(rows, -(-b // rows), fwd_smem,
                                         bwd_smem)
            cuda_lstm.lstm_geometry = lambda *a, _g=geo, **k: _g
            _build.library = lambda _l=libs[cluster]: _l
            try:
                fwd = cuda_lstm.lstm_recurrence(xws, whs, rev,
                                                backend="kernel")
                bwd = cuda_lstm.lstm_recurrence_bwd(
                    [f[2] for f in want_f], whs, [f[0] for f in want_f],
                    [f[1] for f in want_f], dys, rev, backend="kernel")
                torch.cuda.synchronize()
                err = 0.0
                for got, ref in zip(fwd, want_f):
                    for a, w in zip(got, ref):
                        err = max(err, check_close("K1-fwd", a, w, 1e-5,
                                                   1e-5))
                for (dxw, dwh), (dxw_r, dwh_r) in zip(bwd, want_b):
                    err = max(err, check_close("K1-bwd dxw", dxw, dxw_r,
                                               1e-5, 1e-5))
                    check_close("K1-bwd dW_h", dwh, dwh_r, 1e-4, 1e-4,
                                scale_atol=True)
                us = kernel_us(lambda: cuda_lstm.lstm_recurrence(
                    xws, whs, rev, backend="kernel"), args.calls)
                us.update(kernel_us(lambda: cuda_lstm.lstm_recurrence_bwd(
                    [f[2] for f in fwd], whs, [f[0] for f in fwd],
                    [f[1] for f in fwd], dys, rev, backend="kernel"),
                    args.calls))
            finally:
                cuda_lstm.lstm_geometry, _build.library = chosen, library
            print(json.dumps({
                "B": b, "T": t_len, "H": h, "cluster": cluster, "rows": rows,
                "ctas": 2 * geo.groups * cluster, "fwd_smem": fwd_smem,
                "bwd_smem": bwd_smem, "picked": (cluster, rows) == (
                    cuda_lstm.CLUSTER, pick.rows),
                "max_abs_err_fwd_dxw": err,
                "device_us_per_launch": {k: v for k, v in us.items()
                                         if k.startswith("lstm")}}),
                flush=True)
    ptxas, entry = [], ""
    for ln in build.log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "lstm" in entry and ("registers" in ln or "spill" in ln):
            ptxas.append(f"{entry[:60]}: {ln.strip()}")
    print(json.dumps({"ptxas": ptxas}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
