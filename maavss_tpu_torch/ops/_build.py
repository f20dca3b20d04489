"""Build and load the hand-written CUDA kernels in `maavss_tpu_torch/csrc/`.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
interface, for Hopper only (`sm_90a`), the first time a kernel is launched:
one nvcc process per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o     (each, in parallel)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libmaavss_kernels.so *.o

The library is loaded with `ctypes`; every pointer and the stream are passed
as `c_void_p`. It lands in `build/maavss_tpu_torch/<hash>/` at the root of
the checkout, keyed by a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused. Nothing here runs at import time:
a machine without `nvcc` imports every module and only fails when a kernel
is asked for.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "maavss_tpu_torch")
LIB_NAME = "libmaavss_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: str
    seconds: float  # 0.0 when an earlier build of the same sources was reused
    log: str  # nvcc's output, with ptxas' registers and shared memory per kernel


def sources() -> List[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of maavss_tpu_torch "
                       "are built with the CUDA toolkit at first use")


def _source_hash(srcs: List[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def build() -> BuildResult:
    """Compile the kernels unless this exact build exists; return where."""
    srcs = sources()
    out_dir = os.path.join(BUILD_ROOT, _source_hash(srcs))
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return BuildResult(lib, 0.0, "")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(out_dir, os.path.basename(src)[:-3] +
                           f".{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = ""
    failed = []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *[o for _, o, _ in jobs]]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    for _, obj, _ in jobs:
        os.remove(obj)
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return BuildResult(lib, seconds, log)


@functools.lru_cache(maxsize=1)
def library():
    """The loaded kernel library, with argtypes/restype declared."""
    import ctypes

    lib = ctypes.CDLL(build().path)
    p, i = ctypes.c_void_p, ctypes.c_int
    # ..., n_dir, B, T, H, dtype, rows per cluster, stream
    lib.maavss_lstm_fwd.argtypes = ([p] * 5 + [i]) * 2 + [i] * 6 + [p]
    lib.maavss_lstm_fwd.restype = i
    # ..., C, R, S, Co, dtype, tile plan (tc, bc, br, bs, g), stream
    lib.maavss_pgenc_eval.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.maavss_pgenc_eval.restype = i
    lib.maavss_lstm_bwd.argtypes = ([p] * 8 + [i]) * 2 + [i] * 6 + [p]
    lib.maavss_lstm_bwd.restype = i
    lib.maavss_lstm_clusters_at_once.argtypes = []
    lib.maavss_lstm_clusters_at_once.restype = i
    # ..., C, R, S, Co, dtype, tile plan, grid, stream
    lib.maavss_pgenc_train_fwd.argtypes = [p] * 10 + [i] * 11 + [p]
    lib.maavss_pgenc_train_fwd.restype = i
    lib.maavss_pgenc_train_resident.argtypes = [i] * 4
    lib.maavss_pgenc_train_resident.restype = i
    lib.maavss_pgenc_train_bwd.argtypes = [p] * 12 + [i] * 5 + [p]
    lib.maavss_pgenc_train_bwd.restype = i
    lib.maavss_pgenc_train_bwd_scratch.argtypes = [i] * 4
    lib.maavss_pgenc_train_bwd_scratch.restype = ctypes.c_longlong
    # the split route (parallel/): conv, apply; bwd sums, bwd apply
    lib.maavss_pgenc_train_conv.argtypes = [p] * 5 + [i] * 12 + [p]
    lib.maavss_pgenc_train_conv.restype = i
    lib.maavss_pgenc_train_apply.argtypes = ([p] * 7 + [i] * 11
                                             + [ctypes.c_longlong, p])
    lib.maavss_pgenc_train_apply.restype = i
    lib.maavss_pgenc_train_bwd_sums.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.maavss_pgenc_train_bwd_sums.restype = i
    lib.maavss_pgenc_train_bwd_apply.argtypes = ([p] * 9 + [ctypes.c_longlong]
                                                 + [p] * 3 + [i] * 5 + [p])
    lib.maavss_pgenc_train_bwd_apply.restype = i
    f = ctypes.c_float
    # tables, [c1, c2], n_leaves, n_blocks, chunk, lr, b1, 1 - b1, b2, 1 - b2,
    # eps, stream
    lib.maavss_adam.argtypes = [p] * 6 + [i, i, i] + [f] * 5 + [p]
    lib.maavss_adam.restype = i
    ll = ctypes.c_longlong
    # ..., geometry, (nblk, chunk,) IO dtype, stream
    lib.maavss_epilogue_stats.argtypes = [p] * 5 + [i] * 6 + [ll, i, p]
    lib.maavss_epilogue_stats.restype = i
    # ..., geometry, IO dtype, plan (windows, pairs, grid, block, band),
    # stream
    lib.maavss_epilogue_apply.argtypes = [p] * 7 + [i] * 13 + [p]
    lib.maavss_epilogue_apply.restype = i
    lib.maavss_epilogue_bwd_reduce.argtypes = [p] * 13 + [i] * 6 + [ll, i, p]
    lib.maavss_epilogue_bwd_reduce.restype = i
    lib.maavss_epilogue_bwd_dy.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.maavss_epilogue_bwd_dy.restype = i
    # the split route (parallel/): stats partials, finish; bwd partials,
    # finish
    lib.maavss_epilogue_stats_partials.argtypes = ([p] * 2 + [i] * 6
                                                   + [ll, i, i, i, p])
    lib.maavss_epilogue_stats_partials.restype = i
    lib.maavss_epilogue_stats_finish.argtypes = [p, i, ll] + [p] * 3 + [i, p]
    lib.maavss_epilogue_stats_finish.restype = i
    lib.maavss_epilogue_bwd_partials.argtypes = ([p] * 7 + [i] * 6
                                                 + [ll, i, i, i, p])
    lib.maavss_epilogue_bwd_partials.restype = i
    lib.maavss_epilogue_bwd_finish.argtypes = ([p, i, i, i] + [p] * 7
                                               + [i, ll, p])
    lib.maavss_epilogue_bwd_finish.restype = i
    planar = [p, ll, ll, ll]  # pointer, item / plane / row strides
    lib.maavss_mask_mul.argtypes = planar * 3 + [i] * 4 + [p]
    lib.maavss_mask_mul.restype = i
    lib.maavss_magphase.argtypes = planar * 2 + [i] * 3 + [p]
    lib.maavss_magphase.restype = i
    lib.maavss_polar_spectrum.argtypes = planar + [p] + [i] * 4 + [p]
    lib.maavss_polar_spectrum.restype = i
    # h, W, bias, stft (planar), out, mask, M, K, T, F, stream
    lib.maavss_mask_head_fwd.argtypes = [p] * 3 + planar + [p, p] + [i] * 4 \
        + [p]
    lib.maavss_mask_head_fwd.restype = i
    # g, stft (planar), h, W, dh, dW, db, scratch, M, K, T, F, stream
    lib.maavss_mask_head_bwd.argtypes = planar * 2 + [p] * 6 + [i] * 4 + [p]
    lib.maavss_mask_head_bwd.restype = i
    lib.maavss_mask_head_bwd_scratch.argtypes = [i] * 4
    lib.maavss_mask_head_bwd_scratch.restype = ll
    # audio, row stride, B, S, N, hop, T, F, window, twiddles, norm, polar,
    # out, stream
    lib.maavss_stft_feat.argtypes = [p, ll] + [i] * 6 + [p, p, f, i, p, p]
    lib.maavss_stft_feat.restype = i
    return lib


def launch(symbol: str, device, args) -> None:
    """Call the launcher `symbol` with `args` and the current stream of
    `device` (switching to the device only when it is not the current one);
    raise on a non-zero cudaError_t."""
    import torch

    fn = getattr(library(), symbol)
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _raw_stream(index))
    check(err, symbol)


def _raw_stream(index: int) -> int:
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
