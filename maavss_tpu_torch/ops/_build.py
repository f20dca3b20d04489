"""Build and load the hand-written CUDA kernels in `maavss_tpu_torch/csrc/`.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
interface, for Hopper only (`sm_90a`), the first time a kernel is launched:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o libmaavss_kernels.so csrc/*.cu

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in srcs if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                           f"\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return BuildResult(lib, seconds, log)


@functools.lru_cache(maxsize=1)
def library():
    """The loaded kernel library, with argtypes/restype declared."""
    import ctypes

    lib = ctypes.CDLL(build().path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maavss_lstm_fwd.argtypes = [p, p, p, p, i, p, p, p, p, i,
                                    i, i, i, i, i, p]
    lib.maavss_lstm_fwd.restype = i
    lib.maavss_pgenc_eval.argtypes = [p, p, p, p, p, p, p, p,
                                      i, i, i, i, i, p]
    lib.maavss_pgenc_eval.restype = i
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
