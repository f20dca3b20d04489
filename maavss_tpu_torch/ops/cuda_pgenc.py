"""Fused phasegram-encoder layer in eval mode: the hand-written CUDA kernel
(`csrc/pgenc_eval.cu`) and its plain PyTorch version.

Counterpart of maavss_tpu/ops/pallas_pgenc.py:fused_conv_bn_tanh_eval (the
train-mode kernels and their backward are a later port). Same channel-first
dataflow and argument layout:

    y = pgenc_layer(x [C, R, S], w2 [Co, 9*C], cbias, gamma, beta, mean, var)
        -> [Co, R, S // 2]

conv(1,9) / stride 2 / zero pad 4 + BatchNorm with running statistics
(eps 1e-5) + tanh; w2 column k*C + ci holds the flax kernel[0, k, ci, co]
(maavss_tpu/models/layers.py:205-207); the five per-channel vectors are fp32;
sums are fp32 and y has x's type (fp32 or bf16).

On a CUDA tensor `pgenc_layer` launches the kernel; on a CPU tensor it runs
the plain version. There is no fallback from the kernel on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TAPS = 9
PAD = 4
STRIDE = 2
EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Hopper's per-block shared memory limit (232,448 bytes); the kernel stages
# one padded input row, 4*C*(S+8) bytes
_SMEM_LIMIT = 232448


def pgenc_fits(c_in: int, s: int) -> bool:
    """Geometry gate, as in the JAX package: an even width S >= 2."""
    del c_in
    return s % 2 == 0 and s >= 2


def pgenc_layer_plain(x: torch.Tensor, w2: torch.Tensor, cbias: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor,
                      mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """F.conv2d on the NCHW view + BatchNorm with running stats + tanh."""
    c_in, r, s = x.shape
    c_out = w2.shape[0]
    weight = w2.to(torch.float32).reshape(c_out, TAPS, c_in)
    weight = weight.permute(0, 2, 1).unsqueeze(2)  # [Co, C, 1, 9]
    xr = x.to(torch.float32).permute(1, 0, 2).unsqueeze(2)  # [R, C, 1, S]
    y = F.conv2d(xr, weight, cbias.to(torch.float32), stride=(1, STRIDE),
                 padding=(0, PAD))[:, :, 0, :]  # [R, Co, S/2]
    inv = torch.rsqrt(var.to(torch.float32) + EPS)
    y = gamma[:, None] * (y - mean[:, None]) * inv[:, None] + beta[:, None]
    return torch.tanh(y).permute(1, 0, 2).to(x.dtype)


def _check_kernel_args(x, w2, vecs) -> None:
    c_in, r, s = x.shape
    c_out = w2.shape[0]
    if w2.shape != (c_out, TAPS * c_in):
        raise ValueError(f"pgenc kernel: w2 {tuple(w2.shape)} != "
                         f"[Co, 9*{c_in}]")
    if x.dtype not in _DTYPE_CODES or w2.dtype != x.dtype:
        raise TypeError(f"pgenc kernel takes float32 or bfloat16 x and w2 of "
                        f"one dtype, got {x.dtype}/{w2.dtype}")
    for v in vecs:
        if v.shape != (c_out,) or v.dtype != torch.float32:
            raise ValueError("pgenc kernel: cbias/gamma/beta/mean/var must be "
                             f"float32 [{c_out}], got {v.dtype} "
                             f"{tuple(v.shape)}")
    tensors = (x, w2) + tuple(vecs)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("pgenc kernel needs every tensor on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pgenc kernel needs contiguous tensors")
    smem = 4 * c_in * (s + 2 * PAD)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"pgenc kernel: a row of C={c_in} x S={s} needs "
                         f"{smem} bytes of shared memory, over {_SMEM_LIMIT}")
    if (c_out * (s // 2) + 1023) // 1024 > 65535:
        raise ValueError("pgenc kernel: too many outputs per row for the grid")


def pgenc_layer(x: torch.Tensor, w2: torch.Tensor, cbias: torch.Tensor,
                gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
                var: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """One fused layer. backend 'auto': the kernel for CUDA tensors, the
    plain version for CPU tensors. 'kernel': the kernel; a CPU tensor
    raises."""
    if backend not in ("auto", "kernel"):
        raise ValueError(f"unknown pgenc backend {backend!r} (auto|kernel)")
    c_in, r, s = x.shape
    if not pgenc_fits(c_in, s):
        raise ValueError(f"pgenc kernel needs even lane width, got S={s}")
    vecs = (cbias, gamma, beta, mean, var)
    if not x.is_cuda:
        if backend == "kernel":
            raise RuntimeError("the CUDA pgenc kernel needs CUDA tensors")
        return pgenc_layer_plain(x, w2, *vecs)
    _check_kernel_args(x, w2, vecs)
    from maavss_tpu_torch.ops import _build

    lib = _build.library()
    c_out = w2.shape[0]
    y = torch.empty(c_out, r, s // STRIDE, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.maavss_pgenc_eval(
            x.data_ptr(), w2.data_ptr(), *[v.data_ptr() for v in vecs],
            y.data_ptr(), c_in, r, s, c_out, _DTYPE_CODES[x.dtype], stream)
    _build.check(err, "maavss_pgenc_eval")
    pgenc_layer.launches += 1
    return y


pgenc_layer.launches = 0
