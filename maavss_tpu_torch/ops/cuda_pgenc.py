"""Fused phasegram-encoder layer: the hand-written CUDA kernels
(`csrc/pgenc_eval.cu` in eval mode, `csrc/pgenc_train.cu` in train mode,
forward and backward) and their plain PyTorch versions.

Counterpart of maavss_tpu/ops/pallas_pgenc.py: `fused_conv_bn_tanh_eval`,
and `fused_conv_bn_tanh_train` with its custom VJP. Same channel-first
dataflow and argument layout:

    y = pgenc_layer(x [C, R, S], w2 [Co, 9*C], cbias, gamma, beta, mean, var)
        -> [Co, R, S // 2]                                      (eval)
    y, mu, var = pgenc_layer_train(x, w2, cbias, gamma, beta)    (train)
    y, mu, var, yc = pgenc_train(...); pgenc_bwd(x, w2, yc, gamma, beta,
        mu, var, dy) -> (dx, dw2, dcbias = 0, dgamma, dbeta)   (its halves)

conv(1,9) / stride 2 / zero pad 4 + BatchNorm (eps 1e-5) + tanh; w2 column
k*C + ci holds the flax kernel[0, k, ci, co] (maavss_tpu/models/layers.py:
205-207); the per-channel vectors are fp32; sums are fp32 and y has x's type
(fp32 or bf16). In train mode the layer normalises with the batch mean and
the biased batch variance E[yc^2] - E[yc]^2 over the R * S/2 outputs of each
channel and returns them for the caller's running-statistics update; they
carry no gradient. The train forward also returns its fp32 conv output yc,
which the backward reads in place of recomputing the conv; the conv bias's
gradient is exactly 0 (it cancels in yc - mu).

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain version. There is no fallback from a kernel on the card.
"""

from __future__ import annotations

import functools

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

    c_out = w2.shape[0]
    y = torch.empty(c_out, r, s // STRIDE, dtype=x.dtype, device=x.device)
    _build.launch("maavss_pgenc_eval", x.device, (
        x.data_ptr(), w2.data_ptr(), *[v.data_ptr() for v in vecs],
        y.data_ptr(), c_in, r, s, c_out, _DTYPE_CODES[x.dtype]))
    pgenc_layer.launches += 1
    return y


pgenc_layer.launches = 0


def _conv_plain(x: torch.Tensor, w2: torch.Tensor,
                cbias: torch.Tensor) -> torch.Tensor:
    """fp32 yc [Co, R, S/2] = conv(x) + cbias through F.conv2d."""
    c_in = x.shape[0]
    c_out = w2.shape[0]
    weight = w2.to(torch.float32).reshape(c_out, TAPS, c_in)
    weight = weight.permute(0, 2, 1).unsqueeze(2)  # [Co, C, 1, 9]
    xr = x.to(torch.float32).permute(1, 0, 2).unsqueeze(2)  # [R, C, 1, S]
    y = F.conv2d(xr, weight, cbias.to(torch.float32), stride=(1, STRIDE),
                 padding=(0, PAD))[:, :, 0, :]  # [R, Co, S/2]
    return y.permute(1, 0, 2)


def pgenc_train_plain(x: torch.Tensor, w2: torch.Tensor, cbias: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor):
    """F.conv2d + batch statistics (biased, E[yc^2] - E[yc]^2) + normalise
    + tanh -> (y, mu, var, yc), yc the fp32 conv output [Co, R, S/2] that
    the backward reads. Differentiable through autograd in x, w2, cbias,
    gamma and beta (mu and var as well, which the fused layer's are not)."""
    yc = _conv_plain(x, w2, cbias)
    mu = yc.mean(dim=(1, 2))
    var = (yc * yc).mean(dim=(1, 2)) - mu * mu
    inv = torch.rsqrt(var + EPS)
    y = torch.tanh(gamma[:, None, None] * (yc - mu[:, None, None])
                   * inv[:, None, None] + beta[:, None, None])
    return y.to(x.dtype), mu, var, yc


def pgenc_bwd_plain(x: torch.Tensor, w2: torch.Tensor, yc: torch.Tensor,
                    gamma: torch.Tensor, beta: torch.Tensor, mu: torch.Tensor,
                    var: torch.Tensor, dy: torch.Tensor):
    """The explicit backward of maavss_tpu/ops/pallas_pgenc.py:208-245 in
    fp32, from the forward's yc in place of the TPU kernel's recomputed
    conv: (dx, dw2, dcbias = 0, dgamma, dbeta). dx and dw2 follow the TPU
    kernel's form, an upsample of dyc with zeros, the tap matrix and the
    untap of W2^T @ upsample(dyc)."""
    c_in, r, s = x.shape
    c_out = w2.shape[0]
    with torch.no_grad():
        n_total = float(r * (s // STRIDE))
        mu_, inv = mu[:, None, None], torch.rsqrt(var + EPS)[:, None, None]
        g_, b_ = gamma[:, None, None], beta[:, None, None]
        z = (yc - mu_) * inv
        out = torch.tanh(g_ * z + b_)
        dq = dy.to(torch.float32) * (1.0 - out * out)
        dgamma = (dq * z).sum(dim=(1, 2))
        dbeta = dq.sum(dim=(1, 2))
        dyc = (g_ * inv) * (dq - dbeta[:, None, None] / n_total
                            - z * (dgamma[:, None, None] / n_total))
        u = torch.stack([dyc, torch.zeros_like(dyc)], dim=-1).reshape(
            c_out, r * s)
        xp = F.pad(x.to(torch.float32), (PAD, PAD))
        taps = torch.cat([xp[:, :, k:k + s] for k in range(TAPS)], dim=0)
        dw2 = u @ taps.reshape(TAPS * c_in, r * s).T
        dtaps = (w2.to(torch.float32).T @ u).reshape(TAPS, c_in, r, s)
        dx = torch.zeros(c_in, r, s + 2 * PAD, dtype=torch.float32,
                         device=x.device)
        for k in range(TAPS):
            dx[:, :, k:k + s] += dtaps[k]
        dx = dx[:, :, PAD:PAD + s]
    return (dx.to(x.dtype), dw2.to(w2.dtype), torch.zeros_like(gamma),
            dgamma.to(gamma.dtype), dbeta.to(beta.dtype))


def _check_train_args(x, w2, vecs, tensors=()) -> None:
    _check_kernel_args(x, w2, vecs)
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("pgenc kernel needs contiguous tensors on one "
                             "CUDA device")


def pgenc_train(x: torch.Tensor, w2: torch.Tensor, cbias: torch.Tensor,
                gamma: torch.Tensor, beta: torch.Tensor, backend: str = "auto"):
    """Train-mode forward -> (y, mu, var, yc). backend as `pgenc_layer`."""
    if backend not in ("auto", "kernel"):
        raise ValueError(f"unknown pgenc backend {backend!r} (auto|kernel)")
    c_in, r, s = x.shape
    if not pgenc_fits(c_in, s):
        raise ValueError(f"pgenc kernel needs even lane width, got S={s}")
    if not x.is_cuda:
        if backend == "kernel":
            raise RuntimeError("the CUDA pgenc kernel needs CUDA tensors")
        with torch.no_grad():
            return pgenc_train_plain(x, w2, cbias, gamma, beta)
    _check_train_args(x, w2, (cbias, gamma, beta))
    from maavss_tpu_torch.ops import _build

    c_out = w2.shape[0]
    so = s // STRIDE
    yc = torch.empty(c_out, r, so, dtype=torch.float32, device=x.device)
    y = torch.empty(c_out, r, so, dtype=x.dtype, device=x.device)
    mu = torch.empty(c_out, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mu)
    _build.launch("maavss_pgenc_train_fwd", x.device, (
        x.data_ptr(), w2.data_ptr(), cbias.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), yc.data_ptr(), y.data_ptr(), mu.data_ptr(),
        var.data_ptr(), c_in, r, s, c_out, _DTYPE_CODES[x.dtype]))
    pgenc_train.launches += 1
    return y, mu, var, yc


pgenc_train.launches = 0


@functools.lru_cache(maxsize=64)
def _bwd_scratch_bytes(c_in: int, r: int, s: int, c_out: int) -> int:
    from maavss_tpu_torch.ops import _build

    n = _build.library().maavss_pgenc_train_bwd_scratch(c_in, r, s, c_out)
    if n < 0:
        raise ValueError(f"pgenc bwd kernel: bad shape C={c_in} R={r} S={s} "
                         f"Co={c_out}")
    return n


def pgenc_bwd(x: torch.Tensor, w2: torch.Tensor, yc: torch.Tensor,
              gamma: torch.Tensor, beta: torch.Tensor, mu: torch.Tensor,
              var: torch.Tensor, dy: torch.Tensor, backend: str = "auto"):
    """Train-mode backward from the forward's fp32 yc -> (dx, dw2,
    dcbias = 0, dgamma, dbeta). yc is read, never written. backend as
    `pgenc_layer`."""
    if backend not in ("auto", "kernel"):
        raise ValueError(f"unknown pgenc backend {backend!r} (auto|kernel)")
    if not x.is_cuda:
        if backend == "kernel":
            raise RuntimeError("the CUDA pgenc kernel needs CUDA tensors")
        return pgenc_bwd_plain(x, w2, yc, gamma, beta, mu, var, dy)
    c_in, r, s = x.shape
    c_out = w2.shape[0]
    so = s // STRIDE
    _check_train_args(x, w2, (gamma, beta, mu, var), (dy, yc))
    if dy.shape != (c_out, r, so) or dy.dtype != x.dtype:
        raise ValueError(f"pgenc bwd kernel: dy {tuple(dy.shape)} {dy.dtype}"
                         f" != [{c_out}, {r}, {so}] {x.dtype}")
    if yc.shape != (c_out, r, so) or yc.dtype != torch.float32:
        raise ValueError(f"pgenc bwd kernel: yc {tuple(yc.shape)} {yc.dtype}"
                         f" != [{c_out}, {r}, {so}] torch.float32")
    from maavss_tpu_torch.ops import _build

    # dyc, dW2's partial tiles and their counters, in one allocation
    scratch = torch.empty(_bwd_scratch_bytes(c_in, r, s, c_out),
                          dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    dw2 = torch.empty_like(w2)
    vec3 = torch.empty(3, c_out, dtype=torch.float32, device=x.device)
    _build.launch("maavss_pgenc_train_bwd", x.device, (
        x.data_ptr(), w2.data_ptr(), yc.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), mu.data_ptr(), var.data_ptr(), dy.data_ptr(),
        scratch.data_ptr(), dx.data_ptr(), dw2.data_ptr(), vec3.data_ptr(),
        c_in, r, s, c_out, _DTYPE_CODES[x.dtype]))
    pgenc_bwd.launches += 1
    return dx, dw2, vec3[0], vec3[1], vec3[2]


pgenc_bwd.launches = 0


class _TrainLayer(torch.autograd.Function):
    """(x, w2, cbias, gamma, beta) -> (y, mu, var), as
    `fused_conv_bn_tanh_train`: mu and var carry no gradient; the forward's
    fp32 yc is saved as the backward's residual (read only, so a second
    backward under retain_graph reads it unchanged); the backward gives
    (dx, dw2, zeros for cbias, dgamma, dbeta)."""

    @staticmethod
    def forward(ctx, x, w2, cbias, gamma, beta, backend):
        y, mu, var, yc = pgenc_train(x, w2, cbias, gamma, beta,
                                     backend=backend)
        ctx.mark_non_differentiable(mu, var)
        ctx.save_for_backward(x, w2, yc, gamma, beta, mu, var)
        ctx.backend = backend
        return y, mu, var

    @staticmethod
    def backward(ctx, dy, _dmu, _dvar):
        grads = pgenc_bwd(*ctx.saved_tensors, dy.contiguous(),
                          backend=ctx.backend)
        return (*grads, None)


def pgenc_layer_train(x: torch.Tensor, w2: torch.Tensor, cbias: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor,
                      backend: str = "auto"):
    """One fused train-mode layer, differentiable -> (y, mu, var)."""
    return _TrainLayer.apply(x, w2, cbias, gamma, beta, backend)
