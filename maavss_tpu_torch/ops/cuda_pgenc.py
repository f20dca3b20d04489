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
(fp32, bf16 or fp16). In train mode the layer normalises with the batch mean
and the biased batch variance E[yc^2] - E[yc]^2 over the R * S/2 outputs of
each channel and returns them for the caller's running-statistics update; they
carry no gradient. The train forward also returns its fp32 conv output yc,
which the backward reads in place of recomputing the conv; the conv bias's
gradient is exactly 0 (it cancels in yc - mu).

The eval layer and the train forward share one register-tiled conv
(`csrc/pgenc_conv.cuh`) and its tile plan, `pgenc_plan`; the train forward
is one cooperative launch whose grid is at most the blocks the card keeps
resident (`_resident_blocks`), with the batch statistics summed in its
epilogue.

Under a mesh with more than one data rank (--mesh_data, parallel/) the
train layer takes its split route (`pgenc_layer_train(split=True)`), so
that the statistics are the global batch's:

    forward:  pgenc_train_conv  (yc and the tiles' per-channel partial
              sums into this rank's slots), the data group's slots filled
              by one all_reduce (parallel/collectives.py), pgenc_train_apply
              (the partials of every rank summed in one fixed order, mu,
              var, and y from yc)
    backward: pgenc_bwd_sums (this rank's sums of dq*z and dq), their
              fixed-order combine over the group, pgenc_bwd_apply (dyc
              from the global sums, then the unchanged grads kernel);
              dgamma and dbeta stay this rank's sums

Every rank gets the same bits of mu and var. One rank keeps the fused
launches.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain version. There is no fallback from a kernel on the card. The
eval layer launches through the registered op `maavss_tpu_torch::
pgenc_eval` (ops/registry.py, its body `pgenc_eval_launch`), so that an
exported serving program carries it; the train-mode kernels are direct
launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from maavss_tpu_torch.parallel.mesh import data_slot

TAPS = 9
PAD = 4
STRIDE = 2
EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pgenc_conv.cuh: outputs a thread holds, threads a block, output channels
# a tile, dynamic shared bytes a block (the 232,448 of an H100 block less 4
# KB for the kernels' static arrays)
TSO = 4
MAX_THREADS = 256
MAX_BC = 32
_SMEM_LIMIT = 232448 - 4096
# the plan's aims (pgenc_plan), from the sweep of
# tools/pgenc_fwd_probe_torch.py on an H100 (PERF.md, Findings): rows halved
# until there are at least TARGET_TILES tiles (so 66-131), at least MIN_CI
# input channels a contraction group, at most BC_MAX output channels a tile
# (half that where a channel has fewer than WIDE_CHANNEL outputs) and
# BS_MAX positions, and shared bytes that leave room for two blocks an SM
TARGET_TILES = 66
MIN_CI = 2
BC_MAX = 16
WIDE_CHANNEL = 4096
BS_MAX = 128
SMEM_AIM = 96 * 1024


class PgencPlan(NamedTuple):
    """A tile plan of the K2 forward kernels (csrc/pgenc_conv.cuh): a block
    owns bc output channels x br rows x bs output positions; a thread tc
    channels x TSO positions of one row, summed over one of g groups of
    input channels. The rest follows: threads a block, dynamic shared
    bytes, tiles of one channel block and in all."""
    tc: int
    bc: int
    br: int
    bs: int
    g: int
    threads: int
    smem: int
    per_cb: int
    tiles: int


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def _pow2floor(v: int) -> int:
    return 1 << (max(1, v).bit_length() - 1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_of(c_in: int, r: int, s: int, c_out: int, tc: int, bc: int,
            br: int, bs: int, g: int) -> PgencPlan:
    """The plan (tc, bc, br, bs, g) for the layer shape, with what follows
    from it, as pgenc_conv.cuh:make_plan computes it; ValueError where the
    kernels do not take it."""
    so = s // 2
    ok = (tc in (2, 4) and tc <= bc <= MAX_BC and bc % tc == 0
          and _pow2(br) and _pow2(bs) and bs >= TSO and _pow2(g)
          and g <= c_in)
    nto = (bc // tc) * br * (bs // TSO) if ok else 0
    if not ok or nto * g > MAX_THREADS:
        raise ValueError(f"pgenc plan (tc={tc}, bc={bc}, br={br}, bs={bs}, "
                         f"g={g}) is not one the kernels take for C={c_in}")
    per_cb = _cdiv(r, br) * _cdiv(so, bs)
    stage = c_in * (br * (2 * bs + 2 * PAD) + TAPS * bc)
    red = g * nto * tc * TSO if g > 1 else 0
    smem = 4 * max(stage, red)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"pgenc plan (tc={tc}, bc={bc}, br={br}, bs={bs}, "
                         f"g={g}) needs {smem} bytes of shared memory for "
                         f"C={c_in}, over {_SMEM_LIMIT}")
    return PgencPlan(tc, bc, br, bs, g, _cdiv(nto * g, 32) * 32, smem,
                     per_cb, per_cb * _cdiv(c_out, bc))


@functools.lru_cache(maxsize=256)
def pgenc_plan(c_in: int, r: int, s: int, c_out: int) -> PgencPlan:
    """The tile plan of the K2 forward kernels for x [c_in, r, s] and c_out
    output channels (eval and train take the same).

    Thread tiles of tc = 4 output channels (2 where c_out <= 2) x TSO
    positions. A tile holds up to BC_MAX channels (half that below
    WIDE_CHANNEL outputs a channel: the deep layers at small R restage less
    of w2 and get more rows a tile) and BS_MAX positions, and as many rows
    as give MAX_THREADS threads; while there are fewer than TARGET_TILES
    tiles it holds half the rows. The contraction is then split over g
    groups of at least MIN_CI input channels while the block has room (the
    deep layers' 576-term sums over few outputs); the groups' sums meet in
    a fixed tree. A plan over SMEM_AIM shared bytes holds
    fewer rows; one over the limit fewer rows, then positions, then
    channels. Raises ValueError for an odd or empty width, or a c_in whose
    smallest tile does not fit."""
    if not pgenc_fits(c_in, s) or min(c_in, r, c_out) < 1:
        raise ValueError(f"pgenc kernel needs even lane width S >= 2 and "
                         f"C, R, Co >= 1, got C={c_in} R={r} S={s} "
                         f"Co={c_out}")
    so = s // 2
    bc_max = BC_MAX if r * so >= WIDE_CHANNEL else BC_MAX // 2
    tc = 4 if c_out >= 3 else 2
    bc = min(_cdiv(c_out, tc) * tc, bc_max)
    bs = min(max(TSO, 1 << (so - 1).bit_length()), BS_MAX)
    row_threads = (bc // tc) * (bs // TSO)
    br = min(_pow2floor(MAX_THREADS // row_threads), 1 << (r - 1).bit_length())
    while br > 1 and _cdiv(c_out, bc) * _cdiv(r, br) * _cdiv(so, bs) < TARGET_TILES:
        br //= 2
    g_max = _pow2floor(c_in // MIN_CI)
    while True:
        nto = (bc // tc) * br * (bs // TSO)
        g = 1
        while nto * g * 2 <= MAX_THREADS and g * 2 <= g_max:
            g *= 2
        try:
            plan = plan_of(c_in, r, s, c_out, tc, bc, br, bs, g)
            if plan.smem <= SMEM_AIM or br == 1:
                return plan
            br //= 2
        except ValueError:
            if br > 1:
                br //= 2
            elif bs > TSO:
                bs //= 2
            elif bc > tc:
                bc = max(tc, bc // 2 // tc * tc)
            else:
                raise


def train_grid(plan: PgencPlan, resident: int) -> int:
    """Blocks of the train forward's cooperative launch: one a tile, at
    most the `resident` blocks the card keeps at once (each then walks
    over a contiguous run of tiles)."""
    if resident < 1:
        raise ValueError(f"pgenc train kernel: no block of {plan.threads} "
                         f"threads and {plan.smem} shared bytes fits an SM")
    return min(plan.tiles, resident)


@functools.lru_cache(maxsize=None)
def _resident_blocks(index: int, tc: int, dtype_code: int, threads: int,
                     smem: int) -> int:
    """Blocks of the train forward's kernel the card `index` keeps resident
    at the plan's threads and shared bytes (the C occupancy query)."""
    from maavss_tpu_torch.ops import _build

    with torch.cuda.device(index):
        n = _build.library().maavss_pgenc_train_resident(tc, dtype_code,
                                                         threads, smem)
    if n < 0:
        raise RuntimeError(f"maavss_pgenc_train_resident: cudaError_t {-n}")
    return n


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
    c_in = x.shape[0]
    c_out = w2.shape[0]
    if w2.shape != (c_out, TAPS * c_in):
        raise ValueError(f"pgenc kernel: w2 {tuple(w2.shape)} != "
                         f"[Co, 9*{c_in}]")
    if x.dtype not in _DTYPE_CODES or w2.dtype != x.dtype:
        raise TypeError(f"pgenc kernel takes float32, bfloat16 or float16 x "
                        f"and w2 of one dtype, got {x.dtype}/{w2.dtype}")
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
    pgenc_plan(c_in, r, s, w2.shape[0])  # raises on a shape K2 refuses
    from maavss_tpu_torch.ops import registry

    return registry.call["pgenc_eval"](x, w2, *vecs)


pgenc_layer.launches = 0


def pgenc_eval_launch(x, w2, cbias, gamma, beta, mean, var) -> torch.Tensor:
    """The registered op `pgenc_eval` on CUDA (ops/registry.py): K2-eval at
    the layer's tile plan, on checked arguments -> y."""
    c_in, r, s = x.shape
    y = _eval_launch(x, w2, (cbias, gamma, beta, mean, var),
                     pgenc_plan(c_in, r, s, w2.shape[0]))
    pgenc_layer.launches += 1
    return y


def _eval_launch(x, w2, vecs, plan: PgencPlan) -> torch.Tensor:
    """K2-eval at `plan`, on checked arguments -> y."""
    from maavss_tpu_torch.ops import _build

    c_in, r, s = x.shape
    c_out = w2.shape[0]
    y = torch.empty(c_out, r, s // STRIDE, dtype=x.dtype, device=x.device)
    _build.launch("maavss_pgenc_eval", x.device, (
        x.data_ptr(), w2.data_ptr(), *[v.data_ptr() for v in vecs],
        y.data_ptr(), c_in, r, s, c_out, _DTYPE_CODES[x.dtype], plan.tc,
        plan.bc, plan.br, plan.bs, plan.g))
    return y


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
    r, s = x.shape[1], x.shape[2]
    with torch.no_grad():
        n_total = float(r * (s // STRIDE))
        z, dq, dgamma, dbeta = _bn_bwd_terms(yc, gamma, beta, mu, var, dy)
        dyc = _dyc_plain(z, dq, gamma, var, dgamma, dbeta, n_total)
        dx, dw2 = _conv_grads_plain(x, w2, dyc)
    return (dx, dw2, torch.zeros_like(gamma), dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype))


def _bn_bwd_terms(yc, gamma, beta, mu, var, dy):
    """(z, dq, dgamma, dbeta) of the BN backward, fp32: dgamma and dbeta
    are the sums of dq*z and dq over the launch's rows."""
    mu_, inv = mu[:, None, None], torch.rsqrt(var + EPS)[:, None, None]
    g_, b_ = gamma[:, None, None], beta[:, None, None]
    z = (yc - mu_) * inv
    out = torch.tanh(g_ * z + b_)
    dq = dy.to(torch.float32) * (1.0 - out * out)
    return z, dq, (dq * z).sum(dim=(1, 2)), dq.sum(dim=(1, 2))


def _dyc_plain(z, dq, gamma, var, dgamma, dbeta, n_total: float):
    """dyc from the sums dgamma and dbeta over n_total values a channel."""
    g_, inv = gamma[:, None, None], torch.rsqrt(var + EPS)[:, None, None]
    return (g_ * inv) * (dq - dbeta[:, None, None] / n_total
                         - z * (dgamma[:, None, None] / n_total))


def _conv_grads_plain(x, w2, dyc):
    """(dx, dw2) from dyc, in x's and w2's types: the TPU kernel's form, an
    upsample of dyc with zeros, the tap matrix and the untap of
    W2^T @ upsample(dyc)."""
    c_in, r, s = x.shape
    c_out = w2.shape[0]
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
    return dx.to(x.dtype), dw2.to(w2.dtype)


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
    plan = pgenc_plan(c_in, r, s, w2.shape[0])
    grid = train_grid(plan, _resident_blocks(
        x.device.index, plan.tc, _DTYPE_CODES[x.dtype], plan.threads,
        plan.smem))
    out = _train_launch(x, w2, (cbias, gamma, beta), plan, grid)
    pgenc_train.launches += 1
    return out


pgenc_train.launches = 0


def _train_launch(x, w2, vecs, plan: PgencPlan, grid: int):
    """K2-train's forward at `plan` in one cooperative launch of `grid`
    blocks, on checked arguments -> (y, mu, var, yc). A grid over what the
    card keeps resident raises."""
    from maavss_tpu_torch.ops import _build

    c_in, r, s = x.shape
    c_out = w2.shape[0]
    so = s // STRIDE
    yc = torch.empty(c_out, r, so, dtype=torch.float32, device=x.device)
    y = torch.empty(c_out, r, so, dtype=x.dtype, device=x.device)
    # mu, var, then each tile's per-channel sum and sum of squares
    stats = torch.empty(2 * c_out * (1 + plan.per_cb), dtype=torch.float32,
                        device=x.device)
    mu, var = stats[:c_out], stats[c_out:2 * c_out]
    _build.launch("maavss_pgenc_train_fwd", x.device, (
        x.data_ptr(), w2.data_ptr(), *[v.data_ptr() for v in vecs],
        yc.data_ptr(), y.data_ptr(), mu.data_ptr(), var.data_ptr(),
        stats[2 * c_out:].data_ptr(), c_in, r, s, c_out,
        _DTYPE_CODES[x.dtype], plan.tc, plan.bc, plan.br, plan.bs, plan.g,
        grid))
    return y, mu, var, yc


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


# ------------------------------------------------------------ split route


def _train_conv_plain(x, w2, cbias, slots: int, slot: int):
    """(yc, partial [Co, 2, slots]): the plain conv and this launch's
    per-channel (sum, sum of squares) of yc in slot `slot`, zeros in the
    others."""
    yc = _conv_plain(x, w2, cbias)
    partial = torch.zeros(w2.shape[0], 2, slots, dtype=torch.float32,
                          device=x.device)
    partial[:, 0, slot] = yc.sum(dim=(1, 2))
    partial[:, 1, slot] = (yc * yc).sum(dim=(1, 2))
    return yc, partial


def _sum_parts(partial: torch.Tensor) -> torch.Tensor:
    """[Co, 2, n] -> [Co, 2], the n partials added in index order."""
    acc = partial[:, :, 0]
    for i in range(1, partial.shape[2]):
        acc = acc + partial[:, :, i]
    return acc


def _train_apply_plain(yc, gamma, beta, partial, ntot: int, dtype):
    """(y, mu, var) from yc and every partial: mu = S / ntot, var = SS /
    ntot - mu^2 (biased), y = tanh(gamma * (yc - mu) * rsqrt(var + eps) +
    beta) in `dtype`."""
    sums = _sum_parts(partial)
    mu = sums[:, 0] / float(ntot)
    var = sums[:, 1] / float(ntot) - mu * mu
    inv = torch.rsqrt(var + EPS)
    y = torch.tanh(gamma[:, None, None] * (yc - mu[:, None, None])
                   * inv[:, None, None] + beta[:, None, None])
    return y.to(dtype), mu, var


def pgenc_train_conv(x: torch.Tensor, w2: torch.Tensor, cbias: torch.Tensor,
                     slots: int, slot: int):
    """The split route's first launch -> (yc, partial [Co, 2, slots * P]):
    yc and this launch's P partial sums a channel (P the plan's tiles of
    a channel block on the card, 1 in the plain version) at slot `slot`,
    the other slots zero for the group's collective to fill."""
    if not x.is_cuda:
        return _train_conv_plain(x, w2, cbias, slots, slot)
    _check_train_args(x, w2, (cbias,))
    from maavss_tpu_torch.ops import _build

    c_in, r, s = x.shape
    c_out = w2.shape[0]
    plan = pgenc_plan(c_in, r, s, c_out)
    yc = torch.empty(c_out, r, s // STRIDE, dtype=torch.float32,
                     device=x.device)
    partial = torch.zeros(c_out, 2, slots * plan.per_cb, dtype=torch.float32,
                          device=x.device)
    _build.launch("maavss_pgenc_train_conv", x.device, (
        x.data_ptr(), w2.data_ptr(), cbias.data_ptr(), yc.data_ptr(),
        partial.data_ptr(), c_in, r, s, c_out, _DTYPE_CODES[x.dtype],
        plan.tc, plan.bc, plan.br, plan.bs, plan.g, slots * plan.per_cb,
        slot * plan.per_cb))
    pgenc_train_conv.launches += 1
    return yc, partial


pgenc_train_conv.launches = 0


def pgenc_train_apply(yc: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, partial: torch.Tensor, ntot: int,
                      c_in: int, dtype: torch.dtype):
    """The split route's second launch -> (y, mu, var): every partial of
    `partial` (all slots filled) summed in one fixed order over `ntot`
    values a channel, y in `dtype` from yc. `c_in` picks the plan the
    first launch used."""
    if not yc.is_cuda:
        return _train_apply_plain(yc, gamma, beta, partial, ntot, dtype)
    from maavss_tpu_torch.ops import _build

    c_out, r, so = yc.shape
    plan = pgenc_plan(c_in, r, 2 * so, c_out)
    for t in (yc, gamma, beta, partial):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != yc.device:
            raise ValueError("pgenc apply: yc, gamma, beta and partial must "
                             "be contiguous float32 tensors on one device")
    y = torch.empty(c_out, r, so, dtype=dtype, device=yc.device)
    mu, var = (torch.empty(c_out, dtype=torch.float32, device=yc.device)
               for _ in range(2))
    _build.launch("maavss_pgenc_train_apply", yc.device, (
        yc.data_ptr(), gamma.data_ptr(), beta.data_ptr(), partial.data_ptr(),
        y.data_ptr(), mu.data_ptr(), var.data_ptr(), c_in, r, 2 * so, c_out,
        _DTYPE_CODES[dtype], plan.tc, plan.bc, plan.br, plan.bs, plan.g,
        partial.shape[2], int(ntot)))
    pgenc_train_apply.launches += 1
    return y, mu, var


pgenc_train_apply.launches = 0


def pgenc_train_split(x: torch.Tensor, w2: torch.Tensor, cbias: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor):
    """Train-mode forward over the data group's global batch -> (y, mu,
    var, yc): `pgenc_train_conv`, one all_reduce that fills every rank's
    slots (an exact gather), `pgenc_train_apply`. Without a mesh, the
    group of one."""
    from maavss_tpu_torch.parallel.collectives import all_sum_

    mesh, n, d = data_slot()
    with torch.no_grad():
        yc, partial = pgenc_train_conv(x, w2, cbias, n, d)
        all_sum_(partial, mesh)
        c_in, r, s = x.shape
        y, mu, var = pgenc_train_apply(yc, gamma, beta, partial,
                                       n * r * (s // STRIDE), c_in, x.dtype)
    return y, mu, var, yc


def pgenc_bwd_sums(yc: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   mu: torch.Tensor, var: torch.Tensor,
                   dy: torch.Tensor) -> torch.Tensor:
    """The split backward's first launch -> vec3 [3, Co] = (0, dgamma,
    dbeta): this launch's sums of dq*z and dq."""
    if not yc.is_cuda:
        with torch.no_grad():
            _, _, dgamma, dbeta = _bn_bwd_terms(yc, gamma, beta, mu, var, dy)
            return torch.stack([torch.zeros_like(dgamma), dgamma, dbeta])
    from maavss_tpu_torch.ops import _build

    c_out, r, so = yc.shape
    for t in (gamma, beta, mu, var, dy):
        if t.device != yc.device or not t.is_contiguous():
            raise ValueError("pgenc bwd sums: contiguous tensors on one "
                             "CUDA device")
    if dy.shape != yc.shape or dy.dtype not in _DTYPE_CODES:
        raise ValueError(f"pgenc bwd sums: dy {tuple(dy.shape)} {dy.dtype}")
    vec3 = torch.empty(3, c_out, dtype=torch.float32, device=yc.device)
    _build.launch("maavss_pgenc_train_bwd_sums", yc.device, (
        yc.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mu.data_ptr(),
        var.data_ptr(), dy.data_ptr(), vec3.data_ptr(), r, 2 * so, c_out,
        _DTYPE_CODES[dy.dtype]))
    pgenc_bwd_sums.launches += 1
    return vec3


pgenc_bwd_sums.launches = 0


def pgenc_bwd_apply(x, w2, yc, gamma, beta, mu, var, dy, sums: torch.Tensor,
                    ntot: int):
    """The split backward's second launch (two kernels: dyc, then the
    grads kernel) -> (dx, dw2), dyc from `sums` [2, Co] (the data group's
    dgamma and dbeta) over `ntot` values a channel."""
    if not x.is_cuda:
        with torch.no_grad():
            z, dq, _, _ = _bn_bwd_terms(yc, gamma, beta, mu, var, dy)
            dyc = _dyc_plain(z, dq, gamma, var, sums[0], sums[1],
                             float(ntot))
            return _conv_grads_plain(x, w2, dyc)
    c_in, r, s = x.shape
    c_out = w2.shape[0]
    _check_train_args(x, w2, (gamma, beta, mu, var), (dy, yc))
    if sums.shape != (2, c_out) or not sums.is_contiguous():
        raise ValueError(f"pgenc bwd apply: sums {tuple(sums.shape)} != "
                         f"[2, {c_out}]")
    from maavss_tpu_torch.ops import _build

    scratch = torch.empty(_bwd_scratch_bytes(c_in, r, s, c_out),
                          dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    dw2 = torch.empty_like(w2)
    _build.launch("maavss_pgenc_train_bwd_apply", x.device, (
        x.data_ptr(), w2.data_ptr(), yc.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), mu.data_ptr(), var.data_ptr(), dy.data_ptr(),
        sums.data_ptr(), int(ntot), scratch.data_ptr(), dx.data_ptr(),
        dw2.data_ptr(), c_in, r, s, c_out, _DTYPE_CODES[x.dtype]))
    pgenc_bwd_apply.launches += 1
    return dx, dw2


pgenc_bwd_apply.launches = 0


def pgenc_bwd_split(x, w2, yc, gamma, beta, mu, var, dy):
    """Train-mode backward over the data group's global batch -> (dx,
    dw2, dcbias = 0, dgamma, dbeta): `pgenc_bwd_sums`, the fixed-order
    combine of (dgamma, dbeta) over the group, `pgenc_bwd_apply`. dgamma
    and dbeta are this rank's own sums (the gradient all-reduce sums
    them)."""
    from maavss_tpu_torch.parallel.collectives import combine

    mesh, n, _ = data_slot()
    vec3 = pgenc_bwd_sums(yc, gamma, beta, mu, var, dy)
    sums = combine(vec3[1:3].contiguous(), mesh).contiguous()
    c_in, r, s = x.shape
    dx, dw2 = pgenc_bwd_apply(x, w2, yc, gamma, beta, mu, var, dy, sums,
                              n * r * (s // STRIDE))
    return dx, dw2, vec3[0], vec3[1], vec3[2]


def pgenc_split_plain(x, w2, cbias, gamma, beta, dy):
    """The split route's forward and backward through the plain versions
    on any device, under the current mesh: ((y, mu, var, yc), (dx, dw2,
    dcbias, dgamma, dbeta)), the reference the split kernels are held
    against."""
    from maavss_tpu_torch.parallel.collectives import all_sum_, combine

    mesh, n, d = data_slot()
    c_in, r, s = x.shape
    ntot = n * r * (s // STRIDE)
    with torch.no_grad():
        yc, partial = _train_conv_plain(x, w2, cbias, n, d)
        all_sum_(partial, mesh)
        y, mu, var = _train_apply_plain(yc, gamma, beta, partial, ntot,
                                        x.dtype)
        z, dq, dgamma, dbeta = _bn_bwd_terms(yc, gamma, beta, mu, var, dy)
        sums = combine(torch.stack([dgamma, dbeta]), mesh)
        dyc = _dyc_plain(z, dq, gamma, var, sums[0], sums[1], float(ntot))
        dx, dw2 = _conv_grads_plain(x, w2, dyc)
    return (y, mu, var, yc), (dx, dw2, torch.zeros_like(gamma), dgamma,
                              dbeta)


class _TrainLayer(torch.autograd.Function):
    """(x, w2, cbias, gamma, beta) -> (y, mu, var), as
    `fused_conv_bn_tanh_train`: mu and var carry no gradient; the forward's
    fp32 yc is saved as the backward's residual (read only, so a second
    backward under retain_graph reads it unchanged); the backward gives
    (dx, dw2, zeros for cbias, dgamma, dbeta). `split`: the split route
    (the data group's statistics)."""

    @staticmethod
    def forward(ctx, x, w2, cbias, gamma, beta, backend, split):
        if split:
            y, mu, var, yc = pgenc_train_split(x, w2, cbias, gamma, beta)
        else:
            y, mu, var, yc = pgenc_train(x, w2, cbias, gamma, beta,
                                         backend=backend)
        ctx.mark_non_differentiable(mu, var)
        ctx.save_for_backward(x, w2, yc, gamma, beta, mu, var)
        ctx.backend, ctx.split = backend, split
        return y, mu, var

    @staticmethod
    def backward(ctx, dy, _dmu, _dvar):
        if ctx.split:
            grads = pgenc_bwd_split(*ctx.saved_tensors, dy.contiguous())
        else:
            grads = pgenc_bwd(*ctx.saved_tensors, dy.contiguous(),
                              backend=ctx.backend)
        return (*grads, None, None)


def pgenc_layer_train(x: torch.Tensor, w2: torch.Tensor, cbias: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor,
                      backend: str = "auto", split: bool = False):
    """One fused train-mode layer, differentiable -> (y, mu, var); `split`
    takes the split route (module docstring)."""
    return _TrainLayer.apply(x, w2, cbias, gamma, beta, backend, split)
