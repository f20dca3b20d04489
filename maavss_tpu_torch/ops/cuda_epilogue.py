"""Fused train-mode BatchNorm + 2x2 max pool + LeakyReLU(0.01) of the frames
encoder's eligible conv3d stages: the hand-written CUDA kernels of
`csrc/epilogue.cu` and their plain PyTorch versions.

Counterpart of maavss_tpu/ops/pallas_epilogue.py:fused_bn_phasemax_leaky,
on PyTorch's layout: the conv3d output y [B, C, T, H, W] (NCDHW, H and W
even, fp32, bf16 or fp16) is read as it is, where the JAX package folds it to
phase-major channels first.

    out, mu, var = fused_bn_pool_leaky(y, gamma, beta)

    out [B, C, T, H/2, W/2] = leaky_0.01(max_2x2(BN_train(y))), y's dtype
    mu, var [C] fp32        = the batch mean and the biased variance
                              E[y^2] - mu^2, not clamped (the caller updates
                              the running statistics with them)

The four kernels, each behind a wrapper that launches it on a CUDA tensor
and runs its plain version on a CPU tensor (no fallback on the card), and
that counts its launches in `.launches`:

- `epilogue_stats(y) -> mu, var, rstd`
- `epilogue_apply(y, gamma, beta, mu, rstd) -> out, sel`: a window's raw
  max if gamma > 0, else its min, is the element BN + leaky map to the
  window's max (the monotonicity rule of pallas_epilogue.py:44-52); `sel`,
  a quarter of y, is the only residual besides y
- `epilogue_bwd_reduce(g, sel, gamma, beta, mu, rstd, g_mu, g_var)
  -> dgamma, dbeta, k`: the pooled-domain sums S2 and S1 and the per-channel
  constants of the dy pass
- `epilogue_bwd_dy(y, g, sel, gamma, beta, mu, rstd, k) -> dy`: the whole
  dy in one pass; ties within a window go to the first match in phase
  order 2*py + px, compared in fp32

apply's launch is planned in Python (`apply_plan`, a pure function of the
shape, the item size and the pointers): tiled by plane with 4 windows a
thread and 16-byte loads where W/2 and the alignment allow, one thread a
window otherwise. bwd reduce reads 16 bytes a load where it can, and each
channel's last block combines the partials, in one launch; it finds that
block through per-channel counters kept per device that the kernel leaves
0, so bwd reduce calls on one device must not run on two streams at once.

Under a mesh with more than one data rank (--mesh_data, parallel/) the
two reductions take their split route (`fused_bn_pool_leaky(split=True)`),
so that mu, var and the backward's constants are the global batch's:
`epilogue_stats_partials` (this rank's per-block partials into its slots),
one all_reduce that fills every rank's slots (an exact gather),
`epilogue_stats_finish` (mu, var, rstd from every partial in one fixed
order); `epilogue_bwd_partials`, the same all_reduce, the cotangents of mu
and var summed over the group, `epilogue_bwd_finish` (k from every
partial; dgamma and dbeta from this rank's alone, which the gradient
all-reduce sums). apply and bwd dy are unchanged.

`fused_bn_pool_leaky` joins them in a `torch.autograd.Function` whose
backward is the complete VJP of pallas_epilogue.py:_fused_bwd, the
cotangents of mu and var included (zero in training, where the running
statistics take mu and var detached).

y's dtype is the IO dtype of out, sel, the cotangent g and dy, as in the
JAX kernels: a bf16 (fp16) y gives bf16 (fp16) out, sel and dy. Every sum
and every BN expression runs in fp32 on the exact upcast of the IO values; out and dy
round once at the end, and sel, a selected value, is exact. mu, var, rstd,
gamma, beta and the constants k stay fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from maavss_tpu_torch.parallel.mesh import data_slot

SLOPE = 0.01
EPS = 1e-5
# each channel sum is split over about this many blocks in all (8 per SM of
# the H100's 132), at least 4096 values per block
_TARGET_BLOCKS = 1056
_MIN_PER_BLOCK = 4096
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS = 256  # a block's threads in csrc/epilogue.cu (kThreads)
APPLY_WINDOWS = 4  # adjacent windows a thread of apply's vector path takes
# pooled rows each thread of apply's vector path takes, the band of a block
# being this many times its rows of threads (1, 2, 4 and 8 measured within
# 1 % of each other on an H100: tools/k5_probe_torch.py)
APPLY_ROW_STEPS = 1
_COUNTERS = {}  # device -> bwd reduce's per-channel int32 counters, kept 0
# counters that a larger allocation replaced: a captured CUDA graph may
# still hold their address, so they are never freed
_RETIRED = []


def _chan(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """[C] -> broadcastable against a [B, C, ...] tensor of `ndim` dims."""
    return v.view((1, -1) + (1,) * (ndim - 2))


def _windows(y: torch.Tensor) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, C, T, H/2, W/2, 4], phase 2*py + px last."""
    b, c, t, h, w = y.shape
    y = y.reshape(b, c, t, h // 2, 2, w // 2, 2).permute(0, 1, 2, 3, 5, 4, 6)
    return y.reshape(b, c, t, h // 2, w // 2, 4)


def _unwindows(y4: torch.Tensor) -> torch.Tensor:
    """Inverse of `_windows`."""
    b, c, t, h2, w2, _ = y4.shape
    y = y4.reshape(b, c, t, h2, w2, 2, 2).permute(0, 1, 2, 3, 5, 4, 6)
    return y.reshape(b, c, t, 2 * h2, 2 * w2)


# ------------------------------------------------------------ plain versions


def epilogue_stats_plain(y: torch.Tensor):
    y = y.to(torch.float32)
    axes = (0, 2, 3, 4)
    mu = y.mean(dim=axes)
    var = (y * y).mean(dim=axes) - mu * mu
    return mu, var, torch.rsqrt(var + EPS)


def epilogue_apply_plain(y, gamma, beta, mu, rstd):
    y4 = _windows(y.to(torch.float32))
    pos = _chan(gamma > 0, 5)
    sel = torch.where(pos, y4.amax(dim=-1), y4.amin(dim=-1))
    o = (_chan(gamma, 5) * (sel - _chan(mu, 5)) * _chan(rstd, 5)
         + _chan(beta, 5))
    return torch.where(o >= 0, o, SLOPE * o).to(y.dtype), sel.to(y.dtype)


def _dsel(g, sel, gamma, beta, mu, rstd):
    """(dsel, xhat) of the selected elements."""
    xhat = (sel - _chan(mu, 5)) * _chan(rstd, 5)
    o = _chan(gamma, 5) * xhat + _chan(beta, 5)
    return g * torch.where(o >= 0, 1.0, SLOPE), xhat, o


def epilogue_bwd_reduce_plain(g, sel, gamma, beta, mu, rstd, g_mu, g_var):
    dsel, xhat, _ = _dsel(g.to(torch.float32), sel.to(torch.float32), gamma,
                          beta, mu, rstd)
    axes = (0, 2, 3, 4)
    s1 = dsel.sum(dim=axes)
    s2 = (dsel * xhat).sum(dim=axes)
    ntot = float(4 * sel.numel() // sel.shape[1])
    k = torch.stack([gamma * s1 / ntot, gamma * s2 / ntot,
                     g_mu / ntot - 2.0 * g_var * mu / ntot,
                     2.0 * g_var / ntot])
    return s2, s1, k


def epilogue_bwd_dy_plain(y, g, sel, gamma, beta, mu, rstd, k):
    g, sel = g.to(torch.float32), sel.to(torch.float32)
    xs = (sel - _chan(mu, 5)) * _chan(rstd, 5)
    o = _chan(gamma, 5) * xs + _chan(beta, 5)
    dsg = g * torch.where(o >= 0, 1.0, SLOPE) * _chan(gamma, 5)
    y4 = _windows(y.to(torch.float32))
    eq = y4 == sel.unsqueeze(-1)
    prefix = (torch.cumsum(eq.to(torch.int32), dim=-1) - eq.to(torch.int32)) > 0
    dxhat = torch.where(eq & ~prefix, dsg.unsqueeze(-1), 0.0)
    ch = [_chan(v, 6) for v in (mu, rstd, *k)]
    xhat = (y4 - ch[0]) * ch[1]
    dy4 = ch[1] * (dxhat - ch[2] - xhat * ch[3]) + ch[4] + y4 * ch[5]
    return _unwindows(dy4).to(y.dtype)


# ---------------------------------------------------------------- wrappers


def _check_y(y: torch.Tensor) -> None:
    if y.ndim != 5 or y.shape[3] % 2 or y.shape[4] % 2:
        raise ValueError(f"epilogue: y must be [B, C, T, H, W] with H and W "
                         f"even, got {tuple(y.shape)}")


def _check_kernel_args(tensors, vecs, c: int) -> None:
    """`tensors` (y, g, sel) share one IO dtype, float32, bfloat16 or
    float16; the per-channel `vecs` are float32 [C]."""
    dev = tensors[0].device
    io = tensors[0].dtype
    if io not in _DTYPE_CODES:
        raise TypeError(f"epilogue kernel takes float32, bfloat16 or float16 "
                        f"tensors, got {io}")
    for t in tuple(tensors) + tuple(vecs):
        want = io if any(t is x for x in tensors) else torch.float32
        if t.dtype != want:
            raise TypeError(f"epilogue kernel: expected {want}, got "
                            f"{t.dtype}")
        if not t.is_cuda or t.device != dev:
            raise ValueError("epilogue kernel needs every tensor on one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError("epilogue kernel needs contiguous tensors")
    for v in vecs:
        if v.shape != (c,):
            raise ValueError(f"epilogue kernel: per-channel vectors must be "
                             f"[{c}], got {tuple(v.shape)}")


def _split(n: int, c: int, vec: int):
    """(blocks per channel, values per block, a multiple of `vec`, the
    values of one 16-byte load: 4 floats, 8 bf16 or fp16) for a channel sum
    over n values: a fixed partition, so the sums are deterministic."""
    nblk = max(1, min(-(-_TARGET_BLOCKS // c), -(-n // _MIN_PER_BLOCK)))
    chunk = -(-n // nblk)
    chunk = -(-chunk // vec) * vec
    return -(-n // chunk), chunk


@dataclasses.dataclass(frozen=True)
class ApplyPlan:
    """How `epilogue_apply` launches. windows 4: the vector path, grid
    (planes, bands) of blocks (bx, by), a block taking `band` pooled rows
    of one (b, c, t) plane and a thread 4 adjacent windows a step; windows
    1: the scalar path, grid (n, 1) of blocks (256, 1), a thread a window,
    a window row as one pair load when `pairs`."""

    windows: int
    pairs: bool
    grid: Tuple[int, int]
    block: Tuple[int, int]
    band: int


def apply_plan(shape, itemsize: int, y_addr: int, out_addr: int,
               sel_addr: int) -> ApplyPlan:
    """The plan of `epilogue_apply` for y of `shape` [B, C, T, H, W] with
    `itemsize`-byte values at address y_addr, out and sel at theirs. The
    vector path needs W/2 a multiple of 4 (a thread's 4 windows are 8
    values of each input row: one 16-byte load in bf16 and fp16, two in
    fp32), y
    16-byte aligned and out and sel aligned to 4 values (one store each);
    anything else takes the scalar path."""
    b, c, t, h, w = shape
    h2, w2 = h // 2, w // 2
    out_align = APPLY_WINDOWS * itemsize
    if (w2 % APPLY_WINDOWS or y_addr % 16 or out_addr % out_align
            or sel_addr % out_align):
        n_pool = b * c * t * h2 * w2
        return ApplyPlan(1, y_addr % (2 * itemsize) == 0,
                         (-(-n_pool // _THREADS), 1), (_THREADS, 1), 0)
    bx = min(w2 // APPLY_WINDOWS, _THREADS)
    by = max(1, min(_THREADS // bx, h2))
    band = max(by * APPLY_ROW_STEPS, -(-h2 // 65535))  # <= 65535 bands
    return ApplyPlan(APPLY_WINDOWS, False, (b * c * t, -(-h2 // band)),
                     (bx, by), band)


def _counters(device, c: int) -> torch.Tensor:
    """bwd reduce's per-channel counters on `device`: zeros that each call
    leaves zero. A train step's first (eager) call allocates them, before a
    CUDA graph captures the step (train/cuda_graph.py); a later, larger
    allocation keeps the one it replaces alive in `_RETIRED`."""
    cnt = _COUNTERS.get(device)
    if cnt is None or cnt.numel() < c:
        if cnt is not None:
            _RETIRED.append(cnt)
        cnt = torch.zeros(max(c, 64), dtype=torch.int32, device=device)
        _COUNTERS[device] = cnt
    return cnt


def _launch(symbol: str, device, args) -> None:
    from maavss_tpu_torch.ops import _build

    _build.launch(symbol, device, args)


def epilogue_stats(y: torch.Tensor):
    """-> (mu, var, rstd) [C] fp32 of y [B, C, T, H, W]."""
    _check_y(y)
    if not y.is_cuda:
        return epilogue_stats_plain(y)
    b, c, t, h, w = y.shape
    _check_kernel_args((y,), (), c)
    nblk, chunk = _split(b * t * h * w, c, 16 // y.element_size())
    partial = torch.empty(c, nblk, 2, dtype=torch.float32, device=y.device)
    mu, var, rstd = (torch.empty(c, dtype=torch.float32, device=y.device)
                     for _ in range(3))
    _launch("maavss_epilogue_stats", y.device, (
        y.data_ptr(), partial.data_ptr(), mu.data_ptr(), var.data_ptr(),
        rstd.data_ptr(), b, c, t, h, w, nblk, chunk, _DTYPE_CODES[y.dtype]))
    epilogue_stats.launches += 1
    return mu, var, rstd


epilogue_stats.launches = 0


def epilogue_apply(y, gamma, beta, mu, rstd):
    """-> (out, sel) [B, C, T, H/2, W/2]."""
    _check_y(y)
    if not y.is_cuda:
        return epilogue_apply_plain(y, gamma, beta, mu, rstd)
    b, c, t, h, w = y.shape
    _check_kernel_args((y,), (gamma, beta, mu, rstd), c)
    out = torch.empty(b, c, t, h // 2, w // 2, dtype=y.dtype,
                      device=y.device)
    sel = torch.empty_like(out)
    plan = apply_plan(y.shape, y.element_size(), y.data_ptr(),
                      out.data_ptr(), sel.data_ptr())
    _launch("maavss_epilogue_apply", y.device, (
        y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mu.data_ptr(),
        rstd.data_ptr(), out.data_ptr(), sel.data_ptr(), b, c, t, h, w,
        _DTYPE_CODES[y.dtype], plan.windows, int(plan.pairs), *plan.grid,
        *plan.block, plan.band))
    epilogue_apply.launches += 1
    return out, sel


epilogue_apply.launches = 0


def epilogue_bwd_reduce(g, sel, gamma, beta, mu, rstd, g_mu, g_var):
    """-> (dgamma, dbeta, k [4, C]) from g, sel [B, C, T, H/2, W/2]."""
    if not sel.is_cuda:
        return epilogue_bwd_reduce_plain(g, sel, gamma, beta, mu, rstd, g_mu,
                                         g_var)
    b, c, t, h2, w2 = sel.shape
    if g.shape != sel.shape:
        raise ValueError(f"epilogue bwd: g {tuple(g.shape)} != sel "
                         f"{tuple(sel.shape)}")
    _check_kernel_args((g, sel), (gamma, beta, mu, rstd, g_mu, g_var), c)
    nblk, chunk = _split(b * t * h2 * w2, c, 16 // g.element_size())
    partial = torch.empty(c, nblk, 2, dtype=torch.float32, device=g.device)
    dgamma, dbeta = (torch.empty(c, dtype=torch.float32, device=g.device)
                     for _ in range(2))
    k = torch.empty(4, c, dtype=torch.float32, device=g.device)
    _launch("maavss_epilogue_bwd_reduce", g.device, (
        g.data_ptr(), sel.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), g_mu.data_ptr(), g_var.data_ptr(),
        partial.data_ptr(), _counters(g.device, c).data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(),
        k.data_ptr(), b, c, t, 2 * h2, 2 * w2, nblk, chunk,
        _DTYPE_CODES[g.dtype]))
    epilogue_bwd_reduce.launches += 1
    return dgamma, dbeta, k


epilogue_bwd_reduce.launches = 0


def epilogue_bwd_dy(y, g, sel, gamma, beta, mu, rstd, k):
    """-> dy [B, C, T, H, W]."""
    _check_y(y)
    if not y.is_cuda:
        return epilogue_bwd_dy_plain(y, g, sel, gamma, beta, mu, rstd, k)
    b, c, t, h, w = y.shape
    pooled = (b, c, t, h // 2, w // 2)
    if g.shape != pooled or sel.shape != pooled or k.shape != (4, c):
        raise ValueError(f"epilogue bwd: g {tuple(g.shape)}, sel "
                         f"{tuple(sel.shape)}, k {tuple(k.shape)} do not fit "
                         f"y {tuple(y.shape)}")
    _check_kernel_args((y, g, sel), (gamma, beta, mu, rstd), c)
    if k.dtype != torch.float32 or not k.is_contiguous() \
            or k.device != y.device:
        raise ValueError("epilogue bwd: k must be a contiguous float32 "
                         "tensor on y's device")
    dy = torch.empty_like(y)
    _launch("maavss_epilogue_bwd_dy", y.device, (
        y.data_ptr(), g.data_ptr(), sel.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), mu.data_ptr(), rstd.data_ptr(), k.data_ptr(),
        dy.data_ptr(), b, c, t, h, w, _DTYPE_CODES[y.dtype]))
    epilogue_bwd_dy.launches += 1
    return dy


epilogue_bwd_dy.launches = 0


# ------------------------------------------------------------ split route


def _sum_slots(partial: torch.Tensor, lo: int, hi: int):
    """[C, n, 2] -> ([C], [C]): slots lo..hi-1 added in index order."""
    acc = partial[:, lo]
    for j in range(lo + 1, hi):
        acc = acc + partial[:, j]
    return acc[:, 0], acc[:, 1]


def epilogue_stats_partials(y: torch.Tensor, slots: int, slot: int,
                            plain: bool = False) -> torch.Tensor:
    """-> partial [C, slots * P, 2]: this launch's P partial (sum, sum of
    squares) a channel (P the kernel's blocks a channel; 1 in the plain
    version) at slot `slot`, zeros elsewhere."""
    _check_y(y)
    b, c, t, h, w = y.shape
    if plain or not y.is_cuda:
        yf = y.to(torch.float32)
        axes = (0, 2, 3, 4)
        partial = torch.zeros(c, slots, 2, dtype=torch.float32,
                              device=y.device)
        partial[:, slot, 0] = yf.sum(dim=axes)
        partial[:, slot, 1] = (yf * yf).sum(dim=axes)
        return partial
    _check_kernel_args((y,), (), c)
    nblk, chunk = _split(b * t * h * w, c, 16 // y.element_size())
    partial = torch.zeros(c, slots * nblk, 2, dtype=torch.float32,
                          device=y.device)
    _launch("maavss_epilogue_stats_partials", y.device, (
        y.data_ptr(), partial.data_ptr(), b, c, t, h, w, nblk, chunk,
        slots * nblk, slot * nblk, _DTYPE_CODES[y.dtype]))
    epilogue_stats_partials.launches += 1
    return partial


epilogue_stats_partials.launches = 0


def epilogue_stats_finish(partial: torch.Tensor, ntot: int,
                          plain: bool = False):
    """-> (mu, var, rstd) [C] from every partial of `partial` [C, n, 2],
    summed in one fixed order, over `ntot` values a channel."""
    if plain or not partial.is_cuda:
        s, ss = _sum_slots(partial, 0, partial.shape[1])
        mu = s / float(ntot)
        var = ss / float(ntot) - mu * mu
        return mu, var, torch.rsqrt(var + EPS)
    c, n = partial.shape[0], partial.shape[1]
    if partial.dtype != torch.float32 or not partial.is_contiguous():
        raise ValueError("epilogue stats finish: partial must be a "
                         "contiguous float32 tensor")
    mu, var, rstd = (torch.empty(c, dtype=torch.float32,
                                 device=partial.device) for _ in range(3))
    _launch("maavss_epilogue_stats_finish", partial.device, (
        partial.data_ptr(), n, int(ntot), mu.data_ptr(), var.data_ptr(),
        rstd.data_ptr(), c))
    epilogue_stats_finish.launches += 1
    return mu, var, rstd


epilogue_stats_finish.launches = 0


def epilogue_stats_split(y: torch.Tensor, plain: bool = False):
    """-> (mu, var, rstd) of the data group's global batch: partials, one
    all_reduce filling every rank's slots, finish."""
    from maavss_tpu_torch.parallel.collectives import all_sum_

    mesh, n, d = data_slot()
    partial = epilogue_stats_partials(y, n, d, plain)
    all_sum_(partial, mesh)
    b, _, t, h, w = y.shape
    return epilogue_stats_finish(partial, n * b * t * h * w, plain)


def epilogue_bwd_partials(g, sel, gamma, beta, mu, rstd, slots: int,
                          slot: int, plain: bool = False) -> torch.Tensor:
    """-> partial [C, slots * P, 2]: this launch's P partial (S1, S2) a
    channel at slot `slot` (the plain version: P = 1), zeros elsewhere."""
    b, c, t, h2, w2 = sel.shape
    if plain or not sel.is_cuda:
        dsel, xhat, _ = _dsel(g.to(torch.float32), sel.to(torch.float32),
                              gamma, beta, mu, rstd)
        axes = (0, 2, 3, 4)
        partial = torch.zeros(c, slots, 2, dtype=torch.float32,
                              device=sel.device)
        partial[:, slot, 0] = dsel.sum(dim=axes)
        partial[:, slot, 1] = (dsel * xhat).sum(dim=axes)
        return partial
    if g.shape != sel.shape:
        raise ValueError(f"epilogue bwd: g {tuple(g.shape)} != sel "
                         f"{tuple(sel.shape)}")
    _check_kernel_args((g, sel), (gamma, beta, mu, rstd), c)
    nblk, chunk = _split(b * t * h2 * w2, c, 16 // g.element_size())
    partial = torch.zeros(c, slots * nblk, 2, dtype=torch.float32,
                          device=g.device)
    _launch("maavss_epilogue_bwd_partials", g.device, (
        g.data_ptr(), sel.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), partial.data_ptr(), b, c, t, 2 * h2,
        2 * w2, nblk, chunk, slots * nblk, slot * nblk,
        _DTYPE_CODES[g.dtype]))
    epilogue_bwd_partials.launches += 1
    return partial


epilogue_bwd_partials.launches = 0


def epilogue_bwd_finish(partial: torch.Tensor, slots: int, slot: int, gamma,
                        mu, g_mu, g_var, ntot: int, plain: bool = False):
    """-> (dgamma, dbeta, k [4, C]): k from every partial of `partial`
    [C, n, 2] over `ntot` values a channel (g_mu, g_var the group's summed
    cotangents), dgamma and dbeta from slot `slot`'s partials alone (n
    divided into `slots` equal slots, one a rank)."""
    c, n = partial.shape[0], partial.shape[1]
    if n % slots:
        raise ValueError(f"epilogue bwd finish: {n} partials do not divide "
                         f"into {slots} slots")
    per = n // slots
    if plain or not partial.is_cuda:
        s1, s2 = _sum_slots(partial, 0, n)
        l1, l2 = _sum_slots(partial, slot * per, (slot + 1) * per)
        k = torch.stack([gamma * s1 / ntot, gamma * s2 / ntot,
                         g_mu / ntot - 2.0 * g_var * mu / ntot,
                         2.0 * g_var / ntot])
        return l2, l1, k
    for t in (gamma, mu, g_mu, g_var):
        if t.shape != (c,) or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != partial.device:
            raise ValueError("epilogue bwd finish: per-channel vectors must "
                             f"be contiguous float32 [{c}] on partial's "
                             "device")
    dgamma, dbeta = (torch.empty(c, dtype=torch.float32,
                                 device=partial.device) for _ in range(2))
    k = torch.empty(4, c, dtype=torch.float32, device=partial.device)
    _launch("maavss_epilogue_bwd_finish", partial.device, (
        partial.data_ptr(), n, slot * per, per, gamma.data_ptr(),
        mu.data_ptr(), g_mu.data_ptr(), g_var.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), k.data_ptr(), c, int(ntot)))
    epilogue_bwd_finish.launches += 1
    return dgamma, dbeta, k


epilogue_bwd_finish.launches = 0


def epilogue_bwd_reduce_split(g, sel, gamma, beta, mu, rstd, g_mu, g_var,
                              plain: bool = False):
    """-> (dgamma, dbeta, k) over the data group's global batch: partials,
    one all_reduce filling every rank's slots, the cotangents of mu and
    var summed over the group (fixed order), finish. dgamma and dbeta are
    this rank's own sums."""
    from maavss_tpu_torch.parallel.collectives import all_sum_, combine

    mesh, n, d = data_slot()
    partial = epilogue_bwd_partials(g, sel, gamma, beta, mu, rstd, n, d,
                                    plain)
    all_sum_(partial, mesh)
    g_mv = combine(torch.stack([g_mu, g_var]), mesh)
    b, _, t, h2, w2 = sel.shape
    return epilogue_bwd_finish(partial, n, d, gamma, mu,
                               g_mv[0].contiguous(), g_mv[1].contiguous(),
                               n * 4 * b * t * h2 * w2, plain)


def _ops(plain: bool, split: bool = False):
    """(stats, apply, bwd reduce, bwd dy): the wrappers, or the plain
    versions on any device; `split`, the reductions' split routes."""
    if split:
        return (lambda y: epilogue_stats_split(y, plain),
                epilogue_apply_plain if plain else epilogue_apply,
                lambda *a: epilogue_bwd_reduce_split(*a, plain=plain),
                epilogue_bwd_dy_plain if plain else epilogue_bwd_dy)
    if plain:
        return (epilogue_stats_plain, epilogue_apply_plain,
                epilogue_bwd_reduce_plain, epilogue_bwd_dy_plain)
    return (epilogue_stats, epilogue_apply, epilogue_bwd_reduce,
            epilogue_bwd_dy)


class _FusedEpilogue(torch.autograd.Function):
    """(y, gamma, beta) -> (out, mu, var), as `_fused_core` with its
    custom VJP: y, sel, mu, rstd, gamma and beta are the residuals."""

    @staticmethod
    def forward(ctx, y, gamma, beta, plain, split):
        stats, apply, _, _ = _ops(plain, split)
        mu, var, rstd = stats(y)
        out, sel = apply(y, gamma, beta, mu, rstd)
        ctx.save_for_backward(y, sel, gamma, beta, mu, rstd)
        ctx.plain, ctx.split = plain, split
        return out, mu, var

    @staticmethod
    def backward(ctx, g_out, g_mu, g_var):
        y, sel, gamma, beta, mu, rstd = ctx.saved_tensors
        _, _, reduce, dy_pass = _ops(ctx.plain, ctx.split)
        g_out = g_out.contiguous()
        dgamma, dbeta, k = reduce(g_out, sel, gamma, beta, mu, rstd,
                                  g_mu.contiguous(), g_var.contiguous())
        dy = dy_pass(y, g_out, sel, gamma, beta, mu, rstd, k)
        return dy, dgamma, dbeta, None, None


def fused_bn_pool_leaky(y: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, split: bool = False):
    """Differentiable fused tail -> (out, mu, var); see the module
    docstring. `split`: the split route (the data group's statistics)."""
    return _FusedEpilogue.apply(y, gamma, beta, False, split)


def fused_bn_pool_leaky_plain(y: torch.Tensor, gamma: torch.Tensor,
                              beta: torch.Tensor, split: bool = False):
    """The same function and explicit backward through the plain versions
    on any device: the reference the kernels are held against on the
    card."""
    return _FusedEpilogue.apply(y, gamma, beta, True, split)
