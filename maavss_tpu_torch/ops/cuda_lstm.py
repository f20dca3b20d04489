"""LSTM recurrence: the hand-written CUDA kernels (`csrc/lstm_fwd.cu`, the
forward, and `csrc/lstm_bwd.cu`, the BPTT backward) and their plain PyTorch
versions, joined by an autograd Function.

Counterpart of maavss_tpu/ops/pallas_lstm.py (`pallas_lstm` and its custom
VJP). Contract per direction, in the module's batch-major layout:

    ys, cs, acts = recurrence(xw [B, T, 4H], w_h [H, 4H], reverse)
    dxw, dw_h = recurrence_bwd(acts, w_h, ys, cs, dys, reverse)

with the input projection `xw = x @ w_i` precomputed by the caller, gate
columns in torch order [i | f | g | o], h_0 = c_0 = 0, an fp32 carry and IO
in xw's type (fp32, bf16 or fp16); ys and cs are [B, T, H], acts the fp32 gate
activations [B, T, 4H] = [sigmoid(i) | sigmoid(f) | tanh(g) | sigmoid(o)],
which the backward reads in place of a recompute (the kernel writes them
only where they are asked for, `save_acts`: None in their place else). `reverse=True` runs
t = T-1 .. 0 and returns ys in the original time order, i.e.
flip(recurrence(flip(xw))); its backward is the flip of the forward
direction's.

`lstm_recurrence` and `lstm_recurrence_bwd` take one or two directions and
run them in ONE launch of thread-block clusters on a CUDA tensor (the
backward adds a dW_h kernel), with the geometry of `lstm_geometry`; on a CPU
tensor they run the plain versions. The forward launches through the
registered op `maavss_tpu_torch::lstm_fwd` (ops/registry.py, its body
`lstm_fwd_launch`), so that an exported serving program carries it; the
backward is a direct launch. There is no fallback from a kernel to
the plain version on the card: a shape the kernels do not take raises.
`lstm_bidir` is the autograd Function over both directions: its forward
saves (w_h, ys, cs, acts) when a gradient is wanted, its backward is the
BPTT.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

CLUSTER = 16  # CTAs per cluster, lstm_cluster.cuh's kCluster: H = 256
# gives each 16 hidden units
H_MAX = 448  # the largest H whose per-CTA slices fit at CLUSTER (one row)
SMEM_MAX = 232448  # bytes of shared memory a block may use (227 KB)
# 16-CTA clusters an H100 SXM runs side by side, one CTA an SM (a cluster
# sits inside one GPC): what csrc/lstm_fwd.cu:maavss_lstm_clusters_at_once
# reads on the card, and the default here
CLUSTERS_AT_ONCE = 7


class LstmGeometry(NamedTuple):
    """Launch geometry of both K1 kernels (csrc/lstm_cluster.cuh): one
    cluster of CLUSTER CTAs per (direction, group of `rows` batch rows),
    `groups` clusters per direction; the dynamic shared bytes per CTA of the
    forward and of the backward sweep. The launchers take `rows` and derive
    the rest themselves."""
    rows: int
    groups: int
    fwd_smem: int
    bwd_smem: int


def _smem_bytes(h: int, rows: int, cluster: int = CLUSTER
                ) -> Tuple[int, int]:
    """(forward, backward) shared bytes per CTA, as lstm_cluster.cuh lays
    them out (its make_geometry)."""
    u = h // cluster
    c = 4 * u
    w = h * (c + 4)  # the resident w_h slice, rows padded
    fwd = w + 2 * rows * h + 4 * rows * c + rows * u
    bwd = w + rows * c + 2 * rows * h + rows * u
    return 4 * fwd, 4 * bwd


@functools.lru_cache(maxsize=64)
def lstm_geometry(b: int, h: int, dtype: torch.dtype = torch.float32,
                  n_dir: int = 2, clusters: int = CLUSTERS_AT_ONCE
                  ) -> LstmGeometry:
    """The K1 kernels' launch geometry for batch b, hidden width h and IO
    type dtype (the w_h slices live in shared memory as fp32 for both
    types, so the geometry is the same).

    Rows per cluster: the fewest of 1, 2, 4, 8 whose n_dir * ceil(b / rows)
    clusters the card runs side by side (`clusters`, one CTA an SM), else
    the most, and no more than fit the shared memory. A cluster that has to
    share SMs with another runs its chain slower than one with more rows
    (tools/k1_probe_torch.py: at B = 8, 8 clusters of 2 rows take longer
    than 4 of 4). Raises TypeError for another
    dtype and ValueError for an h the kernels do not take: a multiple of 32
    in [32, H_MAX]."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"lstm kernel takes float32, bfloat16 or float16, "
                        f"got {dtype}")
    if not (32 <= h <= H_MAX and h % 32 == 0):
        raise ValueError(f"lstm kernel takes a hidden width H that is a "
                         f"multiple of 32 in [32, {H_MAX}] (its w_h slices "
                         f"must fit shared memory), got {h}")
    # one row always fits up to H_MAX
    fits = [r for r in (1, 2, 4, 8) if max(_smem_bytes(h, r)) <= SMEM_MAX]
    rows = next((r for r in fits if n_dir * -(-b // r) <= clusters),
                fits[-1])
    return LstmGeometry(rows, -(-b // rows), *_smem_bytes(h, rows))


@functools.lru_cache(maxsize=None)
def _clusters_at_once(index: int) -> int:
    """The clusters the card `index` runs side by side (the C query)."""
    from maavss_tpu_torch.ops import _build

    with torch.cuda.device(index):
        n = _build.library().maavss_lstm_clusters_at_once()
    if n <= 0:
        raise RuntimeError(f"maavss_lstm_clusters_at_once: cudaError_t {-n}"
                           if n < 0 else "no cluster of 16 CTAs fits the "
                           "card")
    return n


def lstm_recurrence_plain(xw: torch.Tensor, w_h: torch.Tensor,
                          reverse: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-step loop of maavss_tpu/models/layers.py:722-737 with the
    kernel's fp32 carry; one torch.matmul per step. Returns (ys, cs) in xw's
    type and the fp32 gate activations."""
    b, t_len, four_h = xw.shape
    h_dim = four_h // 4
    xw32 = xw.to(torch.float32)
    wh32 = w_h.to(torch.float32)
    h = torch.zeros(b, h_dim, dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    ys = torch.empty(b, t_len, h_dim, dtype=torch.float32, device=xw.device)
    cs = torch.empty_like(ys)
    acts = torch.empty(b, t_len, four_h, dtype=torch.float32,
                       device=xw.device)
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        gates = xw32[:, t] + h @ wh32
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys[:, t] = h
        cs[:, t] = c
        acts[:, t] = torch.cat([i, f, g, o], dim=-1)
    return ys.to(xw.dtype), cs.to(xw.dtype), acts


def _check_dirs(n: int, *lists: Sequence) -> None:
    if not 1 <= n <= 2 or any(len(x) != n for x in lists):
        raise ValueError("lstm kernel runs one or two directions per launch")


def _check_tensors(tensors: Sequence[torch.Tensor], shape, dtype, device,
                   what: str) -> None:
    for t in tensors:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"lstm kernel: {what} must be {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_cuda or t.device != device:
            raise ValueError("lstm kernel needs every tensor on one CUDA "
                             "device")
        if t.dtype != dtype:
            raise TypeError(f"lstm kernel: {what} must be {dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lstm kernel needs a contiguous {what}")


def _kernel_geometry(x: torch.Tensor, h_dim: int, n_dir: int
                     ) -> LstmGeometry:
    """The geometry for x's batch and type on its device."""
    return lstm_geometry(x.shape[0], h_dim, x.dtype, n_dir,
                         _clusters_at_once(x.device.index))


def lstm_recurrence(xws: Sequence[torch.Tensor], w_hs: Sequence[torch.Tensor],
                    reverses: Sequence[bool], backend: str = "auto",
                    save_acts: bool = True
                    ) -> List[Tuple[torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor]]]:
    """One or two directions -> [(ys, cs, acts), ...] in the same order;
    acts is None unless `save_acts`.

    backend 'auto': the kernel for CUDA tensors, the plain version for CPU
    tensors. 'kernel': the kernel, and a CPU tensor raises."""
    if backend not in ("auto", "kernel"):
        raise ValueError(f"unknown lstm backend {backend!r} (auto|kernel)")
    if not xws[0].is_cuda:
        if backend == "kernel":
            raise RuntimeError("the CUDA lstm kernel needs CUDA tensors")
        outs = [lstm_recurrence_plain(x, w, r)
                for x, w, r in zip(xws, w_hs, reverses)]
        return outs if save_acts else [(ys, cs, None) for ys, cs, _ in outs]
    _check_dirs(len(xws), w_hs, reverses)
    b, t_len, four_h = xws[0].shape
    h_dim = four_h // 4
    if four_h != 4 * h_dim:
        raise ValueError(f"lstm kernel: xw's last axis must be 4H, got "
                         f"{four_h}")
    dtype, dev = xws[0].dtype, xws[0].device
    _check_tensors(xws, (b, t_len, four_h), dtype, dev, "xw [B, T, 4H]")
    _check_tensors(w_hs, (h_dim, four_h), dtype, dev, "w_h [H, 4H]")
    lstm_geometry(b, h_dim, dtype, len(xws))  # raises on what K1 refuses
    from maavss_tpu_torch.ops import registry

    flat = registry.call["lstm_fwd"](list(xws), list(w_hs),
                                     [bool(r) for r in reverses],
                                     bool(save_acts))
    per = 3 if save_acts else 2
    return [tuple(flat[k * per:(k + 1) * per]) + (() if save_acts else (None,))
            for k in range(len(xws))]


def lstm_fwd_launch(xws: List[torch.Tensor], w_hs: List[torch.Tensor],
                    reverses: List[bool], save_acts: bool
                    ) -> List[torch.Tensor]:
    """The registered op `lstm_fwd` on CUDA (ops/registry.py): K1-fwd's one
    launch over checked arguments -> [ys, cs(, acts)] per direction."""
    from maavss_tpu_torch.ops import _build

    b, t_len, four_h = xws[0].shape
    h_dim = four_h // 4
    dtype, dev = xws[0].dtype, xws[0].device
    geo = _kernel_geometry(xws[0], h_dim, len(xws))
    outs = [(torch.empty(b, t_len, h_dim, dtype=dtype, device=dev),
             torch.empty(b, t_len, h_dim, dtype=dtype, device=dev),
             torch.empty(b, t_len, four_h, dtype=torch.float32, device=dev)
             if save_acts else None)
            for _ in xws]
    args = []
    for k in range(2):
        j = min(k, len(xws) - 1)
        args += [xws[j].data_ptr(), w_hs[j].data_ptr(),
                 *(0 if o is None else o.data_ptr() for o in outs[j]),
                 int(bool(reverses[j]))]
    _build.launch("maavss_lstm_fwd", dev, (
        *args, len(xws), b, t_len, h_dim, _DTYPE_CODES[dtype], geo.rows))
    lstm_recurrence.launches += 1
    return [t for out in outs for t in out if t is not None]


lstm_recurrence.launches = 0


def lstm_recurrence_bwd_plain(acts: torch.Tensor, w_h: torch.Tensor,
                              ys: torch.Tensor, cs: torch.Tensor,
                              dys: torch.Tensor, reverse: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The explicit BPTT of maavss_tpu/ops/pallas_lstm.py:116-148 in fp32,
    batch-major, from the forward's saved gate activations: dW_h summed
    over (b, t). Returns (dxw in ys' type, dw_h in w_h's type)."""
    b, t_len, h_dim = ys.shape
    f32 = torch.float32
    wh32 = w_h.to(f32)
    ys32, cs32, dys32 = ys.to(f32), cs.to(f32), dys.to(f32)
    dxw = torch.empty(b, t_len, 4 * h_dim, dtype=f32, device=ys.device)
    dwh = torch.zeros(h_dim, 4 * h_dim, dtype=f32, device=ys.device)
    dh_next = torch.zeros(b, h_dim, dtype=f32, device=ys.device)
    dc_next = torch.zeros_like(dh_next)
    steps = range(t_len) if reverse else range(t_len - 1, -1, -1)
    for t in steps:
        tp = t + 1 if reverse else t - 1
        if 0 <= tp < t_len:
            h_prev, c_prev = ys32[:, tp], cs32[:, tp]
        else:
            h_prev = c_prev = torch.zeros_like(dh_next)
        i, f, g, o = acts[:, t].to(f32).chunk(4, dim=-1)
        tanh_c = torch.tanh(cs32[:, t])
        dh = dys32[:, t] + dh_next
        do = dh * tanh_c
        dc = dh * o * (1.0 - tanh_c * tanh_c) + dc_next
        dgates = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dxw[:, t] = dgates
        dwh += h_prev.T @ dgates
        dh_next = dgates @ wh32.T
        dc_next = dc * f
    return dxw.to(ys.dtype), dwh.to(w_h.dtype)


def lstm_recurrence_bwd(actss: Sequence[torch.Tensor],
                        w_hs: Sequence[torch.Tensor],
                        yss: Sequence[torch.Tensor],
                        css: Sequence[torch.Tensor],
                        dyss: Sequence[torch.Tensor],
                        reverses: Sequence[bool], backend: str = "auto"
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One or two directions' BPTT -> [(dxw, dw_h), ...] in the same order.

    backend 'auto': the kernel for CUDA tensors, the plain version for CPU
    tensors. 'kernel': the kernel, and a CPU tensor raises."""
    if backend not in ("auto", "kernel"):
        raise ValueError(f"unknown lstm backend {backend!r} (auto|kernel)")
    if not yss[0].is_cuda:
        if backend == "kernel":
            raise RuntimeError("the CUDA lstm kernel needs CUDA tensors")
        return [lstm_recurrence_bwd_plain(*a)
                for a in zip(actss, w_hs, yss, css, dyss, reverses)]
    _check_dirs(len(yss), actss, w_hs, css, dyss, reverses)
    b, t_len, h_dim = yss[0].shape
    dtype, dev = yss[0].dtype, yss[0].device
    geo = _kernel_geometry(yss[0], h_dim, len(yss))
    _check_tensors(list(yss) + list(css) + list(dyss), (b, t_len, h_dim),
                   dtype, dev, "ys/cs/dys [B, T, H]")
    _check_tensors(w_hs, (h_dim, 4 * h_dim), dtype, dev, "w_h [H, 4H]")
    _check_tensors(actss, (b, t_len, 4 * h_dim), torch.float32, dev,
                   "acts [B, T, 4H]")
    from maavss_tpu_torch.ops import _build

    outs, args = [], []
    for w_h in w_hs:
        dxw = torch.empty(b, t_len, 4 * h_dim, dtype=dtype, device=dev)
        # the dW_h kernel reads fp32 dgates: dxw itself in fp32, a scratch
        # below fp32
        dg = dxw if dtype == torch.float32 else torch.empty(
            dxw.shape, dtype=torch.float32, device=dev)
        outs.append((dxw, torch.empty_like(w_h), dg))
    for k in range(2):
        j = min(k, len(yss) - 1)
        args += [actss[j].data_ptr(), w_hs[j].data_ptr(), yss[j].data_ptr(),
                 css[j].data_ptr(), dyss[j].data_ptr(), outs[j][0].data_ptr(),
                 outs[j][2].data_ptr(), outs[j][1].data_ptr(),
                 int(bool(reverses[j]))]
    _build.launch("maavss_lstm_bwd", dev, (
        *args, len(yss), b, t_len, h_dim, _DTYPE_CODES[dtype], geo.rows))
    lstm_recurrence_bwd.launches += 1
    return [(dxw, dwh) for dxw, dwh, _ in outs]


lstm_recurrence_bwd.launches = 0


class _BiRecurrence(torch.autograd.Function):
    """(xw_f, xw_b, w_h_f, w_h_b) -> (ys_f, ys_b): both directions' forward
    in one launch, both backward sweeps in one launch. The forward saves
    the gate activations only where a gradient is wanted."""

    @staticmethod
    def forward(ctx, xw_f, xw_b, wh_f, wh_b, backend, save):
        xws = [xw_f.contiguous(), xw_b.contiguous()]
        whs = [wh_f.contiguous(), wh_b.contiguous()]
        (ys_f, cs_f, a_f), (ys_b, cs_b, a_b) = lstm_recurrence(
            xws, whs, [False, True], backend=backend, save_acts=save)
        if save:
            ctx.save_for_backward(*whs, ys_f, cs_f, a_f, ys_b, cs_b, a_b)
        ctx.backend = backend
        return ys_f, ys_b

    @staticmethod
    def backward(ctx, dys_f, dys_b):
        wh_f, wh_b, ys_f, cs_f, a_f, ys_b, cs_b, a_b = ctx.saved_tensors
        dys = [torch.zeros_like(ys) if d is None else d.contiguous()
               for d, ys in ((dys_f, ys_f), (dys_b, ys_b))]
        (dxw_f, dwh_f), (dxw_b, dwh_b) = lstm_recurrence_bwd(
            [a_f, a_b], [wh_f, wh_b], [ys_f, ys_b], [cs_f, cs_b], dys,
            [False, True], backend=ctx.backend)
        return dxw_f, dxw_b, dwh_f, dwh_b, None, None


def lstm_bidir(xw_f: torch.Tensor, xw_b: torch.Tensor, wh_f: torch.Tensor,
               wh_b: torch.Tensor, backend: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and reverse recurrences, differentiable in xw and w_h:
    (ys_f, ys_b), each [B, T, H]. backend as `lstm_recurrence`."""
    inputs = (xw_f, xw_b, wh_f, wh_b)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    return _BiRecurrence.apply(*inputs, backend, save)
