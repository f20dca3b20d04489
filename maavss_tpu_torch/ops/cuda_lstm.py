"""LSTM recurrence: the hand-written CUDA kernels (`csrc/lstm_fwd.cu`, the
forward, and `csrc/lstm_bwd.cu`, the BPTT backward) and their plain PyTorch
versions, joined by an autograd Function.

Counterpart of maavss_tpu/ops/pallas_lstm.py (`pallas_lstm` and its custom
VJP). Contract per direction, in the module's batch-major layout:

    ys, cs = recurrence(xw [B, T, 4H], w_h [H, 4H], reverse)   # [B, T, H] each
    dxw, dw_h = recurrence_bwd(xw, w_h, ys, cs, dys, reverse)

with the input projection `xw = x @ w_i` precomputed by the caller, gate
columns in torch order [i | f | g | o], h_0 = c_0 = 0, an fp32 carry and IO
in xw's type (fp32 or bf16). `reverse=True` runs t = T-1 .. 0 and returns ys
in the original time order, i.e. flip(recurrence(flip(xw))); its backward
is the flip of the forward direction's.

`lstm_recurrence` and `lstm_recurrence_bwd` take one or two directions and
run them in ONE launch on a CUDA tensor (the backward's launch is a sweep
kernel and a dW_h kernel); on a CPU tensor they run the plain versions.
There is no fallback from a kernel to the plain version on the card.
`lstm_bidir` is the autograd Function over both directions: its forward
saves (xw, w_h, ys, cs) as `_vjp_fwd` does, its backward is the BPTT.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def lstm_recurrence_plain(xw: torch.Tensor, w_h: torch.Tensor,
                          reverse: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-step loop of maavss_tpu/models/layers.py:722-737 with the
    kernel's fp32 carry; one torch.matmul per step."""
    b, t_len, four_h = xw.shape
    h_dim = four_h // 4
    xw32 = xw.to(torch.float32)
    wh32 = w_h.to(torch.float32)
    h = torch.zeros(b, h_dim, dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    ys = torch.empty(b, t_len, h_dim, dtype=torch.float32, device=xw.device)
    cs = torch.empty_like(ys)
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        gates = xw32[:, t] + h @ wh32
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[:, t] = h
        cs[:, t] = c
    return ys.to(xw.dtype), cs.to(xw.dtype)


def _check_kernel_args(xws: Sequence[torch.Tensor],
                       w_hs: Sequence[torch.Tensor]) -> None:
    if not 1 <= len(xws) <= 2 or len(xws) != len(w_hs):
        raise ValueError("lstm kernel runs one or two directions per launch")
    b, t_len, four_h = xws[0].shape
    h_dim = four_h // 4
    if four_h != 4 * h_dim or not (32 <= h_dim <= 1024 and h_dim % 32 == 0):
        raise ValueError(f"lstm kernel needs 4H with H a multiple of 32 in "
                         f"[32, 1024] (one thread per hidden unit), got "
                         f"{four_h}")
    for xw, w_h in zip(xws, w_hs):
        if xw.shape != (b, t_len, four_h) or w_h.shape != (h_dim, four_h):
            raise ValueError(f"lstm kernel shapes: xw {tuple(xw.shape)}, "
                             f"w_h {tuple(w_h.shape)}; want xw [B,T,4H] and "
                             f"w_h [H,4H], the same for both directions")
        if not (xw.is_cuda and w_h.device == xw.device
                and xw.device == xws[0].device):
            raise ValueError("lstm kernel needs every tensor on one CUDA device")
        if xw.dtype not in _DTYPE_CODES or w_h.dtype != xw.dtype \
                or xw.dtype != xws[0].dtype:
            raise TypeError(f"lstm kernel takes float32 or bfloat16 xw and "
                            f"w_h of one dtype, got {xw.dtype}/{w_h.dtype}")
        if not (xw.is_contiguous() and w_h.is_contiguous()):
            raise ValueError("lstm kernel needs contiguous xw and w_h")


def lstm_recurrence(xws: Sequence[torch.Tensor], w_hs: Sequence[torch.Tensor],
                    reverses: Sequence[bool], backend: str = "auto"
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One or two directions -> [(ys, cs), ...] in the same order.

    backend 'auto': the kernel for CUDA tensors, the plain version for CPU
    tensors. 'kernel': the kernel, and a CPU tensor raises."""
    if backend not in ("auto", "kernel"):
        raise ValueError(f"unknown lstm backend {backend!r} (auto|kernel)")
    if not xws[0].is_cuda:
        if backend == "kernel":
            raise RuntimeError("the CUDA lstm kernel needs CUDA tensors")
        return [lstm_recurrence_plain(x, w, r)
                for x, w, r in zip(xws, w_hs, reverses)]
    _check_kernel_args(xws, w_hs)
    from maavss_tpu_torch.ops import _build

    b, t_len, four_h = xws[0].shape
    outs = [(torch.empty(b, t_len, four_h // 4, dtype=x.dtype, device=x.device),
             torch.empty(b, t_len, four_h // 4, dtype=x.dtype, device=x.device))
            for x in xws]
    args = []
    for k in range(2):
        j = min(k, len(xws) - 1)
        args += [xws[j].data_ptr(), w_hs[j].data_ptr(), outs[j][0].data_ptr(),
                 outs[j][1].data_ptr(), int(bool(reverses[j]))]
    _build.launch("maavss_lstm_fwd", xws[0].device, (
        *args, len(xws), b, t_len, four_h // 4, _DTYPE_CODES[xws[0].dtype]))
    lstm_recurrence.launches += 1
    return outs


lstm_recurrence.launches = 0


def lstm_recurrence_bwd_plain(xw: torch.Tensor, w_h: torch.Tensor,
                              ys: torch.Tensor, cs: torch.Tensor,
                              dys: torch.Tensor, reverse: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The explicit BPTT of maavss_tpu/ops/pallas_lstm.py:116-148 in fp32,
    batch-major: gates recomputed from the saved ys/cs, dW_h summed over
    (b, t). Returns (dxw in xw's type, dw_h in w_h's type)."""
    b, t_len, four_h = xw.shape
    h_dim = four_h // 4
    f32 = torch.float32
    xw32, wh32 = xw.to(f32), w_h.to(f32)
    ys32, cs32, dys32 = ys.to(f32), cs.to(f32), dys.to(f32)
    dxw = torch.empty(b, t_len, four_h, dtype=f32, device=xw.device)
    dwh = torch.zeros(h_dim, four_h, dtype=f32, device=xw.device)
    dh_next = torch.zeros(b, h_dim, dtype=f32, device=xw.device)
    dc_next = torch.zeros_like(dh_next)
    steps = range(t_len) if reverse else range(t_len - 1, -1, -1)
    for t in steps:
        tp = t + 1 if reverse else t - 1
        if 0 <= tp < t_len:
            h_prev, c_prev = ys32[:, tp], cs32[:, tp]
        else:
            h_prev = c_prev = torch.zeros_like(dh_next)
        gates = xw32[:, t] + h_prev @ wh32
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), \
            torch.tanh(g)
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
    return dxw.to(xw.dtype), dwh.to(w_h.dtype)


def lstm_recurrence_bwd(xws: Sequence[torch.Tensor],
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
    if not xws[0].is_cuda:
        if backend == "kernel":
            raise RuntimeError("the CUDA lstm kernel needs CUDA tensors")
        return [lstm_recurrence_bwd_plain(*a)
                for a in zip(xws, w_hs, yss, css, dyss, reverses)]
    _check_kernel_args(xws, w_hs)
    seq_shape = xws[0].shape[:2] + (xws[0].shape[2] // 4,)
    for t in list(yss) + list(css) + list(dyss):
        if t.shape != seq_shape or t.dtype != xws[0].dtype \
                or t.device != xws[0].device or not t.is_contiguous():
            raise ValueError(f"lstm bwd kernel: ys/cs/dys must be contiguous "
                             f"{tuple(seq_shape)} {xws[0].dtype} on "
                             f"{xws[0].device}, got {tuple(t.shape)} {t.dtype}")
    from maavss_tpu_torch.ops import _build

    b, t_len, four_h = xws[0].shape
    outs, args = [], []
    for xw, w_h in zip(xws, w_hs):
        dxw = torch.empty_like(xw)
        # the dW_h kernel reads fp32 dgates: dxw itself in fp32, a scratch
        # in bf16
        dg = dxw if xw.dtype == torch.float32 else torch.empty(
            xw.shape, dtype=torch.float32, device=xw.device)
        outs.append((dxw, torch.empty_like(w_h), dg))
    for k in range(2):
        j = min(k, len(xws) - 1)
        args += [xws[j].data_ptr(), w_hs[j].data_ptr(), yss[j].data_ptr(),
                 css[j].data_ptr(), dyss[j].data_ptr(), outs[j][0].data_ptr(),
                 outs[j][2].data_ptr(), outs[j][1].data_ptr(),
                 int(bool(reverses[j]))]
    _build.launch("maavss_lstm_bwd", xws[0].device, (
        *args, len(xws), b, t_len, four_h // 4, _DTYPE_CODES[xws[0].dtype]))
    lstm_recurrence_bwd.launches += 1
    return [(dxw, dwh) for dxw, dwh, _ in outs]


lstm_recurrence_bwd.launches = 0


class _BiRecurrence(torch.autograd.Function):
    """(xw_f, xw_b, w_h_f, w_h_b) -> (ys_f, ys_b): both directions' forward
    in one launch, both backward sweeps in one launch."""

    @staticmethod
    def forward(ctx, xw_f, xw_b, wh_f, wh_b, backend):
        xws = [xw_f.contiguous(), xw_b.contiguous()]
        whs = [wh_f.contiguous(), wh_b.contiguous()]
        (ys_f, cs_f), (ys_b, cs_b) = lstm_recurrence(xws, whs, [False, True],
                                                     backend=backend)
        ctx.save_for_backward(*xws, *whs, ys_f, cs_f, ys_b, cs_b)
        ctx.backend = backend
        return ys_f, ys_b

    @staticmethod
    def backward(ctx, dys_f, dys_b):
        xw_f, xw_b, wh_f, wh_b, ys_f, cs_f, ys_b, cs_b = ctx.saved_tensors
        dys = [torch.zeros_like(ys) if d is None else d.contiguous()
               for d, ys in ((dys_f, ys_f), (dys_b, ys_b))]
        (dxw_f, dwh_f), (dxw_b, dwh_b) = lstm_recurrence_bwd(
            [xw_f, xw_b], [wh_f, wh_b], [ys_f, ys_b], [cs_f, cs_b], dys,
            [False, True], backend=ctx.backend)
        return dxw_f, dxw_b, dwh_f, dwh_b, None


def lstm_bidir(xw_f: torch.Tensor, xw_b: torch.Tensor, wh_f: torch.Tensor,
               wh_b: torch.Tensor, backend: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and reverse recurrences, differentiable in xw and w_h:
    (ys_f, ys_b), each [B, T, H]. backend as `lstm_recurrence`."""
    return _BiRecurrence.apply(xw_f, xw_b, wh_f, wh_b, backend)
