"""LSTM recurrence: the hand-written CUDA kernel (`csrc/lstm_fwd.cu`) and its
plain PyTorch version.

Counterpart of maavss_tpu/ops/pallas_lstm.py (forward only; the BPTT
backward is a later port). Contract per direction, in the module's
batch-major layout:

    ys, cs = recurrence(xw [B, T, 4H], w_h [H, 4H], reverse)   # [B, T, H] each

with the input projection `xw = x @ w_i` precomputed by the caller, gate
columns in torch order [i | f | g | o], h_0 = c_0 = 0, an fp32 carry and IO
in xw's type (fp32 or bf16). `reverse=True` runs t = T-1 .. 0 and returns ys
in the original time order, i.e. flip(recurrence(flip(xw))).

`lstm_recurrence` takes one or two directions and runs them in ONE launch on
a CUDA tensor; on a CPU tensor it runs the plain version. There is no
fallback from the kernel to the plain version on the card.
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

    lib = _build.library()
    b, t_len, four_h = xws[0].shape
    outs = [(torch.empty(b, t_len, four_h // 4, dtype=x.dtype, device=x.device),
             torch.empty(b, t_len, four_h // 4, dtype=x.dtype, device=x.device))
            for x in xws]
    args = []
    for k in range(2):
        j = min(k, len(xws) - 1)
        args += [xws[j].data_ptr(), w_hs[j].data_ptr(), outs[j][0].data_ptr(),
                 outs[j][1].data_ptr(), int(bool(reverses[j]))]
    stream = torch.cuda.current_stream(xws[0].device).cuda_stream
    with torch.cuda.device(xws[0].device):
        err = lib.maavss_lstm_fwd(*args, len(xws), b, t_len, four_h // 4,
                                  _DTYPE_CODES[xws[0].dtype], stream)
    _build.check(err, "maavss_lstm_fwd")
    lstm_recurrence.launches += 1
    return outs


lstm_recurrence.launches = 0
