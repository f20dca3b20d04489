"""K4's mask product fused into the `a_fc1` head: the hand-written CUDA
kernels of `csrc/mask_head.cu` and their plain PyTorch versions.

`mask_head_apply(h, weight, bias, stft)` is the `--mask_head` audio head of
both model families: the head `h @ weight.T + bias` read as a planar
complex ratio mask in `a_fc1`'s layout (column j < P the real part of bin
j, column j + P its imaginary part, P = T * F) and applied to the planar
STFT `[M, 2, T, F]`, i.e.

    complex_mask_apply(stft, F.linear(h, weight, bias).reshape(stft.shape))

On CUDA tensors it is one launch forward and two backward (the head's
product, the bias and the mask product in one kernel; d_h's cross-block sum
in its own fixed-order pass): the mask never reaches device memory. On CPU
tensors the same autograd Function runs the plain versions, which give the
values of F.linear followed by the plain mask product under autograd, bit
for bit. `mask_head_apply_plain` is that composition itself, on any device:
the reference the kernels are held against on the card.

The wrappers `mask_head_fwd` and `mask_head_bwd` launch the kernels on
CUDA tensors (fp32; h and weight contiguous and 16-byte aligned with K a
multiple of 4, bias contiguous; the STFT and the cotangent read in place
through their (item, plane, row) strides; nothing is copied and nothing
falls back) and count their launches in `mask_head_apply.launches` and
`mask_head_apply.bwd_launches`. The forward launches through the registered
op `maavss_tpu_torch::mask_head_fwd` (ops/registry.py, its body
`mask_head_fwd_launch`), so that an exported serving program carries it;
the backward is a direct launch. Where the STFT itself needs a gradient (no
path of the system asks for one), the forward also writes the mask and the
backward takes d_stft through the standalone `mask_mul(g, mask,
conj=True)`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from maavss_tpu_torch.ops import cuda_complex as cc


def _dims(h: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], stft: torch.Tensor
          ) -> Tuple[int, int, int, int]:
    """(M, K, T, F), or raise on shapes that do not fit together."""
    cc._check_planar("mask_head_apply", stft)
    if h.ndim != 2 or weight.ndim != 2 or stft.ndim != 4:
        raise ValueError(f"mask_head_apply: h [M, K], weight [2P, K] and "
                         f"stft [M, 2, T, F], got {tuple(h.shape)}, "
                         f"{tuple(weight.shape)}, {tuple(stft.shape)}")
    m, k = h.shape
    t, f = stft.shape[-2:]
    if weight.shape != (2 * t * f, k) or stft.shape[0] != m:
        raise ValueError(f"mask_head_apply: weight {tuple(weight.shape)} is "
                         f"not [2*T*F, K] = [{2 * t * f}, {k}] for h "
                         f"{tuple(h.shape)} and stft {tuple(stft.shape)}")
    if bias is not None and bias.shape != (2 * t * f,):
        raise ValueError(f"mask_head_apply: bias {tuple(bias.shape)} is not "
                         f"[{2 * t * f}]")
    return m, k, t, f


def _device(*tensors: Optional[torch.Tensor]) -> torch.device:
    devices = {x.device for x in tensors if x is not None}
    if len(devices) != 1:
        raise ValueError(f"mask_head_apply: tensors on devices "
                         f"{sorted(map(str, devices))}; need one device")
    return devices.pop()


def mask_head_layout(h: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], stft: torch.Tensor
                     ) -> Tuple[int, int, int]:
    """The STFT's (item, plane, row) strides the kernels read, or raise on
    what they do not take: a dtype other than float32, h or weight not
    contiguous or not 16-byte aligned, K not a multiple of 4, a bias that is
    not contiguous, an STFT layout the strides cannot address, tensors not on
    one CUDA device. A pure function of the tensors' metadata: alignment is
    read from the storage offset, and the launchers assert the pointers
    (`_assert_aligned`)."""
    m, k, _, _ = _dims(h, weight, bias, stft)
    for name, x in (("h", h), ("weight", weight), ("bias", bias),
                    ("stft", stft)):
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f"mask_head kernel takes float32 tensors, got "
                            f"{name} {x.dtype}")
    for name, x in (("h", h), ("weight", weight)):
        # the allocator aligns every base, so the offset decides (a fake
        # tensor under a trace has no pointer); the ops assert the pointer
        if not x.is_contiguous() or x.storage_offset() * x.element_size() % 16:
            raise ValueError(f"mask_head kernel needs {name} contiguous and "
                             f"16-byte aligned")
    if k % 4:
        raise ValueError(f"mask_head kernel needs K a multiple of 4, got {k}")
    if bias is not None and not bias.is_contiguous():
        raise ValueError("mask_head kernel needs a contiguous bias")
    lay = cc._layout(stft)
    if lay is None or lay[0] != m:
        raise ValueError(f"mask_head kernel cannot read the stft view of "
                         f"strides {stft.stride()} for shape "
                         f"{tuple(stft.shape)}")
    device = _device(h, weight, bias, stft)
    if device.type != "cuda":
        raise ValueError("mask_head kernel needs every tensor on one CUDA "
                         "device")
    return lay[1:]


# ------------------------------------------------------------ plain versions


def mask_head_fwd_plain(h, weight, bias, stft, save_mask=False):
    """(stft (x) mask, the mask as [M, 2, T, F] if save_mask else None)."""
    mask = F.linear(h, weight, bias).reshape(stft.shape)
    return cc.mask_mul_plain(stft, mask), (mask if save_mask else None)


def mask_head_bwd_plain(g, h, weight, stft, has_bias):
    """(d_h, d_weight, d_bias or None): the conjugate mask product, then the
    products autograd takes for F.linear."""
    d_mask = cc.mask_mul_plain(g, stft, conj=True).reshape(h.shape[0], -1)
    return (d_mask.mm(weight), d_mask.t().mm(h),
            d_mask.sum(0) if has_bias else None)


def mask_head_apply_plain(h, weight, bias, stft):
    """F.linear, then the plain complex mask product, under autograd."""
    _dims(h, weight, bias, stft)
    return cc.complex_mask_apply_plain(
        stft, F.linear(h, weight, bias).reshape(stft.shape))


# ---------------------------------------------------------------- wrappers


def _assert_aligned(h, weight) -> None:
    if h.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("mask_head kernel needs h and weight 16-byte "
                         "aligned")


def mask_head_fwd(h, weight, bias, stft, save_mask=False):
    """(out [M, 2, T, F] contiguous, the mask or None)."""
    _dims(h, weight, bias, stft)
    if _device(h, weight, bias, stft).type == "cpu":
        return mask_head_fwd_plain(h, weight, bias, stft, save_mask)
    mask_head_layout(h, weight, bias, stft)
    from maavss_tpu_torch.ops import registry

    outs = registry.call["mask_head_fwd"](h, weight, bias, stft,
                                          bool(save_mask))
    return outs[0], (outs[1] if save_mask else None)


def mask_head_fwd_launch(h, weight, bias: Optional[torch.Tensor], stft,
                         save_mask: bool):
    """The registered op `mask_head_fwd` on CUDA (ops/registry.py): one
    launch -> [out] or [out, mask]."""
    from maavss_tpu_torch.ops import _build

    m, k, t, f = _dims(h, weight, bias, stft)
    bs, ps, rs = mask_head_layout(h, weight, bias, stft)
    _assert_aligned(h, weight)
    out = torch.empty((m, 2, t, f), dtype=torch.float32, device=h.device)
    mask = (torch.empty((m, 2, t, f), dtype=torch.float32, device=h.device)
            if save_mask else None)
    _build.launch("maavss_mask_head_fwd", h.device, (
        h.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), stft.data_ptr(), bs, ps,
        rs, out.data_ptr(), None if mask is None else mask.data_ptr(), m, k,
        t, f))
    mask_head_apply.launches += 1
    return [out] if mask is None else [out, mask]


def mask_head_bwd(g, h, weight, stft, has_bias):
    """(d_h, d_weight, d_bias or None) for the cotangent g [M, 2, T, F]."""
    m, k, t, f = _dims(h, weight, None, stft)
    if g.shape != stft.shape:
        raise ValueError(f"mask_head_bwd: cotangent {tuple(g.shape)} is not "
                         f"the output's {tuple(stft.shape)}")
    if _device(g, h, weight, stft).type == "cpu":
        return mask_head_bwd_plain(g, h, weight, stft, has_bias)
    from maavss_tpu_torch.ops import _build

    bs, ps, rs = mask_head_layout(h, weight, None, stft)
    _assert_aligned(h, weight)
    g = cc._fit(g)
    g_lay = cc._kernel_layout("mask_head_bwd", g, h.device)
    dev = h.device
    d_h = torch.empty((m, k), dtype=torch.float32, device=dev)
    d_w = torch.empty_like(weight)
    d_b = (torch.empty((2 * t * f,), dtype=torch.float32, device=dev)
           if has_bias else None)
    scratch = torch.empty((_build.library().maavss_mask_head_bwd_scratch(
        m, k, t, f),), dtype=torch.float32, device=dev)
    _build.launch("maavss_mask_head_bwd", dev, (
        g.data_ptr(), *g_lay[1:], stft.data_ptr(), bs, ps, rs, h.data_ptr(),
        weight.data_ptr(), d_h.data_ptr(), d_w.data_ptr(),
        None if d_b is None else d_b.data_ptr(), scratch.data_ptr(), m, k, t,
        f))
    mask_head_apply.bwd_launches += 1
    return d_h, d_w, d_b


# ------------------------------------------------------- autograd Function


class _MaskHead(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, weight, bias, stft):
        out, mask = mask_head_fwd(h, weight, bias, stft,
                                  save_mask=stft.requires_grad)
        ctx.save_for_backward(h, weight, stft, mask)
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    def backward(ctx, g):
        h, weight, stft, mask = ctx.saved_tensors
        need_h, need_w, need_b, need_s = ctx.needs_input_grad
        d_h = d_w = d_b = d_s = None
        if need_h or need_w or need_b:
            d_h, d_w, d_b = mask_head_bwd(g, h, weight, stft, ctx.has_bias)
        if need_s:
            d_s = cc.mask_mul(cc._fit(g), mask, conj=True)
        return (d_h if need_h else None, d_w if need_w else None,
                d_b if need_b else None, d_s)


def mask_head_apply(h: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    stft: torch.Tensor) -> torch.Tensor:
    """stft (x) (h @ weight.T + bias): h [M, K], weight [2P, K], bias [2P]
    or None, stft planar [M, 2, T, F] with P = T * F -> [M, 2, T, F];
    differentiable in all four."""
    _dims(h, weight, bias, stft)
    return _MaskHead.apply(h, weight, bias, stft)


mask_head_apply.launches = 0
mask_head_apply.bwd_launches = 0
