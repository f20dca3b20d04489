"""Complex-mask and polar conversions (K4): the hand-written CUDA kernels of
`csrc/spectral.cu` and their plain PyTorch versions.

Counterpart of maavss_tpu/ops/pallas_kernels.py, with the same public
functions. Each takes and returns planar spectra `[..., 2, T, F]`, channel
axis -3 holding (real, imag) or (magnitude, phase):

- `complex_mask_apply(stft_ri, mask_ri)`: the complex product, the
  `--mask_head` separation op. Its backward runs the same kernel with a
  conjugated operand: d_mask = g * conj(stft) and, only where the STFT
  input needs a gradient, d_stft = g * conj(mask).
- `magphase(stft_ri)`: (re, im) -> (sqrt(re^2 + im^2), atan2(im, re)), the
  `--use_polar` features.
- `polar_to_rect(stft_mp)`: (mag, ph) -> (mag cos ph, mag sin ph), planar
  as the JAX function returns it: the real view of `polar_to_spectrum`'s
  spectrum with its last axis moved to -3 (one launch, no copy; the planes
  then interleave).
- `polar_to_spectrum(stft_mp, pad_bins)`: the same conversion written as
  the complex64 spectrum `[..., T, F + pad_bins]` that `torch.fft.irfft`
  reads, the `pad_bins` trailing bins 0 (the Nyquist bin the features
  trim): the `--use_polar` resynthesis, one launch of the polar kernel in
  its second output form.

The backward of `magphase` and `polar_to_spectrum` is plain PyTorch, the JAX VJPs (pallas_kernels.py:126-137,169-177) with the
same 1e-24 guard at the origin: the JAX package has no backward kernel for them, and no path of
the system differentiates them. Every function raises unless axis -3 has
size 2 (the JAX functions read channels 0 and 1 of any width).

The three kernels sit behind wrappers that launch them on CUDA tensors
(fp32; the leading axes must collapse into one stride and the last axis be
contiguous; no copy is made and nothing falls back) and run the plain
versions on CPU tensors, and that count their launches in `.launches`:
`mask_mul(a, b, conj=False)`, `magphase_fwd(x)`,
`polar_spectrum_fwd(x, pad_bins)`. Each launches through its registered op
(ops/registry.py: `mask_mul`, `magphase`, `polar_spectrum`, whose bodies
are the `*_launch` functions here), so that an exported serving program
carries it. The models' `--mask_head` runs the mask
product inside the head's kernel (ops/cuda_mask_head.py) and the STFT
features run magnitude and phase inside the STFT kernel (ops/stft.py);
these functions stay the public counterparts of the JAX ones. The
`*_plain` public functions are the same functions and backward through the
plain versions on any device: the reference the kernels are held against
on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _check_planar(what: str, x: torch.Tensor) -> None:
    if x.ndim < 3 or x.shape[-3] != 2:
        raise ValueError(f"{what}: axis -3 must have size 2, got shape "
                         f"{tuple(x.shape)}")


def _planes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return x[..., 0, :, :], x[..., 1, :, :]


# ------------------------------------------------------------ plain versions


def mask_mul_plain(a: torch.Tensor, b: torch.Tensor,
                   conj: bool = False) -> torch.Tensor:
    """a * b, or a * conj(b), on planar (re, im)."""
    ar, ai = _planes(a)
    br, bi = _planes(b)
    if conj:
        bi = -bi
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-3)


def magphase_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    re, im = _planes(x)
    return torch.stack([torch.sqrt(re * re + im * im), torch.atan2(im, re)],
                       dim=-3)


def polar_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    mag, ph = _planes(x)
    return torch.stack([mag * torch.cos(ph), mag * torch.sin(ph)], dim=-3)


def polar_spectrum_fwd_plain(x: torch.Tensor,
                             pad_bins: int = 0) -> torch.Tensor:
    mag, ph = _planes(x)
    spec = torch.complex(mag * torch.cos(ph), mag * torch.sin(ph))
    return F.pad(spec, (0, pad_bins)) if pad_bins else spec


# ---------------------------------------------------------------- wrappers


def _layout(x: torch.Tensor) -> Optional[Tuple[int, int, int, int]]:
    """(items, item stride, plane stride, row stride) of a [..., 2, T, F]
    tensor whose last axis is contiguous and whose leading axes collapse
    into one stride; None if it has no such layout."""
    t, f = x.shape[-2], x.shape[-1]
    if x.is_contiguous():
        return x.numel() // (2 * t * f) if x.numel() else 0, 2 * t * f, \
            t * f, f
    if f > 1 and x.stride(-1) != 1:
        return None
    n, item_stride, span = 1, 0, None
    for size, stride in reversed(list(zip(x.shape[:-3], x.stride()[:-3]))):
        n *= size
        if size == 1:
            continue
        if span is not None and stride != span:
            return None
        if span is None:
            item_stride = stride
        span = stride * size
    return n, item_stride, x.stride(-3), x.stride(-2)


def _kernel_layout(what: str, x: torch.Tensor, device) -> Tuple[int, ...]:
    if x.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32 tensors, got {x.dtype}")
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{what} kernel needs every tensor on one CUDA "
                         f"device")
    lay = _layout(x)
    if lay is None:
        raise ValueError(f"{what} kernel needs a contiguous last axis and "
                         f"leading axes of one stride, got strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")
    return lay


def _launch(what: str, symbol: str, inputs, extra=()) -> torch.Tensor:
    """Run the launcher `symbol` on planar `inputs` into a new contiguous
    output of their shape; returns the output. Each operand's layout is
    resolved once; the output's is its shape's."""
    from maavss_tpu_torch.ops import _build

    x = inputs[0]
    args = []
    for tensor in inputs:
        args += [tensor.data_ptr(), *_kernel_layout(what, tensor,
                                                    x.device)[1:]]
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    t, f = x.shape[-2], x.shape[-1]
    args += [out.data_ptr(), 2 * t * f, t * f, f, out.numel() // (2 * t * f),
             t, f, *extra]
    _build.launch(symbol, x.device, args)
    return out


def _call(name: str, what: str, inputs, *extra) -> torch.Tensor:
    """The registered op `name` (ops/registry.py) on planar CUDA `inputs`,
    their layouts checked first."""
    from maavss_tpu_torch.ops import registry

    for tensor in inputs:
        _kernel_layout(what, tensor, inputs[0].device)
    return registry.call[name](*inputs, *extra)


def mask_mul(a: torch.Tensor, b: torch.Tensor,
             conj: bool = False) -> torch.Tensor:
    """a * b, or a * conj(b): planar [..., 2, T, F] of one shape."""
    _check_planar("mask_mul", a)
    _check_planar("mask_mul", b)
    if a.shape != b.shape:
        raise ValueError(f"mask_mul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    if not a.is_cuda:
        return mask_mul_plain(a, b, conj)
    return _call("mask_mul", "mask_mul", (a, b), bool(conj))


mask_mul.launches = 0


def mask_mul_launch(a: torch.Tensor, b: torch.Tensor,
                    conj: bool) -> torch.Tensor:
    """The registered op `mask_mul` on CUDA: one launch."""
    out = _launch("mask_mul", "maavss_mask_mul", (a, b), (int(conj),))
    mask_mul.launches += 1
    return out


def magphase_fwd(x: torch.Tensor) -> torch.Tensor:
    """(re, im) -> (mag, phase), planar [..., 2, T, F]."""
    _check_planar("magphase", x)
    if not x.is_cuda:
        return magphase_fwd_plain(x)
    return _call("magphase", "magphase", (x,))


magphase_fwd.launches = 0


def magphase_launch(x: torch.Tensor) -> torch.Tensor:
    """The registered op `magphase` on CUDA: one launch."""
    out = _launch("magphase", "maavss_magphase", (x,))
    magphase_fwd.launches += 1
    return out


def polar_spectrum_fwd(x: torch.Tensor, pad_bins: int = 0) -> torch.Tensor:
    """(mag, phase) planar [..., 2, T, F] -> complex64 [..., T, F + pad_bins]
    with the last pad_bins bins 0."""
    _check_planar("polar_to_spectrum", x)
    if pad_bins < 0:
        raise ValueError(f"polar_to_spectrum: pad_bins {pad_bins} < 0")
    if not x.is_cuda:
        return polar_spectrum_fwd_plain(x, pad_bins)
    return _call("polar_spectrum", "polar_to_spectrum", (x,), int(pad_bins))


polar_spectrum_fwd.launches = 0


def polar_spectrum_launch(x: torch.Tensor, pad_bins: int) -> torch.Tensor:
    """The registered op `polar_spectrum` on CUDA: one launch of the polar
    kernel in its spectrum form."""
    from maavss_tpu_torch.ops import _build

    n, bs, ps, rs = _kernel_layout("polar_to_spectrum", x, x.device)
    t, f = x.shape[-2], x.shape[-1]
    out = torch.empty(x.shape[:-3] + (t, f + pad_bins),
                      dtype=torch.complex64, device=x.device)
    if out.numel() == 0:
        return out
    _build.launch("maavss_polar_spectrum", x.device,
                  (x.data_ptr(), bs, ps, rs, out.data_ptr(), n, t, f,
                   f + pad_bins))
    polar_spectrum_fwd.launches += 1
    return out


# ------------------------------------------------------- autograd Functions


def _fit(g: torch.Tensor) -> torch.Tensor:
    """A cotangent in a layout the kernel reads: autograd may hand over an
    expanded one (the gradient of a .sum()); the train step's is contiguous
    and is passed as it is."""
    return g if _layout(g) is not None else g.contiguous()


class _MaskApply(torch.autograd.Function):

    @staticmethod
    def forward(ctx, stft_ri, mask_ri, plain):
        ctx.save_for_backward(stft_ri, mask_ri)
        ctx.plain = plain
        return (mask_mul_plain if plain else mask_mul)(stft_ri, mask_ri)

    @staticmethod
    def backward(ctx, g):
        stft_ri, mask_ri = ctx.saved_tensors
        mul = mask_mul_plain if ctx.plain else mask_mul
        g = _fit(g)
        d_stft = (mul(g, mask_ri, conj=True) if ctx.needs_input_grad[0]
                  else None)
        d_mask = (mul(g, stft_ri, conj=True) if ctx.needs_input_grad[1]
                  else None)
        return d_stft, d_mask, None


class _MagPhase(torch.autograd.Function):

    @staticmethod
    def forward(ctx, stft_ri):
        ctx.save_for_backward(stft_ri)
        return magphase_fwd(stft_ri)

    @staticmethod
    def backward(ctx, g):
        (stft_ri,) = ctx.saved_tensors
        re, im = _planes(stft_ri)
        gm, gp = _planes(g)
        m2 = torch.clamp(re * re + im * im, min=1e-24)
        m = torch.sqrt(m2)
        return torch.stack([gm * re / m - gp * im / m2,
                            gm * im / m + gp * re / m2], dim=-3)


class _PolarSpectrum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, stft_mp, pad_bins, plain):
        ctx.save_for_backward(stft_mp)
        fwd = polar_spectrum_fwd_plain if plain else polar_spectrum_fwd
        return fwd(stft_mp, pad_bins)

    @staticmethod
    def backward(ctx, g):
        (stft_mp,) = ctx.saved_tensors
        mag, ph = _planes(stft_mp)
        g = torch.view_as_real(g)[..., :mag.shape[-1], :]
        gre, gim = g[..., 0], g[..., 1]
        c, s = torch.cos(ph), torch.sin(ph)
        return torch.stack([gre * c + gim * s, mag * (gim * c - gre * s)],
                           dim=-3), None, None


def complex_mask_apply(stft_ri: torch.Tensor,
                       mask_ri: torch.Tensor) -> torch.Tensor:
    """Apply a complex ratio mask: [..., 2, T, F] x [..., 2, T, F] complex
    product, differentiable in both."""
    _check_planar("complex_mask_apply", stft_ri)
    return _MaskApply.apply(stft_ri, mask_ri, False)


def magphase(stft_ri: torch.Tensor) -> torch.Tensor:
    """[..., 2(re, im), T, F] -> [..., 2(mag, phase), T, F]."""
    _check_planar("magphase", stft_ri)
    return _MagPhase.apply(stft_ri)


def polar_to_rect(stft_mp: torch.Tensor) -> torch.Tensor:
    """[..., 2(mag, phase), T, F] -> [..., 2(re, im), T, F], a view of the
    spectrum `polar_to_spectrum(stft_mp, 0)` writes."""
    _check_planar("polar_to_rect", stft_mp)
    return torch.view_as_real(polar_to_spectrum(stft_mp, 0)).movedim(-1, -3)


def polar_to_spectrum(stft_mp: torch.Tensor,
                      pad_bins: int = 0) -> torch.Tensor:
    """[..., 2(mag, phase), T, F] -> complex64 [..., T, F + pad_bins], the
    trailing pad_bins bins 0: the spectrum the iSTFT reads."""
    _check_planar("polar_to_spectrum", stft_mp)
    return _PolarSpectrum.apply(stft_mp, pad_bins, False)


def complex_mask_apply_plain(stft_ri: torch.Tensor,
                             mask_ri: torch.Tensor) -> torch.Tensor:
    _check_planar("complex_mask_apply", stft_ri)
    return _MaskApply.apply(stft_ri, mask_ri, True)


def polar_to_rect_plain(stft_mp: torch.Tensor) -> torch.Tensor:
    _check_planar("polar_to_rect", stft_mp)
    return torch.view_as_real(polar_to_spectrum_plain(stft_mp, 0)).movedim(
        -1, -3)


def polar_to_spectrum_plain(stft_mp: torch.Tensor,
                            pad_bins: int = 0) -> torch.Tensor:
    _check_planar("polar_to_spectrum", stft_mp)
    return _PolarSpectrum.apply(stft_mp, pad_bins, True)
