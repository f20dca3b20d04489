"""The serving path's hand-written kernels as registered torch ops.

Each launch that one serving batch of either family runs is an operator of
the namespace `maavss_tpu_torch`, defined here with `torch.library`:

    lstm_fwd(xws, w_hs, reverses, save_acts)    K1-fwd, ops/cuda_lstm.py
    pgenc_eval(x, w2, cbias, gamma, beta, mean, var)
                                                K2-eval, ops/cuda_pgenc.py
    stft_feat(audio, fft_len, hop, normalized, trim_end, polar)
                                                K4's STFT, ops/stft.py
    mask_mul(a, b, conj)                        K4, ops/cuda_complex.py
    magphase(x)                                 K4, ops/cuda_complex.py
    polar_spectrum(x, pad_bins)                 K4, ops/cuda_complex.py
    mask_head_fwd(h, weight, bias, stft, save_mask)
                                                K4's fused head forward,
                                                ops/cuda_mask_head.py

An op's CUDA implementation is its launcher's body: it allocates outputs
and scratch with `torch.empty`, makes the device and occupancy queries,
launches on the current stream through `_build.launch` (which raises on a
non-zero cudaError_t) and adds one to the kernel's launch counter
(ops/counters.py). A fake implementation gives the outputs' shapes, dtypes
and (contiguous) strides, so that `torch.export` traces a call on fake CUDA
tensors into one graph node, and an exported program's launches are
counted as an eager call's. No op has a CPU implementation: the wrappers
take their plain versions on CPU tensors before any op is reached, and an
exported program that holds an op raises on CPU tensors. Every output is a
new tensor; none aliases an input.

The ops are registered with the light `Library.define` / `.impl` form, not
`torch.library.custom_op`'s Python wrapper: K2-eval runs 40 times in a
window-mode serving batch, and that batch's time is the host's. The
training kernels (K1-bwd, K2-train and K2-bwd, K3, K5 and the fused head's
backward) stay direct launches: no serving export reaches them.

The wrappers call an op through `call[name]`; `impls[name]` is the same
function without the dispatcher (chip_smoke.py times the serving batch
both ways). This module imports the kernel modules and nothing of
`models`, `train` or `exp`: an exported artifact loads with it alone.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from maavss_tpu_torch.ops import cuda_complex, cuda_lstm, cuda_mask_head
from maavss_tpu_torch.ops import cuda_pgenc, stft

NAMESPACE = "maavss_tpu_torch"

SCHEMAS = {
    "lstm_fwd": "lstm_fwd(Tensor[] xws, Tensor[] w_hs, bool[] reverses, "
                "bool save_acts) -> Tensor[]",
    "pgenc_eval": "pgenc_eval(Tensor x, Tensor w2, Tensor cbias, "
                  "Tensor gamma, Tensor beta, Tensor mean, Tensor var) "
                  "-> Tensor",
    "stft_feat": "stft_feat(Tensor audio, int fft_len, int hop, "
                 "bool normalized, bool trim_end, bool polar) -> Tensor",
    "mask_mul": "mask_mul(Tensor a, Tensor b, bool conj) -> Tensor",
    "magphase": "magphase(Tensor x) -> Tensor",
    "polar_spectrum": "polar_spectrum(Tensor x, int pad_bins) -> Tensor",
    "mask_head_fwd": "mask_head_fwd(Tensor h, Tensor weight, Tensor? bias, "
                     "Tensor stft, bool save_mask) -> Tensor[]",
}

impls: Dict[str, Callable] = {
    "lstm_fwd": cuda_lstm.lstm_fwd_launch,
    "pgenc_eval": cuda_pgenc.pgenc_eval_launch,
    "stft_feat": stft.stft_feat_launch,
    "mask_mul": cuda_complex.mask_mul_launch,
    "magphase": cuda_complex.magphase_launch,
    "polar_spectrum": cuda_complex.polar_spectrum_launch,
    "mask_head_fwd": cuda_mask_head.mask_head_fwd_launch,
}


def _lstm_fwd_fake(xws: List[torch.Tensor], w_hs: List[torch.Tensor],
                   reverses: List[bool], save_acts: bool
                   ) -> List[torch.Tensor]:
    out = []
    for xw in xws:
        b, t_len, four_h = xw.shape
        out += [xw.new_empty(b, t_len, four_h // 4),
                xw.new_empty(b, t_len, four_h // 4)]
        if save_acts:
            out.append(xw.new_empty(b, t_len, four_h, dtype=torch.float32))
    return out


def _pgenc_eval_fake(x, w2, cbias, gamma, beta, mean, var) -> torch.Tensor:
    return x.new_empty(w2.shape[0], x.shape[1],
                       x.shape[2] // cuda_pgenc.STRIDE)


def _stft_feat_fake(audio, fft_len: int, hop: int, normalized: bool,
                    trim_end: bool, polar: bool) -> torch.Tensor:
    f_len = fft_len // 2 if trim_end else fft_len // 2 + 1
    return audio.new_empty(audio.shape[:-1] + (2, audio.shape[-1] // hop,
                                               f_len), dtype=torch.float32)


def _planar_fake(x, *_) -> torch.Tensor:
    return x.new_empty(x.shape, dtype=torch.float32)


def _polar_spectrum_fake(x, pad_bins: int) -> torch.Tensor:
    return x.new_empty(x.shape[:-3] + (x.shape[-2], x.shape[-1] + pad_bins),
                       dtype=torch.complex64)


def _mask_head_fwd_fake(h, weight, bias: Optional[torch.Tensor], stft_,
                        save_mask: bool) -> List[torch.Tensor]:
    shape = (h.shape[0], 2) + tuple(stft_.shape[-2:])
    n = 2 if save_mask else 1
    return [h.new_empty(shape, dtype=torch.float32) for _ in range(n)]


_FAKES = {
    "lstm_fwd": _lstm_fwd_fake, "pgenc_eval": _pgenc_eval_fake,
    "stft_feat": _stft_feat_fake, "mask_mul": _planar_fake,
    "magphase": _planar_fake, "polar_spectrum": _polar_spectrum_fake,
    "mask_head_fwd": _mask_head_fwd_fake,
}

LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, _schema in SCHEMAS.items():
    LIB.define(_schema)
    LIB.impl(_name, impls[_name], "CUDA")
    # not differentiable: the autograd Functions around the training
    # callers differentiate; an output carries no gradient, as a launch's
    LIB.impl(_name, torch.library.fallthrough_kernel, "Autograd")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _FAKES[_name],
                                lib=LIB)

ops = getattr(torch.ops, NAMESPACE)
# name -> the OpOverload the wrappers call
call: Dict[str, Callable] = {name: getattr(ops, name).default
                             for name in SCHEMAS}


def registered_op_name(target) -> Optional[str]:
    """The name of the op of this namespace that a graph node's target is,
    else None."""
    if isinstance(target, torch._ops.OpOverload) \
            and target.namespace == NAMESPACE:
        return target._opname
    return None
