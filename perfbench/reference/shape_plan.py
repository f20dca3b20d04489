"""Closed-form plans of the fusion and frames models' convolution stacks.

A frozen copy of the port's planner (the reference's layer-building loops,
avse_model.py:427-592 and avse_model_final.py:33-193, worked out
arithmetically), so that the plain reference and the work counts derive the
configurations' shapes without importing the program.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One conv (or transposed conv) layer with optional BatchNorm + activation."""

    in_ch: int
    out_ch: int
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    padding: Tuple[int, int]  # symmetric per-dim zero padding (torch convention)
    transpose: bool = False
    output_padding: Tuple[int, int] = (0, 0)
    norm: bool = True
    act: Optional[str] = "tanh"  # tanh | relu | leaky_relu | sigmoid | None


def conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def convT_out(size: int, kernel: int, stride: int, pad: int, out_pad: int) -> int:
    return (size - 1) * stride - 2 * pad + kernel + out_pad


# --------------------------------------------------------------------------
# AV_Fusion_Model planners (avse_model.py:410-627)
# --------------------------------------------------------------------------

def plan_phasegram_encoder(
    pgram_shape: Sequence[int], latent_channels: int, fc_size: int
) -> Tuple[List[ConvSpec], Tuple[int, int]]:
    """Conv2d k(1,9) s(1,2) p(0,4) stack, channels doubling to latent_channels,
    until T*S*latent_channels <= fc_size//2 (avse_model.py:427-446)."""
    t, s = pgram_shape[-2], pgram_shape[-1]
    specs: List[ConvSpec] = []
    in_ch = 1
    while s * t * latent_channels > fc_size // 2:
        out_ch = min(in_ch * 2, latent_channels)
        specs.append(ConvSpec(in_ch, out_ch, (1, 9), (1, 2), (0, 4), act="tanh"))
        s = conv_out(s, 9, 2, 4)
        in_ch = out_ch
    return specs, (t, s)


def plan_phasegram_decoder(
    latent_hw: Tuple[int, int], pgram_shape: Sequence[int], latent_channels: int
) -> Tuple[List[ConvSpec], Tuple[int, int]]:
    """ConvT2d k(1,9) s(1,2) p(0,4) op(0,1) stack doubling S back to the
    phasegram width; BN+Tanh on all but the output layer (avse_model.py:449-464)."""
    t, s = latent_hw
    target_s = pgram_shape[-1]
    specs: List[ConvSpec] = []
    in_ch = latent_channels
    while s < target_s:
        out_ch = max(in_ch // 2, 1)
        s = convT_out(s, 9, 2, 4, 1)
        last = s == target_s
        specs.append(
            ConvSpec(in_ch, out_ch, (1, 9), (1, 2), (0, 4), transpose=True,
                     output_padding=(0, 1), norm=not last, act=None if last else "tanh")
        )
        in_ch = out_ch
    return specs, (t, s)


def plan_stft_encoder_fusion(
    stft_shape: Sequence[int], target_hw: Tuple[int, int], latent_channels: int
) -> Tuple[List[ConvSpec], Tuple[int, int]]:
    """Conv2d k(5,5) p(2,2) stack, per-dim stride 2 while above the phasegram
    latent's (T,S); channels x4 capped at latent (avse_model.py:474-502)."""
    t, s = stft_shape[-2], stft_shape[-1]
    tt, ts = target_hw
    specs: List[ConvSpec] = []
    in_ch = stft_shape[1]
    while [t, s] != [tt, ts]:
        out_ch = min(in_ch * 4, latent_channels)
        stride = [1, 1]
        if t > tt:
            stride[0] = 2
            t = t // 2
        if s > ts:
            stride[1] = 2
            s = s // 2
        specs.append(ConvSpec(in_ch, out_ch, (5, 5), tuple(stride), (2, 2), act="tanh"))
        in_ch = out_ch
    return specs, (t, s)


def plan_stft_decoder_fusion(
    latent_hw: Tuple[int, int], stft_shape: Sequence[int], latent_channels: int
) -> Tuple[List[ConvSpec], Tuple[int, int]]:
    """ConvT2d k(5,5) p(2,2) stack back to (T,S); channels /4 floored at the
    stft channel count; BN+Tanh except on the output layer
    (avse_model.py:562-592)."""
    t, s = latent_hw
    tt, ts = stft_shape[-2], stft_shape[-1]
    specs: List[ConvSpec] = []
    in_ch = latent_channels
    while [t, s] != [tt, ts]:
        out_ch = max(in_ch // 4, stft_shape[1])
        stride = [1, 1]
        out_pad = [0, 0]
        if t < tt:
            stride[0] = 2
            out_pad[0] = 1
            t = t * 2
        if s < ts:
            stride[1] = 2
            out_pad[1] = 1
            s = s * 2
        last = [t, s] == [tt, ts]
        specs.append(
            ConvSpec(in_ch, out_ch, (5, 5), tuple(stride), (2, 2), transpose=True,
                     output_padding=tuple(out_pad), norm=not last,
                     act=None if last else "tanh")
        )
        in_ch = out_ch
    return specs, (t, s)


# --------------------------------------------------------------------------
# AV_Fusion_Model_Frames planners (avse_model_final.py:73-193)
# --------------------------------------------------------------------------

def plan_stft_encoder_frames(
    stft_shape: Sequence[int], target_hw: Tuple[int, int], latent_channels: int
) -> Tuple[List[ConvSpec], Tuple[int, int]]:
    """Conv2d k(3,9) stack, freq padding 3 on the first layer then 4 (so the
    odd untrimmed bin count 129 halves to 64), channels x2 capped at latent
    (avse_model_final.py:75-107). bias=False in the reference; our convs
    before BatchNorm are bias-free as well."""
    t, s = stft_shape[-2], stft_shape[-1]
    tt, ts = target_hw
    specs: List[ConvSpec] = []
    in_ch = stft_shape[1]
    first = True
    while [t, s] != [tt, ts]:
        out_ch = min(in_ch * 2, latent_channels)
        stride = [1, 1]
        if t > tt:
            stride[0] = 2
            t = t // 2
        if s > ts:
            stride[1] = 2
            s = s // 2
        pad = (1, 3 if first else 4)
        first = False
        specs.append(ConvSpec(in_ch, out_ch, (3, 9), tuple(stride), pad, act="tanh"))
        in_ch = out_ch
    return specs, (t, s)


def plan_stft_decoder_frames(
    latent_hw: Tuple[int, int], stft_shape: Sequence[int], latent_channels: int
) -> Tuple[List[ConvSpec], Tuple[int, int]]:
    """ConvT2d k(3,9) p(1,4) stack back to (T,S); the layer whose input freq
    width equals (S-1)//2 widens its kernel to (3,10) so an odd target (129)
    is hit exactly (avse_model_final.py:159-193)."""
    t, s = latent_hw
    tt, ts = stft_shape[-2], stft_shape[-1]
    specs: List[ConvSpec] = []
    in_ch = latent_channels
    kernel_w = 9
    while [t, s] != [tt, ts]:
        if len(specs) > 32 or s <= 0 or t <= 0:
            raise ValueError(
                f"stft decoder plan cannot reach {(tt, ts)} from {latent_hw} "
                f"(stuck at {(t, s)}) — frame/STFT geometry incompatible")
        out_ch = max(in_ch // 2, stft_shape[1])
        stride = [1, 1]
        out_pad = [0, 0]
        if t < tt:
            stride[0] = 2
            out_pad[0] = 1
        if s < ts:
            stride[1] = 2
            out_pad[1] = 1
        t = convT_out(t, 3, stride[0], 1, out_pad[0])
        s = convT_out(s, kernel_w, stride[1], 4, out_pad[1])
        last = [t, s] == [tt, ts]
        specs.append(
            ConvSpec(in_ch, out_ch, (3, kernel_w), tuple(stride), (1, 4),
                     transpose=True, output_padding=tuple(out_pad),
                     norm=not last, act=None if last else "tanh")
        )
        # reference kernel fix-up: if this layer's output width is (ts-1)//2,
        # the next layer widens its kernel to 10 (avse_model_final.py:184-186)
        kernel_w = 10 if s == (ts - 1) // 2 else 9
        in_ch = out_ch
    return specs, (t, s)


# --------------------------------------------------------------------------
# Frames visual encoder geometry (avse_model_final.py:33-59)
# --------------------------------------------------------------------------

def frames_visual_encoder_out_hw(framesize: int) -> int:
    """Spatial size after the fixed 5-stage conv3d+maxpool stack.

    Raises for frame sizes the stack cannot reduce (the reference would
    crash deep inside torch instead)."""
    s = framesize
    for conv_pad, conv_k, pool in ((2, 5, 2), (2, 5, 2), (2, 5, 2), (2, 5, 3), (3, 5, 3)):
        s = s + 2 * conv_pad - conv_k + 1  # stride-1 conv
        s = (s - pool) // pool + 1  # maxpool k=s=pool
        if s < 1:
            raise ValueError(
                f"framesize {framesize} too small for the 5-stage visual "
                f"encoder (spatial collapses to {s}); minimum is 24")
    return s
