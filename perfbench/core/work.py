"""The work the configurations need, from their shapes: model FLOPs for the
`mfu.*` metrics and each hand-written kernel's bytes and operations for
its roofline. Nothing here reads what the program dispatches, so the
counts stay the same whatever implements the work.

Bytes count each input read once and each output written once; a
kernel's own scratch (saved gate activations, partial sums) is the
design's, not the function's. The bound of a kernel is the larger of
bytes over the HBM rate and operations over the rate of the units that
do them: the tensor cores' dense bf16 rate for K1's and K2's products,
the float32 rate for K5's elementwise arithmetic (NVIDIA H100 SXM data
sheet)."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from perfbench.reference.shape_plan import (
    conv_out,
    frames_visual_encoder_out_hw,
    plan_phasegram_encoder,
    plan_stft_encoder_fusion,
    plan_stft_encoder_frames,
)

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
LSTM_HIDDEN = 256
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def bound_s(n_bytes: float, flops: float, flop_rate: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / flop_rate)


def _conv2d_flops(specs, b: int, t: int, s: int) -> Tuple[int, int, int]:
    """FLOPs of a planned 2-D conv stack over [b, C, t, s]; and its output
    (t, s)."""
    flops = 0
    for sp in specs:
        t = conv_out(t, sp.kernel[0], sp.stride[0], sp.padding[0])
        s = conv_out(s, sp.kernel[1], sp.stride[1], sp.padding[1])
        flops += 2 * sp.out_ch * sp.in_ch * sp.kernel[0] * sp.kernel[1] \
            * t * s * b
    return flops, t, s


def _lstm_flops(n: int, t: int, d: int) -> int:
    """Both directions: the input projection and the recurrence."""
    h4 = 4 * LSTM_HIDDEN
    return 2 * (2 * n * t * d * h4 + 2 * n * t * LSTM_HIDDEN * h4)


def fusion_forward_flops(cfg: Dict, b: int) -> int:
    """One full-encode forward of the fusion model over b clips."""
    nf, ns, a, p = (cfg["num_frames"], cfg["num_seq"], cfg["hops_per_frame"],
                    cfg["p_size"])
    lat, fc, f = cfg["latent_chan"], cfg["fc_size"], cfg["fft_len"] // 2
    span = nf + ns - 1
    pg_enc, pg_hw = plan_phasegram_encoder((1, 1, nf, p * p), lat, fc)
    a_enc, _ = plan_stft_encoder_fusion((1, 2, a * nf, f), pg_hw, lat)
    flops = _conv2d_flops(a_enc, b, span * a, f)[0]
    flops += _conv2d_flops(pg_enc, b, span, p * p)[0]
    n, t_win = b * ns, pg_hw[0]
    d = (pg_enc[-1].out_ch + a_enc[-1].out_ch) * pg_hw[1]
    flops += _lstm_flops(n, t_win, d)
    flops += 2 * n * (t_win * 2 * LSTM_HIDDEN) * (fc // 2)
    flops += 2 * n * (fc // 2) * 512
    flops += 2 * n * 512 * (2 * a * nf * f + nf * p * p)
    return flops


def frames_forward_flops(cfg: Dict, b: int) -> int:
    """One full-encode forward of the frames model over b clips."""
    nf, ns, a = cfg["num_frames"], cfg["num_seq"], cfg["hops_per_frame"]
    size, lat, f = cfg["framesize"], cfg["latent_width"], \
        cfg["fft_len"] // 2 + 1
    t = nf + ns - 1
    flops, hw, c_in = 0, size, 1
    for out_ch, pad, pool in ((16, 2, 2), (32, 2, 2), (64, 2, 2),
                              (64, 2, 3), (lat, 3, 3)):
        hw = hw + 2 * pad - 4
        flops += 2 * out_ch * c_in * 75 * t * hw * hw * b
        hw, c_in = hw // pool, out_ch
    side = frames_visual_encoder_out_hw(size)
    specs, _ = plan_stft_encoder_frames((1, 2, a * nf, f), (nf, side * side),
                                        lat)
    n = b * ns
    flops += _conv2d_flops(specs, n, a * nf, f)[0]
    flops += _lstm_flops(n, lat, 2 * nf * side * side)
    flat = lat * 2 * LSTM_HIDDEN
    flops += 2 * n * flat * flat + 2 * n * flat * 512
    flops += 2 * n * 512 * (2 * a * f + size * size)
    return flops


def pgenc_layers(cfg: Dict) -> Iterable[Tuple[int, int, int]]:
    """(C in, C out, S in) of each phasegram-encoder layer."""
    nf, p = cfg["num_frames"], cfg["p_size"]
    specs, _ = plan_phasegram_encoder((1, 1, nf, p * p), cfg["latent_chan"],
                                      cfg["fc_size"])
    s = p * p
    for sp in specs:
        yield sp.in_ch, sp.out_ch, s
        s = conv_out(s, 9, 2, 4)


def k2_bounds(cfg: Dict, rows: int) -> Dict[str, float]:
    """K2's least seconds over the encoder's layers at R = rows: 'train'
    (the forward with the batch statistics) and 'bwd' (dx and dW2; it
    reads the forward's float32 pre-activations)."""
    io = DTYPE_BYTES[cfg["dtype"]]
    out = {"train": 0.0, "bwd": 0.0}
    for c, co, s in pgenc_layers(cfg):
        x, w2 = c * rows * s * io, co * 9 * c * io
        y = co * rows * (s // 2) * io
        yc = co * rows * (s // 2) * 4
        conv = 2 * co * 9 * c * rows * (s // 2)
        out["train"] += bound_s(x + w2 + y + 2 * 4 * co + 3 * 4 * co, conv,
                                BF16_FLOP_PER_S)
        out["bwd"] += bound_s(x + w2 + yc + y + 2 * 4 * co + x + w2
                              + 7 * 4 * co, 2 * conv, BF16_FLOP_PER_S)
    return out


def k1_bounds(io: int, b: int, t: int, d_h: int = LSTM_HIDDEN
              ) -> Dict[str, float]:
    """K1's least seconds for both directions at (B, T): the forward reads
    xw and w_h and writes ys and cs; the backward also reads ys, cs and
    dys and writes dxw and dW_h."""
    xw, wh = b * t * 4 * d_h * io, d_h * 4 * d_h * io
    ys = b * t * d_h * io
    step = 2 * b * d_h * 4 * d_h
    fwd = bound_s(2 * (xw + wh + 2 * ys), 2 * t * step, BF16_FLOP_PER_S)
    bwd = bound_s(2 * (xw + wh + 3 * ys + xw + wh), 2 * t * 2 * step,
                  BF16_FLOP_PER_S)
    return {"fwd": fwd, "bwd": bwd}


def k5_bounds(io: int, shape: Tuple[int, ...]) -> Dict[str, float]:
    """K5's four kernels on one stage's conv output y [B, C, T, H, W] with
    a 2x2 pool: statistics, apply (pooled output and argmax), the backward
    reduce and the backward dy."""
    n = 1
    for s in shape:
        n *= s
    c = shape[1]
    y, pooled = n * io, n // 4 * io
    return {
        "stats": bound_s(y + 3 * 4 * c, 3 * n, FP32_FLOP_PER_S),
        "apply": bound_s(y + 2 * pooled + 4 * 4 * c, 9 * n // 4,
                         FP32_FLOP_PER_S),
        "bwd_reduce": bound_s(2 * pooled + 12 * 4 * c, 8 * n // 4,
                              FP32_FLOP_PER_S),
        "bwd_dy": bound_s(2 * y + 2 * pooled + 8 * 4 * c, 10 * n,
                          FP32_FLOP_PER_S)}


def frames_k5_shapes(cfg: Dict, rows: int):
    """The conv outputs that take K5 in the frames trunk: the stages with
    a 2x2 pool whose input is at least 128 wide."""
    t = cfg["num_frames"] + cfg["num_seq"] - 1
    hw, shapes = cfg["framesize"], []
    for out_ch, pad, pool in ((16, 2, 2), (32, 2, 2), (64, 2, 2)):
        if pool == 2 and hw >= 128 and hw % 2 == 0:
            shapes.append((rows, out_ch, t, hw, hw))
        hw //= pool
    return shapes
