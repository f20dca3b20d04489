"""Plain PyTorch pieces of the reference: float32 throughout, no kernels.

The formulas are those of the fusion and frames models as published
(carlmoore256/MAAVSS, avse_model.py and avse_model_final.py) in the form
the port states them: flax-style BatchNorm (biased variance, eps 1e-5),
a bias-free bidirectional LSTM with gate columns (i, f, g, o), the
hamming-window STFT with the window-norm scaling,
and the cumulative phase rows of the phasegram. Parameter names follow the
port's modules, so one state dict of weights loads into both.

`Precision` is where the control departs from the reference: with
`Precision("float8")` both operands of every product and convolution are
rounded to float8 e4m3 (per-tensor scaled to the format's largest value)
before the float32 arithmetic, and the gradient flowing back through each
operand to e5m2: the step below the configurations' bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.shape_plan import ConvSpec

BN_EPS = 1e-5


def plain_numerics() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_scaled(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` with a per-tensor scale that maps its largest
    magnitude to the format's largest value, back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Float8(torch.autograd.Function):
    """An operand of a product in float8: e4m3 forward, and the gradient
    that flows back through it in e5m2, as float8 training runs them."""

    @staticmethod
    def forward(ctx, x):
        return _round_scaled(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_scaled(g, torch.float8_e5m2)


class Precision:
    """The rounding applied to the operands of every product and
    convolution: none ("float32"), or float8 ("float8": e4m3 operands,
    e5m2 gradients, each tensor scaled)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "float32" else _Float8.apply(x)


FP32 = Precision()


def linear(layer: nn.Linear, x: torch.Tensor, p: Precision) -> torch.Tensor:
    return F.linear(p.q(x), p.q(layer.weight), layer.bias)


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


class BatchNormLeaves(nn.Module):
    """One BatchNorm's leaves under the port's names: weight, bias and the
    running statistics."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))


class _TrainNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the batch and every axis past the channel
    axis 1, with the batch's biased variance max(0, E[x^2] - E[x]^2) and
    the closed-form backward dx = scale * rstd * (dy - mean(dy) - xhat *
    mean(dy * xhat)). Every reduction accumulates in float64."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        axes = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        n = x.numel() // x.shape[1]
        mean = torch.sum(x, dim=axes, dtype=torch.float64) / n
        ex2 = torch.sum(x * x, dim=axes, dtype=torch.float64) / n
        rstd = torch.rsqrt(torch.clamp(ex2 - mean * mean, min=0.0) + BN_EPS)
        mean, rstd = mean.float().view(shape), rstd.float().view(shape)
        ctx.save_for_backward(x, weight, mean, rstd)
        return (x - mean) * rstd * weight.view(shape) + bias.view(shape)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        axes = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        n = x.numel() // x.shape[1]
        xhat = (x - mean) * rstd
        dbeta = torch.sum(dy, dim=axes, dtype=torch.float64)
        dgamma = torch.sum(dy * xhat, dim=axes, dtype=torch.float64)
        k1 = (dbeta / n).float().view(shape)
        k2 = (dgamma / n).float().view(shape)
        dx = (dy - k1 - xhat * k2) * (rstd * weight.view(shape))
        return dx, dgamma.float(), dbeta.float()


class BatchNorm(nn.Module):
    """BatchNorm over channel axis 1, eps 1e-5: train mode with the batch's
    statistics (`_TrainNorm`), eval mode with the running statistics."""

    def __init__(self, features: int):
        super().__init__()
        self.BatchNorm_0 = BatchNormLeaves(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.BatchNorm_0
        if self.training:
            return _TrainNorm.apply(x, bn.weight, bn.bias)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
        return ((x - bn.running_mean.view(shape)) * mul.view(shape)
                + bn.bias.view(shape))


def activate(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return x
    if act == "tanh":
        return torch.tanh(x)
    if act == "leaky_relu":
        return leaky(x, 0.3)
    raise ValueError(f"unknown activation {act}")


class ConvStack(nn.Module):
    """A planned 2-D conv stack: Conv_i / ConvTranspose_i and
    TorchBatchNorm_i, numbered per class as the port names them. Only the
    encoders run forward; the decoders hold their leaves."""

    def __init__(self, specs: Sequence[ConvSpec], use_bias: bool = True):
        super().__init__()
        self.specs = tuple(specs)
        self.names = []
        n_conv = n_convt = n_bn = 0
        for spec in self.specs:
            if spec.transpose:
                name, n_convt = f"ConvTranspose_{n_convt}", n_convt + 1
                layer = nn.ConvTranspose2d(spec.in_ch, spec.out_ch,
                                           spec.kernel, stride=spec.stride,
                                           bias=use_bias)
            else:
                name, n_conv = f"Conv_{n_conv}", n_conv + 1
                layer = nn.Conv2d(spec.in_ch, spec.out_ch, spec.kernel,
                                  stride=spec.stride, padding=spec.padding,
                                  bias=use_bias)
            self.add_module(name, layer)
            bn = None
            if spec.norm:
                bn, n_bn = f"TorchBatchNorm_{n_bn}", n_bn + 1
                self.add_module(bn, BatchNorm(spec.out_ch))
            self.names.append((name, bn))

    def forward(self, x: torch.Tensor, p: Precision) -> torch.Tensor:
        for spec, (name, bn) in zip(self.specs, self.names):
            if spec.transpose:
                raise NotImplementedError("the reference runs encoders only")
            layer = getattr(self, name)
            x = F.conv2d(p.q(x), p.q(layer.weight), None, layer.stride,
                         layer.padding)
            if layer.bias is not None:
                # ahead of a train-mode BatchNorm a bias moves the batch
                # mean alone: its gradient is exactly nought, and enters so
                b = layer.bias
                if bn is not None and self.training:
                    b = b.detach()
                x = x + b.view(1, -1, 1, 1)
            if bn is not None:
                x = getattr(self, bn)(x)
            x = activate(x, spec.act)
        return x


class LSTMLeaves(nn.Module):
    """One direction: w_i [D, 4H] and w_h [H, 4H], gate columns i, f, g,
    o."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.w_i = nn.Parameter(torch.empty(in_features, 4 * hidden))
        self.w_h = nn.Parameter(torch.empty(hidden, 4 * hidden))


def lstm_direction(x: torch.Tensor, cell: LSTMLeaves, reverse: bool,
                   p: Precision) -> torch.Tensor:
    """[B, T, D] -> [B, T, H], h and c from zero."""
    xw = torch.matmul(p.q(x), p.q(cell.w_i))
    w_h = p.q(cell.w_h)
    b, t_len, _ = xw.shape
    h = xw.new_zeros(b, cell.hidden)
    c = torch.zeros_like(h)
    ys = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        gates = xw[:, t] + torch.matmul(p.q(h), w_h)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h
    return torch.stack(ys, dim=1)


class BiLSTM(nn.Module):
    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.fwd = LSTMLeaves(in_features, hidden)
        self.bwd = LSTMLeaves(in_features, hidden)

    def forward(self, x: torch.Tensor, p: Precision) -> torch.Tensor:
        return torch.cat([lstm_direction(x, self.fwd, False, p),
                          lstm_direction(x, self.bwd, True, p)], dim=-1)


def hamming(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float32, device=device)
    return 0.54 - 0.46 * torch.cos(2.0 * math.pi * k / n)


def stft_features(audio: torch.Tensor, fft_len: int, hop: int,
                  trim_end: bool) -> torch.Tensor:
    """audio [B, S] -> [B, 2, T, F]: centred frames (reflect padding),
    hamming window, rfft, divided by the window's norm, the last frame
    dropped and, with `trim_end`, the Nyquist bin."""
    window = hamming(fft_len, audio.device)
    pad = fft_len // 2
    x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, fft_len, hop) * window
    spec = torch.fft.rfft(frames, n=fft_len, dim=-1)
    spec = spec / torch.sqrt(torch.sum(window ** 2))
    spec = spec[:, :-1]
    if trim_end:
        spec = spec[:, :, :-1]
    return torch.stack([spec.real, spec.imag], dim=1)


def phase_rows(frames: torch.Tensor) -> torch.Tensor:
    """Attention frames [B, T, p, p] -> cumulative phase rows [B, T, p*p]:
    fft2, the spatial fftshift, the angle, flattened, cumsum / (2 pi N)."""
    fft = torch.fft.fftshift(torch.fft.fft2(frames), dim=(-2, -1))
    rows = torch.cumsum(torch.angle(fft).flatten(-2), dim=-1)
    return rows / (2.0 * math.pi * rows.shape[-1])


def phasegram(rows: torch.Tensor) -> torch.Tensor:
    """Phase rows [B, T, S] -> [B, 1, T, S]: the temporal difference with a
    zero first frame, divided by the batch's largest magnitude."""
    d = torch.diff(rows, dim=1)
    pg = torch.cat([torch.zeros_like(d[:, :1]), d], dim=1)[:, None]
    return pg / torch.clamp(pg.abs().max(), min=1e-12)


def windows(full: torch.Tensor, ns: int, hop: int, width: int
            ) -> torch.Tensor:
    """Window j = full[:, :, j*hop : j*hop + width], j < ns, stacked into
    the batch axis, example-major."""
    st = torch.stack([full[:, :, j * hop:j * hop + width] for j in range(ns)],
                     dim=1)
    return st.reshape((-1,) + st.shape[2:])


def stored_low(cfg: Dict):
    """(predicate on a leaf's name, dtype): the leaves a configuration
    stores in its compute dtype below float32. flax keeps an RNN cell's
    parameters in the compute dtype, so under bfloat16 the LSTM's w_i and
    w_h are bfloat16 leaves, their Adam moments too. (None, float32) where
    the configuration computes in float32."""
    if cfg["dtype"] == "float32":
        return None, torch.float32
    return (lambda name: name.startswith("lstm.")), getattr(torch,
                                                            cfg["dtype"])


class Adam:
    """optax.adam: b1 0.9, b2 0.999, eps 1e-8, bias corrections in float32;
    a leaf without a gradient takes g = 0. The update is computed in
    float32; a leaf the configuration stores in a lower dtype, and its
    moments, are rounded to it after each step."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 cfg: Dict):
        self.params, self.lr = params, lr
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        pred, self.low_dtype = stored_low(cfg)
        self.low = {k for k in params if pred is not None and pred(k)}

    def _store(self, k: str, t: torch.Tensor) -> None:
        if k in self.low:
            t.copy_(t.to(self.low_dtype).to(torch.float32))

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        c1 = 1.0 - 0.9 ** self.count
        c2 = 1.0 - 0.999 ** self.count
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m = self.m[k].mul_(0.9).add_(g, alpha=0.1)
            v = self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            self._store(k, m)
            self._store(k, v)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))
            self._store(k, p)


def leaf_norms(tensors: Dict[str, Optional[torch.Tensor]]
               ) -> Dict[str, float]:
    """Each leaf's L2 norm in float64 (a missing one is 0)."""
    return {k: (0.0 if t is None else float(t.detach().double().norm()))
            for k, t in tensors.items()}


class Changes:
    """Each leaf's change over spans of steps, (from, to) with step 0 the
    start: `after(n)` once the parameters have taken step n (and once with
    0 before the first); `out` holds {span: each leaf's change norm}."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 spans: Sequence[Tuple[int, int]]):
        self.params, self.spans = params, list(spans)
        self.marks: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self.out: Dict[Tuple[int, int], Dict[str, float]] = {}
        self.after(0)

    @torch.no_grad()
    def after(self, step: int) -> None:
        for span in self.spans:
            if span[0] == step:
                self.marks[span] = {k: p.detach().clone()
                                    for k, p in self.params.items()}
            if span[1] == step:
                mark = self.marks.pop(span)
                self.out[span] = leaf_norms({k: self.params[k].detach()
                                             - mark[k] for k in mark})


def geometry(cfg: Dict) -> Tuple[int, int, int, int]:
    """(hop, samples a clip, STFT columns a clip, frames a clip) of a
    configuration: the hop is (sr / fps) / hops_per_frame, floored; a clip
    is num_frames + num_seq video frames."""
    hop = int((cfg["samplerate"] / cfg["framerate"]) / cfg["hops_per_frame"])
    frames = cfg["num_frames"] + cfg["num_seq"]
    samples = hop * cfg["hops_per_frame"] * frames
    return hop, samples, cfg["hops_per_frame"] * frames, frames
