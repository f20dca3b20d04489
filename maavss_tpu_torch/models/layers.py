"""Building blocks of the fusion and frames models (counterpart of
maavss_tpu/models/layers.py, the part those two models use).

Parameter names follow the flax tree one to one, so `convert.from_flax`
maps a flax checkpoint onto `state_dict()` leaf by leaf:

- `ConvStack` registers `Conv_i` / `ConvTranspose_i` (torch weight layouts
  [out,in,kh,kw] / [in,out,kh,kw]) and `TorchBatchNorm_i/BatchNorm_0` with
  flax's per-class counters.
- Train or eval mode comes from the module's `.training` flag (`.train()` /
  `.eval()`), PyTorch's idiom, where flax passes `train=`.
- `KernelConvStack1x9` (counterpart of `PallasConvStack1x9`) has the same
  tree as a `ConvStack` of the same specs, so `--pgenc_kernel` is a pure
  compute switch, and runs every layer through `ops/cuda_pgenc.py`.
- `LSTM` keeps flax's `w_i` [D,4H] and `w_h` [H,4H] (gate columns i,f,g,o):
  the recurrence kernel reads w_h in that layout. `GRU` keeps `w_i` [D,3H]
  and `w_h` [H,3H] (r, z, n) and `ParallelMixer` its `Dense_0`: the trees
  of --rnn_cell gru and none.
- `frames_conv3d_stage` is one stage of the frames model's visual encoder on
  the direct path: conv3d, then BatchNorm, the max pool and LeakyReLU(0.01),
  or in train mode, where `epilogue_eligible` admits the stage, the fused
  tail of `ops/cuda_epilogue.py`.

The compute dtype (`dtype`, --dtype; float32, bfloat16 or float16) follows
flax's mixed precision: conv and dense parameters stay fp32 and are cast
per call (`conv`, `dense`); BatchNorm computes in fp32 and casts its
output; the LSTM's and GRU's w_i and w_h are parameters of the compute
dtype itself, as flax creates them (maavss_tpu/models/layers.py:693-697).
In float32 every helper is the plain module call.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from maavss_tpu_torch.models.shape_plan import ConvSpec
from maavss_tpu_torch.ops.cuda_epilogue import fused_bn_pool_leaky
from maavss_tpu_torch.ops.cuda_lstm import lstm_bidir, lstm_recurrence_plain
from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer, pgenc_layer_train
from maavss_tpu_torch.parallel.collectives import (
    copy_to_model,
    data_sum,
    gather_from_model,
)
from maavss_tpu_torch.parallel.mesh import data_size, tp_dim


def leaky(x: torch.Tensor, slope: float,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LeakyReLU in `dtype` as the JAX package computes it: below float32 x
    rounds to `dtype` first (see `dense`), the slope, a weak-typed Python
    scalar in JAX, rounds to `dtype`, and the product rounds to `dtype`."""
    if dtype != torch.float32:
        x = x.to(dtype)
        slope = float(torch.tensor(slope, dtype=dtype))
    return F.leaky_relu(x, negative_slope=slope)


def full_param(module: nn.Module, leaf: str) -> torch.Tensor:
    """`module.<leaf>` whole: under --mesh_model a split leaf's shards
    joined over the model group (backward: this rank's slice of the
    gradient), else the parameter itself."""
    w = getattr(module, leaf)
    dim = tp_dim(module, leaf)
    return w if dim is None else gather_from_model(w, dim)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax `nn.Dense(dtype=)`: below float32 the input and the fp32 kernel
    are cast to `dtype`, the product rounds to `dtype`, and the bias, cast
    to `dtype`, is added in `dtype` (a second rounding), as XLA runs it
    when the sum's consumer computes in `dtype` (every dense layer's here:
    an activation, or the mask head's round trip, which XLA keeps at a
    kernel boundary).

    Under --mesh_model a layer whose weight is split (parallel/mesh.py:
    shard_model, rows [out/model, in]) is column-parallel: the product
    with this rank's rows, the model group's pieces joined on the last
    axis (`gather_from_model`), then the replicated bias; backward, the
    input gradient is summed over the model group (`copy_to_model`)."""
    if tp_dim(layer, "weight") is not None:
        x = copy_to_model(x)
        w = layer.weight if dtype == torch.float32 else layer.weight.to(dtype)
        y = gather_from_model(F.linear(x.to(dtype), w), -1)
        if layer.bias is None:
            return y
        return y + (layer.bias if dtype == torch.float32
                    else layer.bias.to(dtype))
    if dtype == torch.float32:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def excess_precision(dtype: torch.dtype) -> bool:
    """Whether XLA's CPU runtime drops a round trip fp32 -> `dtype` -> fp32
    into an upcast (excess precision, on by default), so that a chain of
    `dtype` operations feeding an fp32 consumer runs in fp32: bfloat16.
    float16 arithmetic stays float16, each operation rounded, and a value
    an fp32 consumer upcasts is rounded first (the compiled HLO's
    converts; tests/test_torch_fp16.py)."""
    return dtype == torch.bfloat16


def conv(layer: nn.Module, x: torch.Tensor,
         dtype: torch.dtype = torch.float32,
         to_bn: bool = False) -> torch.Tensor:
    """flax `nn.Conv` / `nn.ConvTranspose(dtype=)` on a torch Conv2d, Conv3d
    or ConvTranspose2d, with `dense`'s casts and roundings. `to_bn`: the
    consumer is a BatchNorm, which upcasts; in bfloat16 XLA then drops the
    round trip fp32 -> bf16 -> fp32 into an upcast (`excess_precision`):
    the bias is added in fp32 and the sum returned unrounded, and a conv
    without a bias returns its fp32 accumulation of the bf16 operands'
    products. In float16 the conv's output and the bias add round to
    float16 whatever the consumer. tests/test_torch_bf16.py and
    test_torch_fp16.py hold the port's forwards to JAX's bit for bit with
    these rules."""
    if dtype == torch.float32:
        return layer(x)
    to_bn = to_bn and excess_precision(dtype)
    x, w = x.to(dtype), layer.weight.to(dtype)
    if to_bn and layer.bias is None:
        x, w = x.float(), w.float()
    if isinstance(layer, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, w, None, layer.stride, layer.padding,
                               layer.output_padding, layer.groups,
                               layer.dilation)
    else:
        y = layer._conv_forward(x, w, None)
    if layer.bias is None:
        return y
    bias = layer.bias.to(dtype).view((-1,) + (1,) * (y.ndim - 2))
    return y.float() + bias.float() if to_bn else y + bias


def activate(x: torch.Tensor, act: Optional[str],
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The activation in `dtype`, on x rounded to `dtype`."""
    x = x.to(dtype)
    if act is None:
        return x
    if act == "tanh":
        return torch.tanh(x)
    if act == "relu":
        return F.relu(x)
    if act == "leaky_relu":
        return leaky(x, 0.3, dtype)  # reference slope (avse_model.py:71)
    if act == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(f"unknown activation {act}")


class _BatchNormEval(nn.Module):
    """Holder of one BatchNorm's affine parameters and running statistics
    (flax names scale/bias/mean/var -> weight/bias/running_mean/running_var)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))


class TorchBatchNorm(nn.Module):
    """BatchNorm over the channel axis 1, eps 1e-5, as flax's BatchNorm
    (maavss_tpu/models/layers.py:43-53) computes it.

    Eval: normalise with the running statistics. Train: normalise with the
    batch mean and the biased batch variance max(0, E[x^2] - E[x]^2) in fp32,
    then, under no_grad, running = 0.9 * running + 0.1 * batch with the
    biased variance. nn.BatchNorm2d would update with the unbiased variance
    (and momentum 0.1 in its own convention), so it is not used.

    With a `dtype` below float32 the input is upcast, statistics and the
    normalisation run in fp32 and the result is cast to `dtype` at the end,
    as flax's BatchNorm(dtype=) does (flax/linen/normalization.py:109-112,
    212-233); the parameters and running statistics stay fp32.

    Under a mesh with more than one data rank the train statistics are the
    global batch's, as GSPMD computes flax's: the per-channel sum and sum
    of squares of this rank's rows, combined over the data group in rank
    order (`data_sum`), over the global count, in the same
    max(0, E[x^2] - E[x]^2) form. Autograd through `data_sum` sums the
    two per-channel gradient terms over the group in the backward, as
    SyncBatchNorm does."""

    EPS = 1e-5
    MOMENTUM = 0.9

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.BatchNorm_0 = _BatchNormEval(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.BatchNorm_0
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            # the statistics upcast x on their own, as flax does, so below
            # float32 x's gradient is the sum of two rounded parts, one
            # through the statistics and one through the normalisation
            xs = x.to(torch.float32)
            axes = (0,) + tuple(range(2, x.ndim))
            if data_size() > 1:
                sums = data_sum(torch.stack([xs.sum(dim=axes),
                                             (xs * xs).sum(dim=axes)]))
                n = float(xs.numel() // xs.shape[1] * data_size())
                mean = sums[0] / n
                var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
            else:
                mean = xs.mean(dim=axes)
                var = torch.clamp((xs * xs).mean(dim=axes) - mean * mean,
                                  min=0.0)
            update_running_stats(bn, mean, var)
        else:
            mean, var = bn.running_mean, bn.running_var
        x = x.to(torch.float32)
        mul = bn.weight * torch.rsqrt(var + self.EPS)
        out = (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
        return out.to(self.dtype)


# > 0 while a --remat backward recomputes a forward (`running_stats_frozen`)
_STATS_FROZEN = [0]


@contextlib.contextmanager
def running_stats_frozen():
    """No running-statistics update inside: the context of a --remat
    recompute (train/steps.py:_train_apply), whose forward must not apply
    the 0.9 / 0.1 update a second time (flax's remat takes batch_stats from
    the first forward alone). A process-wide count, not a thread-local: on
    CUDA the recompute runs on autograd's device thread while the caller
    waits in backward()."""
    _STATS_FROZEN[0] += 1
    try:
        yield
    finally:
        _STATS_FROZEN[0] -= 1


@torch.no_grad()
def update_running_stats(bn: _BatchNormEval, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """flax's running update: 0.9 * running + 0.1 * batch (biased var);
    nothing under `running_stats_frozen`."""
    if _STATS_FROZEN[0]:
        return
    m = TorchBatchNorm.MOMENTUM
    bn.running_mean.copy_(m * bn.running_mean + (1.0 - m) * mean.detach())
    bn.running_var.copy_(m * bn.running_var + (1.0 - m) * var.detach())


def _conv_names(specs: Sequence[ConvSpec]):
    """flax auto-names: one counter per class (Conv, ConvTranspose,
    TorchBatchNorm)."""
    names, n_conv, n_convt, n_bn = [], 0, 0, 0
    for spec in specs:
        if spec.transpose:
            conv, n_convt = f"ConvTranspose_{n_convt}", n_convt + 1
        else:
            conv, n_conv = f"Conv_{n_conv}", n_conv + 1
        bn = None
        if spec.norm:
            bn, n_bn = f"TorchBatchNorm_{n_bn}", n_bn + 1
        names.append((conv, bn))
    return names


class ConvStack(nn.Module):
    """Sequential 2D conv / transposed-conv stack from planned specs, NCHW.

    A transposed conv runs at padding 0 (flax's VALID) and is then cropped
    to torch's ConvTranspose2d geometry: `padding` off both sides,
    `output_padding` kept on the far side (maavss_tpu/models/layers.py:81-85).
    `use_bias=False` drops every conv bias, as the frames model's stacks do.
    `dtype` is the compute dtype (module docstring).
    """

    def __init__(self, specs: Sequence[ConvSpec], use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.specs = tuple(specs)
        self.names = _conv_names(self.specs)
        self.use_bias = use_bias
        self.dtype = dtype
        for spec, (conv_name, bn) in zip(self.specs, self.names):
            cls = nn.ConvTranspose2d if spec.transpose else nn.Conv2d
            pad = (0, 0) if spec.transpose else spec.padding
            self.add_module(conv_name, cls(spec.in_ch, spec.out_ch, spec.kernel,
                                      stride=spec.stride, padding=pad,
                                      bias=use_bias))
            if bn is not None:
                self.add_module(bn, TorchBatchNorm(spec.out_ch, dtype))

    def bn_fed_biases(self):
        """Names of the conv biases that feed a BatchNorm. In train mode the
        batch mean cancels them, so their true gradient is exactly 0 (the
        fused kernel returns 0, autodiff returns float noise)."""
        if not self.use_bias:
            return []
        return [f"{conv}.bias" for conv, bn in self.names if bn is not None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for spec, (conv_name, bn) in zip(self.specs, self.names):
            x = conv(getattr(self, conv_name), x, self.dtype,
                     to_bn=bn is not None)
            if spec.transpose:
                (ph, pw), (oph, opw) = spec.padding, spec.output_padding
                h, w = x.shape[2], x.shape[3]
                x = x[:, :, ph:h - ph + oph, pw:w - pw + opw]
            if bn is not None:
                x = getattr(self, bn)(x)
            x = activate(x, spec.act, self.dtype)
        return x


class KernelConvStack1x9(ConvStack):
    """The planned phasegram-encoder stack (every layer conv(1,9) /
    stride (1,2) / pad (0,4) + BN + tanh), each layer one fused kernel call
    (ops/cuda_pgenc.py; its plain version on CPU tensors): the eval layer
    with the running statistics, or in `.train()` mode the train layer,
    differentiable, whose batch (mu, var) update the running statistics as
    maavss_tpu/models/layers.py:211-217 does.

    Channel-first [C, B*T, S] across the whole stack: one transpose on
    entry (C=1, a reshape) and one on exit. w2 [Co, 9*Cin] is derived from
    the conv weight per call with the column order k*Cin + ci of
    maavss_tpu/models/layers.py:205-207. Below float32 the input and w2 are
    cast to the compute dtype (maavss_tpu/models/layers.py:193,207), the
    kernels' IO dtype. Under a mesh with more than one data rank the train
    layer takes its split route (`pgenc_layer_train(split=True)`): the
    batch statistics are the global batch's."""

    def __init__(self, specs: Sequence[ConvSpec],
                 dtype: torch.dtype = torch.float32):
        for spec in specs:
            if not (not spec.transpose and spec.kernel == (1, 9)
                    and spec.stride == (1, 2) and spec.padding == (0, 4)
                    and spec.norm and spec.act == "tanh"):
                raise ValueError(
                    f"KernelConvStack1x9 supports only the planned "
                    f"(1,9)/s(1,2)/p(0,4)+BN+tanh layers, got {spec}")
        super().__init__(specs, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, s = x.shape
        if c != self.specs[0].in_ch:
            raise ValueError(f"input has {c} channels, specs expect "
                             f"{self.specs[0].in_ch}")
        h = x.to(self.dtype).permute(1, 0, 2, 3).reshape(c, b * t,
                                                         s).contiguous()
        for spec, (conv_name, bn_name) in zip(self.specs, self.names):
            conv = getattr(self, conv_name)
            bn = getattr(self, bn_name).BatchNorm_0
            w2 = conv.weight[:, :, 0, :].permute(0, 2, 1).reshape(
                spec.out_ch, 9 * spec.in_ch).to(h.dtype).contiguous()
            if self.training:
                h, mu, var = pgenc_layer_train(h, w2, conv.bias.float(),
                                               bn.weight.float(),
                                               bn.bias.float(),
                                               split=data_size() > 1)
                update_running_stats(bn, mu, var)
            else:
                h = pgenc_layer(h, w2, conv.bias.float(), bn.weight.float(),
                                bn.bias.float(), bn.running_mean.float(),
                                bn.running_var.float())
        co = self.specs[-1].out_ch
        return h.reshape(co, b, t, h.shape[-1]).permute(1, 0, 2, 3)


def epilogue_min_hw() -> int:
    """$MAAVSS_S2D_MIN_HW (default 128): the smallest stage input H and W
    that takes the fused epilogue. The JAX package reads the same variable
    for its space-to-depth stages, so one setting picks the same stages in
    both packages."""
    return int(os.environ.get("MAAVSS_S2D_MIN_HW", "128"))


def epilogue_eligible(shape, pad, pool: int, min_hw: int) -> bool:
    """Does a frames stage with input `shape` [B, C, T, H, W], spatial conv
    padding `pad` (lo, hi) and pool `pool` take the fused epilogue? The rule
    of maavss_tpu/models/layers.py:s2d_fold_eligible: pool 2, pad (2, 2),
    even H and W, both at least min_hw."""
    h, w = shape[3], shape[4]
    return (pool == 2 and tuple(pad) == (2, 2) and h % 2 == 0 and w % 2 == 0
            and min(h, w) >= min_hw)


def frames_conv3d_stage(x: torch.Tensor, conv3d: nn.Conv3d,
                        bn: TorchBatchNorm, pool: int, fused: bool,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One frames-encoder stage (maavss_tpu/models/layers.py:621-638, the
    direct path): conv3d (3,5,5) / stride 1 in `dtype`, then BatchNorm, a
    (1, pool, pool) max pool and LeakyReLU(0.01), [B, C, T, H, W]
    throughout. The bf16 conv3d rounds its output (cuDNN's tensor cores,
    most of the frames step) where XLA on the CPU hands the BatchNorm its
    fp32 accumulation (ROADMAP §3).

    `fused` (train mode, an eligible stage) runs the tail as the fused
    epilogue instead, on the conv output in `dtype`, and updates the running
    statistics with its batch mean and biased, unclamped variance by flax's
    rule, as maavss_tpu/models/fusion_frames.py:176-183 does; under a mesh
    with more than one data rank, the global batch's (its split route)."""
    y = conv(conv3d, x, dtype)
    if fused:
        stats = bn.BatchNorm_0
        out, mu, var = fused_bn_pool_leaky(y, stats.weight, stats.bias,
                                           split=data_size() > 1)
        update_running_stats(stats, mu, var)
        return out
    return leaky(F.max_pool3d(bn(y), (1, pool, pool)), 0.01, dtype)


class LSTM(nn.Module):
    """One direction's parameters: w_i [D,4H], w_h [H,4H] (flax layout), of
    the compute dtype, as flax creates them."""

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.w_i = nn.Parameter(torch.empty(in_features, 4 * hidden,
                                            dtype=dtype))
        self.w_h = nn.Parameter(torch.empty(hidden, 4 * hidden, dtype=dtype))


def lstm_backend(x: torch.Tensor, backend: Optional[str] = None) -> str:
    """'kernel' or 'scan' for this input: the MAAVSS_LSTM counterpart.
    'auto' (the default) is the kernel for CUDA tensors and the per-step
    loop for CPU tensors; 'kernel' on a CPU tensor raises in the wrapper."""
    backend = backend or os.environ.get("MAAVSS_LSTM", "auto")
    if backend == "auto":
        return "kernel" if x.is_cuda else "scan"
    if backend not in ("scan", "kernel"):
        raise ValueError(f"MAAVSS_LSTM={backend!r} (auto|scan|kernel)")
    return backend


class BiLSTM(nn.Module):
    """Bidirectional LSTM without biases: [B,T,D] -> [B,T,2H]
    (nn.LSTM(hidden_size=256, bias=False, bidirectional=True) semantics,
    avse_model.py:542-546 in the reference).

    The input projection x @ w_i stays one torch.matmul per direction, as the
    JAX package leaves it to XLA; the recurrence of both directions is one
    kernel launch, and its backward one more (ops/cuda_lstm.py:lstm_bidir),
    or, with backend 'scan', the plain per-step loop under autograd. Both
    carry h and c in fp32 with IO in the parameters' dtype, as the TPU
    kernel does (maavss_tpu/ops/pallas_lstm.py:84-88).

    Under --mesh_model (w_i and w_h split on their gate columns) x @ w_i
    is column-parallel and its pieces are joined over the model group, and
    the recurrence takes the whole w_h, joined each call (`full_param`),
    so K1 runs unchanged; w_h's gradient is this rank's slice."""

    def __init__(self, in_features: int, hidden: int,
                 backend: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fwd = LSTM(in_features, hidden, dtype)
        self.bwd = LSTM(in_features, hidden, dtype)
        self.backend = backend

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.fwd.w_i.dtype)
        if tp_dim(self.fwd, "w_i") is not None:
            x = copy_to_model(x)
            xw_f = gather_from_model(torch.matmul(x, self.fwd.w_i), -1)
            xw_b = gather_from_model(torch.matmul(x, self.bwd.w_i), -1)
        else:
            xw_f = torch.matmul(x, self.fwd.w_i)
            xw_b = torch.matmul(x, self.bwd.w_i)
        w_h_f, w_h_b = full_param(self.fwd, "w_h"), full_param(self.bwd, "w_h")
        if lstm_backend(x, self.backend) == "kernel":
            ys_f, ys_b = lstm_bidir(xw_f, xw_b, w_h_f, w_h_b,
                                    backend="kernel")
        else:
            ys_f = lstm_recurrence_plain(xw_f, w_h_f, reverse=False)[0]
            ys_b = lstm_recurrence_plain(xw_b, w_h_b, reverse=True)[0]
        return torch.cat([ys_f, ys_b], dim=-1)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid as XLA expands it below float32, 1 / (1 + exp(-x)) with
    every op rounded to x's dtype; torch.sigmoid in float32."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


class GRU(nn.Module):
    """One GRU direction (maavss_tpu/models/layers.py:740-795): w_i [D,3H]
    and w_h [H,3H] in flax's layout, gate columns in torch's order (r, z,
    n), parameters of the compute dtype, as flax creates them. The input
    projection x @ w_i is one matmul over all steps; the recurrence is the
    plain per-step loop of the JAX package's `lax.scan` (the JAX package
    has no GRU kernel), h carried in the compute dtype and every gate op
    rounded to it, the reset gate multiplying the recurrent candidate term
    h @ W_hn. Under --mesh_model split w_i and w_h are joined each call
    (`full_param`)."""

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.float32, reverse: bool = False):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        self.w_i = nn.Parameter(torch.empty(in_features, 3 * hidden,
                                            dtype=dtype))
        self.w_h = nn.Parameter(torch.empty(hidden, 3 * hidden, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_i, w_h = full_param(self, "w_i"), full_param(self, "w_h")
        xw = torch.matmul(x.to(w_i.dtype), w_i)
        h = xw.new_zeros(xw.shape[0], self.hidden)
        ys = [None] * xw.shape[1]
        order = range(xw.shape[1])
        for t in (reversed(order) if self.reverse else order):
            xr, xz, xn = xw[:, t].chunk(3, dim=-1)
            hr, hz, hn = torch.matmul(h, w_h).chunk(3, dim=-1)
            r = _sigmoid(xr + hr)
            z = _sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            ys[t] = h
        return torch.stack(ys, dim=1)


class BiGRU(nn.Module):
    """Bidirectional GRU without biases: [B,T,D] -> [B,T,2H], the forward
    and reverse passes concatenated (maavss_tpu/models/layers.py:819-836,
    --rnn_cell gru)."""

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fwd = GRU(in_features, hidden, dtype)
        self.bwd = GRU(in_features, hidden, dtype, reverse=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.fwd(x), self.bwd(x)], dim=-1)


class ParallelMixer(nn.Module):
    """The recurrence-free stand-in (--rnn_cell none,
    maavss_tpu/models/layers.py:839-855): one dense projection without a
    bias to the same [B,T,2H] output, no temporal mixing. `Dense_0` is
    flax's auto-name, so the converter maps `lstm/Dense_0/kernel`."""

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, 2 * hidden, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.Dense_0, x, self.dtype)


def make_birnn(cell: str, in_features: int, hidden: int,
               dtype: torch.dtype = torch.float32) -> nn.Module:
    """Bidirectional recurrence of the fusion core
    (maavss_tpu/models/layers.py:858-873): 'lstm' (reference parity, K1),
    'gru' (BiGRU) or 'none' (ParallelMixer). The model registers it as
    `lstm` whatever the cell, as flax names it, so each cell has one
    parameter tree."""
    if cell == "lstm":
        return BiLSTM(in_features, hidden, dtype=dtype)
    if cell == "gru":
        return BiGRU(in_features, hidden, dtype=dtype)
    if cell == "none":
        return ParallelMixer(in_features, hidden, dtype=dtype)
    raise ValueError(f"unknown rnn cell {cell!r} (lstm|gru|none)")
