"""The fusion model's train step and eval pass, and the frames model's
train step (counterpart of maavss_tpu/train/steps.py:make_fusion_step,
make_fusion_eval and make_frames_step, with their helpers).

`make_fusion_step(model, cfg)` returns `step(state, batch, mode,
generator=None, noise=None) -> (state, metrics)`, the whole per-step
pipeline on the model's device:

    raw audio / frames -> STFT + noise + normalisation + phasegram rows
    -> windowed forward / backward with gradient accumulation
    -> one optimizer update (in place).

Window modes, as in the JAX package:
- 'scan' (RunConfig's default): the num_seq windows run one after another;
  each window's loss / num_seq gets its own `.backward()`, the gradients
  accumulate in `.grad`, and BatchNorm's running statistics update window
  by window (train.py:136-162 in the reference). A Python loop takes the
  place of `lax.scan`.
- 'vectorized': the windows fold into the batch dimension (B * num_seq
  rows) and run as one forward / backward; BatchNorm's batch statistics
  then cover all windows at once.

`cfg.fusion_encode == 'full'` (bench.py's throughput default) supersedes
the window mode: both encoders run once over the clip's num_frames +
num_seq - 1 frames, and the num_seq latent windows run through the heads
as B * num_seq rows (see `make_fusion_step`). The visual input is raw
frames (`batch['frames']`) or, under --pgram_cache, precomputed float16
phasegram rows (`batch['pgram']` [B, T_total, p^2]), cast to fp32 on the
device.

`mode` is the modality curriculum (0 audio only, 1 visual only, 2 AV): the
inactive input is multiplied by 0, as the reference zeroes its tensors. The
metrics are those of `_watch_metrics` plus loss, a_loss and v_loss (the
mean over windows), as 0-d tensors on the device.

`noise` is the additive-noise std of the step (`_noise_resolver`): by
default cfg.noise_scalar as a Python float, or under --noise_schedule a
0-d fp32 tensor on the device (the JAX step's traced scalar,
maavss_tpu/train/steps.py:_jit_step), which the trainer sets per dispatch
from `resolve_noise_schedule`.

`k_steps > 1` (default cfg.steps_per_dispatch, --steps_per_dispatch)
returns instead `kstep(state, batches, mode, generator=None, noise=None)`:
K full optimizer steps over batches stacked [K, B, ...], metrics stacked
[K], one CUDA-graph replay a dispatch on the card (train/cuda_graph.py,
the counterpart of maavss_tpu/train/steps.py:_multistep).

`make_frames_step(model, cfg)` is the frames model's step. In window mode
each of the num_seq windows encodes its num_frames raw frames and predicts
the middle frame's hops_per_frame STFT columns (untrimmed, F = fft_len/2 +
1) and that attention frame; one `.backward()` per window, as the fusion
scan step. Under --frames_encode full the visual trunk runs once over the
clip and the heads once over the B * num_seq latent windows (--frames_halo
k real context frames on each side).

`--microbatch M` (`_microbatch_accumulate`, both families, every step
variant) runs the step's gradient pass over M sequential chunks of the
batch and divides the summed gradients by M before the one optimizer
update.

Under a mesh (parallel/, --mesh_data / --mesh_model) each rank runs the
step on its rows of the global batch (`parallel.mesh.shard_batch`, whose
rows the step's noise takes from one draw over the global batch) and the
step computes what one process would on the whole batch, as GSPMD does
for the JAX step: BatchNorm's statistics and the phasegram's max-norm are
the global batch's (models/layers.py, ops/phasegram.py), the gradients
are averaged over the data group before the update, the loss metrics are
global means, and `grad_norm` / `param_norm` count each split leaf once
(its shards' squared norms summed over the model group).

`--remat` (`_train_apply`) wraps the same forwards as the JAX step's
`_train_apply` / `_apply_remat` (each window's model call, the full-encode
encoders and heads) in `torch.utils.checkpoint`: the backward recomputes
their activations instead of holding them, with the same bits.

The pretraining regimes (`make_audio_ae_step` / `make_audio_ae_eval`, the
STFT autoencoder of train_audio_net.py and train_autoencoder.py;
`make_visual_ae_step` / `make_visual_ae_eval`, the phasegram autoencoder
of train_visual_net.py) and the middle-frame objective
(`make_fusion_middle_step`) are the JAX package's factories of the same
names (maavss_tpu/train/steps.py:717-775, 956-988, 1040-1105); the staged
AV stage (train_av_net.py) is `make_fusion_step` on a state whose
optimizer freezes both autoencoders (train/state.py:make_optimizer).
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from maavss_tpu_torch.config import RunConfig
from maavss_tpu_torch.exp.profiling import SPANS, annotate
from maavss_tpu_torch.models.shape_plan import (
    conv_out,
    plan_phasegram_encoder,
    plan_stft_encoder_fusion,
)
from maavss_tpu_torch.models.layers import running_stats_frozen
from maavss_tpu_torch.ops.audio import contrast
from maavss_tpu_torch.ops.phasegram import (
    phasegram_cumsum,
    phasegram_window,
    video_phasegram,
)
from maavss_tpu_torch.ops.stft import add_noise, stft_features
from maavss_tpu_torch.parallel.collectives import (
    allreduce_grads_,
    combine,
    mean_over_data,
)
from maavss_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    data_size,
    global_rows,
    model_size,
    model_split,
)
from maavss_tpu_torch.train.cuda_graph import make_k_step
from maavss_tpu_torch.train.setup import check_supported
from maavss_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]
# an additive-noise std: a Python float (constant, 0.0 draws nothing) or a
# 0-d fp32 tensor on the step's device (always draws)
Noise = Union[float, torch.Tensor]


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def _watch_metrics(model: torch.nn.Module) -> Metrics:
    """Global l2 norms of the gradients and parameters, and the gradient
    norm of each top-level module (maavss_tpu/train/steps.py:65-75). A
    parameter without a gradient counts as a zero gradient, as jax.grad
    gives one. The per-leaf norms come from one multi-tensor call per
    dtype (`torch._foreach_norm`), not three launches per leaf. The norms
    accumulate in fp64: on the CPU, torch's fp32 norm of a 16.7 M-element
    leaf (the frames model's fc1) is off by ~6e-4 relative. Under
    --mesh_model a split leaf's squared norm is its shards' summed over the
    model group (`_model_summed`)."""
    params, grads = [], []
    p_split, g_split = [], []  # which entries are split leaves' shards
    split = model_split(model) if model_size() > 1 else {}
    spans: Dict[str, list] = {}  # module -> [start, end) runs in `grads`
    for name, p in model.named_parameters():
        params.append(p.detach())
        p_split.append(name in split)
        runs = spans.setdefault(name.split(".", 1)[0], [])
        if p.grad is not None:
            if runs and runs[-1][1] == len(grads):
                runs[-1][1] += 1
            else:
                runs.append([len(grads), len(grads) + 1])
            grads.append(p.grad)
            g_split.append(name in split)
    p_sq = _model_summed(torch.stack(_norms(params)).square(), p_split)
    g_sq = (_model_summed(torch.stack(_norms(grads)).square(), g_split)
            if grads else p_sq[:0])
    m = {"grad_norm": torch.sqrt(g_sq.sum()),
         "param_norm": torch.sqrt(p_sq.sum())}
    for k, runs in spans.items():
        m[f"grad_norm/{k}"] = torch.sqrt(
            sum((g_sq[a:b].sum() for a, b in runs), g_sq[:0].sum()))
    return {k: v.float() for k, v in m.items()}


def _model_summed(sq: torch.Tensor, split) -> torch.Tensor:
    """Squared norms with the split leaves' entries summed over the model
    group (in rank order): each split leaf counted once, whole."""
    if not any(split):
        return sq
    parts = list(sq.unbind(0))
    idx = [i for i, s in enumerate(split) if s]
    summed = combine(torch.stack([parts[i] for i in idx]), axis=MODEL_AXIS)
    for j, i in enumerate(idx):
        parts[i] = summed[j]
    return torch.stack(parts)


def _norms(tensors):
    """fp64 L2 norms of `tensors`, in their order, one multi-tensor call
    per dtype (a list of mixed dtypes, as under --dtype bfloat16, would
    take the per-tensor path)."""
    groups: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    out = [None] * len(tensors)
    for idx in groups.values():
        norms = torch._foreach_norm([tensors[i] for i in idx], 2,
                                    dtype=torch.float64)
        for i, n in zip(idx, norms):
            out[i] = n
    return out


def remat_policy() -> str:
    """$MAAVSS_REMAT_POLICY, what a --remat forward saves for its backward
    (maavss_tpu/train/steps.py:_train_apply): 'full' (the default) saves
    the region's inputs alone and recomputes everything; 'dots' also
    keeps the outputs of the matmuls and convolutions
    (`_dot_ops`) and recomputes the rest: BatchNorm, activations,
    reshapes and the hand-written kernels, whose launches no policy sees
    (a ctypes launch is no aten op)."""
    policy = os.environ.get("MAAVSS_REMAT_POLICY", "full")
    if policy not in ("full", "dots"):
        raise ValueError(f"MAAVSS_REMAT_POLICY={policy!r} (full|dots)")
    return policy


def _dot_ops():
    """The aten ops whose outputs 'dots' saves: JAX's
    dots_with_no_batch_dims_saveable keeps dot_general and conv outputs."""
    aten = torch.ops.aten
    return {aten.mm.default, aten.addmm.default, aten.bmm.default,
            aten.baddbmm.default, aten.convolution.default,
            aten._convolution.default}


@contextlib.contextmanager
def _entered(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _remat_contexts(policy: str):
    """(forward context, recompute context) of a checkpointed region: the
    recompute updates no BatchNorm running statistics
    (`running_stats_frozen`; the first forward did), and under 'dots'
    both carry the selective-checkpoint policy."""
    if policy == "full":
        return contextlib.nullcontext(), running_stats_frozen()
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    dots = _dot_ops()

    def save_dots(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)

    fwd, rec = create_selective_checkpoint_contexts(save_dots)
    return fwd, _entered(rec, running_stats_frozen())


def _train_apply(fn: Callable, remat: bool) -> Callable:
    """`fn` (a train-mode forward: module and tensors in, tensors out), or
    under --remat `fn` checkpointed (maavss_tpu/train/steps.py:
    _train_apply, _apply_remat): torch.utils.checkpoint without
    re-entrance, with `remat_policy()`'s save policy read here, once. The
    backward recomputes the region: its kernels launch a second time, into
    tensors that their autograd Functions save anew; BatchNorm's running
    statistics are updated by the first forward alone. No RNG state is
    saved (`preserve_rng_state=False`, which keeps the step capturable in
    a CUDA graph): the step draws its noise before any forward, and no
    region draws anything, so the recompute reproduces the first
    forward's bits."""
    if not remat:
        return fn
    policy = remat_policy()

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: _remat_contexts(policy))

    return run


def norm_per_example(feats: torch.Tensor) -> torch.Tensor:
    """Per-example max-abs STFT normalization (--normalize_output_fft)."""
    m = torch.amax(torch.abs(feats) + 1e-7, dim=tuple(range(1, feats.ndim)),
                   keepdim=True)
    return feats / m


def frames_f32(frames: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] frames -> float32 [0, 1]."""
    if frames.dtype == torch.uint8:
        return frames.to(torch.float32) * (1.0 / 255.0)
    return frames


def attn_diff_frames(frames: torch.Tensor) -> torch.Tensor:
    """--attn_diff: the attention frames' difference along the frame axis 1
    with a zero first frame (maavss_tpu/train/steps.py:128-136, the
    reference's intended op), [B, T, ...] -> [B, T, ...]."""
    d = torch.diff(frames, dim=1)
    return torch.cat([torch.zeros_like(d[:, :1]), d], dim=1)


def _vis_frames(batch, cfg: RunConfig) -> torch.Tensor:
    """The batch's raw attention frames as float32 [0, 1], then their
    temporal difference under --attn_diff."""
    frames = frames_f32(batch["frames"])
    return attn_diff_frames(frames) if cfg.attn_diff else frames


def _noisy(y: torch.Tensor, noise_scalar: Noise,
           generator: Optional[torch.Generator],
           microbatch: int) -> torch.Tensor:
    """`add_noise`; under a mesh with more than one data rank the draw is
    over the global batch and this rank keeps its rows of it (`global_rows`),
    so that every row gets the noise one process would draw for it."""
    rows = global_rows(y.shape[0], microbatch)
    if rows is None:
        return add_noise(y, noise_scalar, generator)
    b, runs = rows
    noise = torch.randn((b,) + tuple(y.shape[1:]), generator=generator,
                        dtype=y.dtype, device=y.device)
    return y + torch.cat([noise[r] for r in runs]) * noise_scalar


def _prep_stft_pair(audio: torch.Tensor, cfg: RunConfig,
                    generator: Optional[torch.Generator], trim_end: bool,
                    max_norm: bool, noise_scalar: Optional[Noise] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio [B, S] -> (x_stft, y_stft) [B, 2, T, F]: the SoX contrast
    under --compress_audio (ops/audio.py), STFT ((magnitude, phase)
    features under --use_polar), optional per-example max-norm,
    then the additive-noise input x = y + noise * noise_scalar with the
    noise drawn from `generator`
    (maavss_tpu/train/steps.py:294-321). A float noise_scalar of 0 draws
    nothing: x is then y, as the JAX step's y + 0 * noise is. A 0-d tensor
    always draws, whatever its value, as the JAX step's traced scalar
    does; it gives the bits of the same value as a float."""
    if noise_scalar is None:
        noise_scalar = cfg.noise_scalar
    if cfg.compress_audio:
        audio = contrast(audio)
    y = stft_features(audio, cfg.fft_len, cfg.hop, normalized=cfg.normalize_fft,
                      trim_end=trim_end, polar=cfg.use_polar)
    if max_norm:
        y = norm_per_example(y)
    if not isinstance(noise_scalar, torch.Tensor) and noise_scalar == 0.0:
        return y, y
    return _noisy(y, noise_scalar, generator, cfg.microbatch), y


def _pflat_from_batch(batch, cfg: RunConfig) -> torch.Tensor:
    """Per-frame phasegram cumsum rows [B, T, p^2]
    (maavss_tpu/train/steps.py:145-159): precomputed --pgram_cache rows
    (`batch['pgram']`, float16, cast to fp32 where they lie) or computed
    from the raw frames (`_vis_frames`). --attn_diff with precomputed rows
    raises the JAX package's ValueError."""
    if "pgram" in batch:
        if cfg.attn_diff:
            raise ValueError(
                "--attn_diff differentiates the raw attention frames before "
                "the phasegram fft2, which precomputed --pgram_cache rows "
                "skip; drop one of the two flags")
        return batch["pgram"].to(torch.float32)
    frames = _vis_frames(batch, cfg)
    resize = None if frames.shape[-1] == cfg.p_size else (cfg.p_size,
                                                          cfg.p_size)
    return phasegram_cumsum(frames, resize=resize)


def _masks(mode: int, objective_zeros: bool
           ) -> Tuple[float, float, float, float]:
    """(audio-input, visual-input, audio-target, visual-target) multipliers
    for `mode` (maavss_tpu/train/steps.py:487-490 and :914-917; the fusion
    objective has no visual-target mask)."""
    mode = int(mode)
    return (0.0 if mode == 1 else 1.0,
            0.0 if mode == 0 else 1.0,
            0.0 if (mode == 1 and objective_zeros) else 1.0,
            0.0 if (mode == 0 and objective_zeros) else 1.0)


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _noise_resolver(cfg: RunConfig, device):
    """`noise -> Noise` for a train step of `cfg` on `device`: a given
    tensor stands; without --noise_schedule a float stands and None is
    cfg.noise_scalar; under it the value becomes a 0-d fp32 tensor on the
    device, None that of cfg.noise_scalar (made once, as the JAX step's
    cached default)."""
    cache = []

    def resolve(noise: Optional[Noise]) -> Noise:
        if isinstance(noise, torch.Tensor):
            return noise
        if not cfg.noise_schedule:
            return cfg.noise_scalar if noise is None else float(noise)
        if noise is not None:
            return torch.full((), float(noise), dtype=torch.float32,
                              device=device)
        if not cache:
            cache.append(torch.full((), float(cfg.noise_scalar),
                                    dtype=torch.float32, device=device))
        return cache[0]

    return resolve


def _dispatch(step, cfg: RunConfig, k_steps: Optional[int], device):
    """`step`, or for k_steps (default cfg.steps_per_dispatch) > 1 its
    K-step dispatch (train/cuda_graph.py)."""
    k = cfg.steps_per_dispatch if k_steps is None else int(k_steps)
    if k < 1:
        raise ValueError(f"k_steps / --steps_per_dispatch must be >= 1, got "
                         f"{k}")
    return make_k_step(step, k, device, bool(cfg.noise_schedule),
                       cfg.noise_scalar)


def _fusion_full_geometry(model, cfg: RunConfig) -> Tuple[int, int, int]:
    """Latent-window geometry for --fusion_encode full: (hop_a, hop_v, t_win)
    (a copy of maavss_tpu/train/steps.py:_fusion_full_geometry).

    Re-derives the encoder plans (models/shape_plan.py, the planner the
    model's own construction uses) to map the window hop from input time to
    latent time. The STFT encoder's time-stride product divides
    hops_per_frame at the reference geometry (both are the power-of-2
    halving chain); anything else is rejected loudly rather than silently
    mis-sliced."""
    a, nf, ns = cfg.hops_per_frame, cfg.num_frames, cfg.num_seq
    pg_enc, pg_hw = plan_phasegram_encoder(
        model.pgram_shape, model.latent_channels, model.fc_size)
    a_enc, _ = plan_stft_encoder_fusion(
        model.stft_shape, pg_hw, model.latent_channels)
    t_win = pg_hw[0]  # == num_frames (the pgram encoder never strides time)

    def sim_t(specs, t: int) -> int:
        for sp in specs:
            t = conv_out(t, sp.kernel[0], sp.stride[0], sp.padding[0])
        return t

    s_a = 1
    for sp in a_enc:
        s_a *= sp.stride[0]
    if s_a == 0 or a % s_a != 0:
        raise ValueError(
            f"--fusion_encode full: the STFT encoder's time-stride product "
            f"{s_a} does not divide hops_per_frame={a}; latent windows "
            f"cannot be sliced at this geometry — use fusion_encode=window")
    hop_a, hop_v = a // s_a, 1
    t_full_a = sim_t(a_enc, (nf + ns - 1) * a)
    t_full_v = sim_t(pg_enc, nf + ns - 1)
    if t_full_a != t_win + (ns - 1) * hop_a or t_full_v != nf + ns - 1:
        raise ValueError(
            f"--fusion_encode full: full-sequence latent lengths "
            f"(a={t_full_a}, v={t_full_v}) do not tile {ns} windows of "
            f"t={t_win} at hops ({hop_a},{hop_v}) — the conv chain's "
            f"rounding broke alignment; use fusion_encode=window")
    return hop_a, hop_v, t_win


def fullenc_loss_impl() -> str:
    """$MAAVSS_FULLENC_LOSS for the full-encode step: 'fold' stacks the
    targets' windows as the head outputs are stacked, 'slice' reduces each
    window of the head outputs against a slice of the span. 'auto' (the
    default) is 'fold', as the JAX package resolves it off the TPU."""
    impl = os.environ.get("MAAVSS_FULLENC_LOSS", "auto")
    if impl == "auto":
        impl = "fold"
    if impl not in ("fold", "slice"):
        raise ValueError(f"MAAVSS_FULLENC_LOSS={impl!r} (auto|fold|slice)")
    return impl


def _windows(full: torch.Tensor, ns: int, hop: int, width: int
             ) -> torch.Tensor:
    """The ns windows full[:, :, j*hop : j*hop + width] stacked into the
    batch dimension: [B * ns, ...], example-major."""
    st = torch.stack([full[:, :, j * hop:j * hop + width] for j in range(ns)],
                     dim=1)
    return st.reshape((-1,) + st.shape[2:])


def _loss_metrics(loss, a_loss, v_loss) -> Metrics:
    return {"loss": loss.detach(), "a_loss": a_loss.detach(),
            "v_loss": v_loss.detach()}


def _microbatch_accumulate(state: TrainState, mb: int,
                           leaves: Tuple[torch.Tensor, ...],
                           chunk_pass: Callable[..., Metrics]
                           ) -> Tuple[TrainState, Metrics]:
    """The gradient pass and the one optimizer update of a train step,
    over `mb` sequential chunks under --microbatch (counterpart of
    maavss_tpu/train/steps.py:_microbatch_accumulate): zero the gradients,
    run `chunk_pass(*chunk)`, one chunk's forward and backward(s) into
    `.grad` returning its loss metrics, over the chunks of `leaves` (views
    of B / mb rows along dim 0, in order), and divide the summed gradients
    by mb once, at the end, as JAX sums the chunks' gradients and then
    divides (scaling each chunk's loss by 1/mb instead rounds otherwise,
    at mb = 3 and on the bf16 LSTM leaves). The metrics are the mean over
    chunks, then `_watch_metrics` of the divided gradients. BatchNorm's
    running statistics carry chunk to chunk, as they carry window to
    window; its batch statistics, and the phasegram's global max-norm, are
    then per chunk: the JAX step's documented deviation. With mb == 1 the
    chunk is the batch. Under a mesh the divided gradients are averaged
    over the data group and the loss metrics are the global means
    (`_global_update`)."""
    b = leaves[0].shape[0]
    if b % mb:
        raise ValueError(f"batch size {b} not divisible by microbatch {mb}")
    _zero_grads(state)
    if mb == 1:
        metrics = chunk_pass(*leaves)
    else:
        rows = b // mb
        for i in range(mb):
            m = chunk_pass(*(t[i * rows:(i + 1) * rows] for t in leaves))
            m = {k: v / mb for k, v in m.items()}
            # JAX sums from 0, and 0 + x is exact: the same bits
            metrics = m if i == 0 else {k: metrics[k] + v
                                        for k, v in m.items()}
    return _global_update(state, metrics, mb)


def _zero_grads(state: TrainState) -> None:
    """The start of every train step: the gradients zeroed in place, in
    the optimizer's span."""
    with annotate(SPANS["update"]):
        state.zero_grad()


def _global_update(state: TrainState, metrics: Metrics, mb: int = 1
                   ) -> Tuple[TrainState, Metrics]:
    """The end of every train step, in the optimizer's span: the
    gradients summed over `mb` microbatch chunks divided by mb; under a
    mesh the gradients averaged over the data group and the loss metrics
    (per-rank means) made global means; then `_watch_metrics` and the one
    optimizer update."""
    with annotate(SPANS["update"]):
        if mb > 1:
            by_dtype: Dict[torch.dtype, list] = {}
            for p in state.model.parameters():
                if p.grad is not None:
                    by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
            for grads in by_dtype.values():
                torch._foreach_div_(grads, mb)
        allreduce_grads_(state.model.parameters())
        metrics = _mean_metrics(metrics)
        metrics.update(_watch_metrics(state.model))
        state.apply_gradients()
    return state, metrics


def _mean_metrics(metrics: Metrics) -> Metrics:
    """Per-rank means -> global means over the data group (one
    collective); without a mesh, as they are."""
    if data_size() == 1:
        return metrics
    keys = list(metrics)
    both = mean_over_data(torch.stack([metrics[k].float() for k in keys]))
    return {k: v.to(metrics[k].dtype) for k, v in zip(keys, both.unbind(0))}


def _method(name: str) -> Callable:
    """(model, *tensors) -> model.<name>(*tensors): a forward that
    `_train_apply` can checkpoint with the module as an argument."""
    return lambda model, *args: getattr(model, name)(*args)


def _fusion_prep(cfg: RunConfig, device):
    """`prep(batch, generator, noise) -> (x_full, y_full, p_flat)` of the
    fusion steps: the batch on the device, the STFT pair over the whole
    clip (trimmed, --normalize_output_fft, the step's noise) and the
    per-frame phasegram rows."""
    step_noise = _noise_resolver(cfg, device)

    def prep(batch, generator, noise):
        with annotate(SPANS["frontend"]):
            batch = _to_device(batch, device)
            x_full, y_full = _prep_stft_pair(
                batch["audio"], cfg, generator, trim_end=True,
                max_norm=cfg.normalize_output_fft,
                noise_scalar=step_noise(noise))
            return x_full, y_full, _pflat_from_batch(batch, cfg)

    return prep


def make_fusion_step(model, cfg: RunConfig, window_mode: Optional[str] = None,
                     device="cuda", k_steps: Optional[int] = None):
    """Train step for the fusion model over `batch = {'audio': [B, S_total],
    'frames': [B, T_total, p, p]}` or, under --pgram_cache, `{'audio',
    'pgram': [B, T_total, p^2] float16}` (numpy arrays or tensors; moved to
    `device`), T_total = num_frames + num_seq frames at phasegram
    resolution. `window_mode` defaults to cfg.window_mode; `k_steps`
    (default cfg.steps_per_dispatch) > 1 returns the K-step dispatch of the
    module docstring.

    With cfg.fusion_encode 'full' the step is the full-encode step
    (maavss_tpu/train/steps.py:493-618), whatever the window mode: both
    encoders run once, in train mode, over the first num_frames + num_seq -
    1 frames of the clip (the span the windows cover), the num_seq latent
    windows at hops (hop_a, hop_v) and the STFT input windows are stacked
    into B * num_seq rows, the heads run once over them, and one
    `.backward()` feeds one optimizer update. Its loss is
    `fullenc_loss_impl()`'s. It deviates from the windowed reference by
    design, as the JAX step documents:
    (a) interior windows see real temporal neighbours through the STFT
        encoder's time padding at the window seams, not each window's zero
        pad (the phasegram encoder has no temporal context either way);
    (b) BatchNorm's statistics are one full-span update a step, not one
        per window;
    (c) the phasegram's temporal diff and max-abs normalisation run once
        over the full span (a true diff at the window seams, one global
        max), not per window."""
    check_supported(cfg, train=True)
    window_mode = window_mode or cfg.window_mode
    if window_mode not in ("scan", "vectorized"):
        raise ValueError(f"unknown window_mode {window_mode}")
    if cfg.fusion_encode not in ("window", "full"):
        raise ValueError(f"unknown fusion_encode {cfg.fusion_encode!r} "
                         "(window|full)")
    a, nf, ns = cfg.hops_per_frame, cfg.num_frames, cfg.num_seq
    coeff = cfg.loss_coeff
    mb = max(1, int(cfg.microbatch))
    prep = _fusion_prep(cfg, device)
    apply = _train_apply(_method("__call__"), cfg.remat)
    encode = _train_apply(_method("encode_both"), cfg.remat)
    heads = _train_apply(_method("heads_from_latents"),
                         cfg.remat)

    def losses(state, xs, ys, y_pg, masks):
        a_mask, v_mask, ya_mask, _ = masks
        with annotate(SPANS["frontend"]):
            x_a, x_v = xs * a_mask, y_pg * v_mask
        yh_a, yh_v, _ = apply(state.model, x_a, x_v)
        del x_a, x_v  # see full_pass
        a_loss = mse(yh_a, ys * ya_mask)
        v_loss = mse(yh_v, y_pg)
        return a_loss + coeff * v_loss, a_loss, v_loss

    def scan_pass(state, masks, x_full, y_full, p_flat):
        macc = {k: torch.zeros((), device=x_full.device)
                for k in ("loss", "a_loss", "v_loss")}
        for j in range(ns):
            with annotate(SPANS["frontend"]):
                y_pg = phasegram_window(p_flat[:, j:j + nf])
            win = slice(j * a, (j + nf) * a)
            loss, a_loss, v_loss = losses(state, x_full[:, :, win],
                                          y_full[:, :, win], y_pg, masks)
            (loss / ns).backward()
            for k, v in (("loss", loss), ("a_loss", a_loss),
                         ("v_loss", v_loss)):
                macc[k] = macc[k] + v.detach() / ns
        return macc

    def vectorized_pass(state, masks, x_full, y_full, p_flat):
        # per-window phasegram finishing keeps per-window normalization
        with annotate(SPANS["frontend"]):
            pg_wins = torch.stack([phasegram_window(p_flat[:, j:j + nf])
                                   for j in range(ns)], dim=1)
            y_pg = pg_wins.reshape((-1,) + pg_wins.shape[2:])
            xs = _windows(x_full, ns, a, nf * a)
        loss, a_loss, v_loss = losses(state, xs,
                                      _windows(y_full, ns, a, nf * a), y_pg,
                                      masks)
        del xs  # see full_pass
        loss.backward()
        return _loss_metrics(loss, a_loss, v_loss)

    def full_pass(state, masks, x_full, y_full, p_flat):
        a_mask, v_mask, ya_mask, _ = masks
        # encode exactly the span the windows cover: a longer tail would
        # leak context into the last window's conv pad and shift the
        # BatchNorm statistics
        with annotate(SPANS["frontend"]):
            pg_full = phasegram_window(p_flat[:, :nf + ns - 1])
            x_a = x_full[:, :, :(nf + ns - 1) * a] * a_mask
            x_v = pg_full * v_mask
        a_lat, v_lat = encode(state.model, x_a, x_v)
        # the frontend's outputs live no longer than a call's arguments
        # would: the backward frees what it saved of them as it runs, and
        # a name held to its end would raise its peak memory
        del x_a, x_v
        with annotate(SPANS["frontend"]):
            x_wins = _windows(x_full, ns, a, nf * a) * a_mask
        yh_a, yh_v, _ = heads(
            state.model, _windows(a_lat, ns, hop_a, t_win),
            _windows(v_lat, ns, hop_v, t_win), x_wins)
        del x_wins
        if loss_impl == "slice":
            yh_aw = yh_a.reshape((-1, ns) + yh_a.shape[1:])
            yh_vw = yh_v.reshape((-1, ns) + yh_v.shape[1:])
            a_loss = sum(mse(yh_aw[:, j],
                             y_full[:, :, j * a:(j + nf) * a] * ya_mask)
                         for j in range(ns)) / ns
            v_loss = sum(mse(yh_vw[:, j], pg_full[:, :, j:j + nf])
                         for j in range(ns)) / ns
        else:
            a_loss = mse(yh_a, _windows(y_full, ns, a, nf * a) * ya_mask)
            v_loss = mse(yh_v, _windows(pg_full, ns, 1, nf))
        loss = a_loss + coeff * v_loss
        loss.backward()
        return _loss_metrics(loss, a_loss, v_loss)

    if cfg.fusion_encode == "full":
        hop_a, hop_v, t_win = _fusion_full_geometry(model, cfg)
        loss_impl = fullenc_loss_impl()
        chunk_pass = full_pass
    else:
        chunk_pass = (vectorized_pass if window_mode == "vectorized"
                      else scan_pass)

    def step(state: TrainState, batch, mode: int,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Noise] = None):
        # the STFT pair and the phasegram rows over the whole batch, then
        # the passes over its microbatches
        state.model.train()
        masks = _masks(mode, cfg.objective_zeros)
        return _microbatch_accumulate(
            state, mb, prep(batch, generator, noise),
            lambda *chunk: chunk_pass(state, masks, *chunk))

    return _dispatch(step, cfg, k_steps, device)


def make_frames_step(model, cfg: RunConfig, device="cuda",
                     k_steps: Optional[int] = None):
    """Train step for the frames model over `batch = {'audio': [B, S_total],
    'frames': [B, T_total, H, W]}` (raw attention frames at the model's
    framesize, uint8 or float in [0, 1]; numpy arrays or tensors, moved to
    `device`): `step(state, batch, mode, generator=None, noise=None) ->
    (state, metrics)`, metrics and `noise` as `make_fusion_step`'s
    (maavss_tpu/train/steps.py:782-949); `k_steps` > 1 returns the K-step
    dispatch.

    --frames_encode window: each of the num_seq windows runs the model on
    its num_frames frames, with one `.backward()` of loss / num_seq a
    window. --frames_encode full (make_full_loss,
    maavss_tpu/train/steps.py:838-904): the visual trunk runs once, in
    train mode, over the first num_frames + num_seq - 1 + 2 * halo frames
    (--frames_halo k: the synthetic and dataset clips extend by 2k
    frames, and window j starts at frame halo + j); the num_seq latent
    windows, their STFT input windows and their middle-frame targets fold
    into B * num_seq rows, example-major, the heads run once over them and
    one `.backward()` of the loss (not divided by num_seq) follows. It
    deviates from window mode by design, as the JAX step documents:
    interior windows see real neighbour frames through the temporal conv
    padding, and BatchNorm's statistics are one update in the trunk and one
    in the heads a step, not num_seq; at num_seq 1 the two modes agree.
    --microbatch runs either over the batch's chunks
    (`_microbatch_accumulate`)."""
    check_supported(cfg, train=True)
    a, nf, ns = cfg.hops_per_frame, cfg.num_frames, cfg.num_seq
    coeff = cfg.loss_coeff
    mid = (ns - 1) // 2  # train_avse_frames.py:105 in the reference
    mb = max(1, int(cfg.microbatch))
    encode = cfg.frames_encode
    if encode not in ("window", "full"):
        raise ValueError(f"unknown frames_encode {encode!r} (window|full)")
    halo = int(cfg.frames_halo)
    if halo and encode != "full":
        raise ValueError("--frames_halo needs --frames_encode full (window "
                         "mode already zero-pads each window's own edges)")
    if halo < 0:
        raise ValueError(f"--frames_halo must be >= 0, got {halo}")
    step_noise = _noise_resolver(cfg, device)
    apply = _train_apply(_method("__call__"), cfg.remat)
    encode_trunk = _train_apply(_method("encode_frames"), cfg.remat)
    heads = _train_apply(_method("forward_with_visual_latent"),
                         cfg.remat)

    def window_pass(state, masks, frames, x_full, y_full):
        a_in, v_in, ya_mask, yv_mask = masks
        macc = {k: torch.zeros((), device=x_full.device)
                for k in ("loss", "a_loss", "v_loss")}
        for j in range(ns):
            with annotate(SPANS["frontend"]):
                xs = x_full[:, :, j * a:(j + nf) * a] * a_in
                # [B,1,nf,H,W]
                x_v = frames[:, j:j + nf].transpose(1, 2) * v_in
            y_v = frames[:, j + mid]  # [B,1,H,W]
            ys = y_full[:, :, (j + mid) * a:(j + mid + 1) * a]
            yh_a, yh_v, _ = apply(state.model, xs, x_v)
            del xs, x_v  # see make_fusion_step's full_pass
            a_loss = mse(yh_a, ys * ya_mask)
            v_loss = mse(yh_v, y_v * yv_mask)
            loss = a_loss + coeff * v_loss
            (loss / ns).backward()
            for k, v in (("loss", loss), ("a_loss", a_loss),
                         ("v_loss", v_loss)):
                macc[k] = macc[k] + v.detach() / ns
        return macc

    def full_pass(state, masks, frames, x_full, y_full):
        a_in, v_in, ya_mask, yv_mask = masks
        # exactly the frames the windows and their halos cover: a longer
        # tail would leak context into the last window's conv pad and shift
        # the BatchNorm statistics
        with annotate(SPANS["frontend"]):
            x_v = frames[:, :nf + ns - 1 + 2 * halo].transpose(1, 2) * v_in
        v_lat = encode_trunk(state.model, x_v)  # [B,C,T,S]
        del x_v  # see make_fusion_step's full_pass
        first = halo + mid
        yv = frames[:, first:first + ns]  # [B,ns,1,H,W]
        with annotate(SPANS["frontend"]):
            xs = _windows(x_full[:, :, halo * a:], ns, a, nf * a) * a_in
        yh_a, yh_v, _ = heads(state.model, xs,
                              _windows(v_lat[:, :, halo:], ns, 1, nf))
        del xs
        a_loss = mse(yh_a, _windows(y_full[:, :, first * a:], ns, a, a)
                     * ya_mask)
        v_loss = mse(yh_v, yv.reshape((-1,) + yv.shape[2:]) * yv_mask)
        loss = a_loss + coeff * v_loss
        loss.backward()
        return _loss_metrics(loss, a_loss, v_loss)

    chunk_pass = full_pass if encode == "full" else window_pass

    def step(state: TrainState, batch, mode: int,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Noise] = None):
        state.model.train()
        with annotate(SPANS["frontend"]):
            batch = _to_device(batch, device)
            x_full, y_full = _prep_stft_pair(
                batch["audio"], cfg, generator, trim_end=False,
                max_norm=cfg.normalize_output_fft,
                noise_scalar=step_noise(noise))
            frames = _vis_frames(batch, cfg).unsqueeze(2)  # [B,T,1,H,W]
        masks = _masks(mode, cfg.objective_zeros)
        return _microbatch_accumulate(
            state, mb, (frames, x_full, y_full),
            lambda *chunk: chunk_pass(state, masks, *chunk))

    return _dispatch(step, cfg, k_steps, device)


def make_fusion_eval(model, cfg: RunConfig, device="cuda"):
    """Validation pass: the same windowed objective, no gradients, BatchNorm
    with the running statistics (maavss_tpu/train/steps.py:991-1037).
    `evaluate(state, batch, mode, generator=None) -> {loss, a_loss,
    v_loss}`; the model's train/eval mode is restored afterwards."""
    check_supported(cfg)
    a, nf, ns = cfg.hops_per_frame, cfg.num_frames, cfg.num_seq
    coeff = cfg.loss_coeff

    @torch.no_grad()
    def evaluate(state: TrainState, batch, mode: int,
                 generator: Optional[torch.Generator] = None) -> Metrics:
        was_training = state.model.training
        state.model.eval()
        try:
            batch = _to_device(batch, device)
            x_full, y_full = _prep_stft_pair(
                batch["audio"], cfg, generator, trim_end=True,
                max_norm=cfg.normalize_output_fft)
            a_mask, v_mask, _, _ = _masks(mode, False)
            p_flat = _pflat_from_batch(batch, cfg)
            out = {k: torch.zeros((), device=x_full.device)
                   for k in ("loss", "a_loss", "v_loss")}
            for j in range(ns):
                y_pg = phasegram_window(p_flat[:, j:j + nf])
                win = slice(j * a, (j + nf) * a)
                yh_a, yh_v, _ = state.model(x_full[:, :, win] * a_mask,
                                            y_pg * v_mask)
                a_loss = mse(yh_a, y_full[:, :, win])
                v_loss = mse(yh_v, y_pg)
                for k, v in (("loss", a_loss + coeff * v_loss),
                             ("a_loss", a_loss), ("v_loss", v_loss)):
                    out[k] = out[k] + v
            return _mean_metrics({k: v / ns for k, v in out.items()})
        finally:
            state.model.train(was_training)

    return evaluate


def make_fusion_middle_step(model, cfg: RunConfig, device="cuda",
                            k_steps: Optional[int] = None):
    """The fusion model with the middle-frame objective
    (maavss_tpu/train/steps.py:make_fusion_middle_step, experiments/train.py:
    148-181 in the reference): the scan window step of `make_fusion_step`,
    each window's loss comparing only the middle frame's hops_per_frame
    STFT columns (of the prediction and of the clean window) and its one
    phasegram row; the model predicts the whole window, as the JAX
    package's does. The inputs are masked by mode (no objective masks);
    --microbatch and --remat apply; `k_steps` > 1 returns the K-step
    dispatch."""
    check_supported(cfg, train=True)
    a, nf, ns = cfg.hops_per_frame, cfg.num_frames, cfg.num_seq
    coeff = cfg.loss_coeff
    mid = (ns - 1) // 2
    lo, hi = mid * a, (mid + 1) * a
    mb = max(1, int(cfg.microbatch))
    prep = _fusion_prep(cfg, device)
    apply = _train_apply(_method("__call__"), cfg.remat)

    def window_pass(state, masks, x_full, y_full, p_flat):
        a_mask, v_mask = masks
        macc = {k: torch.zeros((), device=x_full.device)
                for k in ("loss", "a_loss", "v_loss")}
        for j in range(ns):
            with annotate(SPANS["frontend"]):
                y_pg = phasegram_window(p_flat[:, j:j + nf])
                x_a = x_full[:, :, j * a:(j + nf) * a] * a_mask
                x_v = y_pg * v_mask
            ys_mid = y_full[:, :, j * a + lo:j * a + hi]
            yh_a, yh_v, _ = apply(state.model, x_a, x_v)
            del x_a, x_v  # see make_fusion_step's full_pass
            a_loss = mse(yh_a[:, :, lo:hi], ys_mid)
            v_loss = mse(yh_v[:, :, mid], y_pg[:, :, mid])
            loss = a_loss + coeff * v_loss
            (loss / ns).backward()
            for k, v in (("loss", loss), ("a_loss", a_loss),
                         ("v_loss", v_loss)):
                macc[k] = macc[k] + v.detach() / ns
        return macc

    def step(state: TrainState, batch, mode: int,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Noise] = None):
        state.model.train()
        masks = _masks(mode, False)[:2]
        return _microbatch_accumulate(
            state, mb, prep(batch, generator, noise),
            lambda *chunk: window_pass(state, masks, *chunk))

    return _dispatch(step, cfg, k_steps, device)


def _ae_update(state: TrainState, loss: torch.Tensor, audio: bool
               ) -> Tuple[TrainState, Metrics]:
    """One autoencoder step's backward and optimizer update: the metrics
    of the JAX AE steps (loss, and a_loss or v_loss the same, the other
    0) and `_watch_metrics`."""
    _zero_grads(state)
    loss.backward()
    loss = loss.detach()
    zero = torch.zeros((), device=loss.device)
    metrics = {"loss": loss, "a_loss": loss if audio else zero,
               "v_loss": zero if audio else loss}
    return _global_update(state, metrics)


def _audio_ae_pair(batch, cfg: RunConfig, device, generator, trim_end,
                   noise_scalar=None):
    audio = torch.as_tensor(batch["audio"]).to(device)
    return _prep_stft_pair(audio, cfg, generator, trim_end=trim_end,
                           max_norm=cfg.normalize_fft,
                           noise_scalar=noise_scalar)


def make_audio_ae_step(model, cfg: RunConfig, device="cuda",
                       trim_end: bool = True,
                       k_steps: Optional[int] = None):
    """STFT-autoencoder step over `batch = {'audio': [B, samples]}` (other
    leaves are ignored): the denoising pair (--normalize_fft max-norm, the
    step's noise, --noise_schedule as the fusion step takes it), then
    `audio_ae_forward` in train mode and the mse against the clean STFT
    (maavss_tpu/train/steps.py:make_audio_ae_step; the regimes of
    train_audio_net.py and train_autoencoder.py). `mode` is ignored;
    `k_steps` > 1 returns the K-step dispatch."""
    check_supported(cfg, train=True)
    step_noise = _noise_resolver(cfg, device)

    def step(state: TrainState, batch, mode: int,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Noise] = None):
        del mode
        state.model.train()
        with annotate(SPANS["frontend"]):
            x, y = _audio_ae_pair(batch, cfg, device, generator, trim_end,
                                  step_noise(noise))
        return _ae_update(state, mse(state.model.audio_ae_forward(x), y),
                          audio=True)

    return _dispatch(step, cfg, k_steps, device)


def make_audio_ae_eval(model, cfg: RunConfig, device="cuda",
                       trim_end: bool = True):
    """Validation of the STFT-autoencoder regimes (train_audio_net.py:
    139-162): the pair at cfg.noise_scalar, `audio_ae_forward` with the
    running statistics, the mse. `evaluate(state, batch, mode,
    generator=None) -> {loss, a_loss, v_loss}`; the model's mode is
    restored afterwards."""
    check_supported(cfg)

    @torch.no_grad()
    def evaluate(state: TrainState, batch, mode: int,
                 generator: Optional[torch.Generator] = None) -> Metrics:
        del mode
        was_training = state.model.training
        state.model.eval()
        try:
            x, y = _audio_ae_pair(batch, cfg, device, generator, trim_end)
            loss = mse(state.model.audio_ae_forward(x), y)
            return _mean_metrics({"loss": loss, "a_loss": loss,
                                  "v_loss": torch.zeros((),
                                                        device=loss.device)})
        finally:
            state.model.train(was_training)

    return evaluate


def _ae_phasegram(batch, cfg: RunConfig, device) -> torch.Tensor:
    """The clip's whole phasegram [B, 1, T, p^2] from its raw attention
    frames (`_vis_frames`), resized to p_size where the frames differ."""
    frames = _vis_frames({"frames": torch.as_tensor(batch["frames"])
                          .to(device)}, cfg)
    resize = None if frames.shape[-1] == cfg.p_size else (cfg.p_size,
                                                          cfg.p_size)
    return video_phasegram(frames, resize=resize)


def make_visual_ae_step(model, cfg: RunConfig, device="cuda",
                        k_steps: Optional[int] = None):
    """Phasegram-autoencoder step over `batch = {'frames': [B, T, p, p]}`
    (other leaves are ignored): the clip's phasegram, `visual_ae_forward`
    in train mode (the phasegram encoder's K2-train and K2-bwd on the
    card) and the mse against its input (maavss_tpu/train/steps.py:
    make_visual_ae_step; train_visual_net.py and train_3d_conv_net.py).
    It draws no noise: `mode`, `generator` and `noise` are ignored;
    `k_steps` > 1 returns the K-step dispatch."""
    check_supported(cfg, train=True)

    def step(state: TrainState, batch, mode: int,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Noise] = None):
        del mode, generator, noise
        state.model.train()
        with annotate(SPANS["frontend"]):
            y_pg = _ae_phasegram(batch, cfg, device)
        return _ae_update(state, mse(state.model.visual_ae_forward(y_pg),
                                     y_pg), audio=False)

    return _dispatch(step, cfg, k_steps, device)


def make_visual_ae_eval(model, cfg: RunConfig, device="cuda"):
    """Validation of the phasegram-autoencoder regime (train_visual_net.py:
    112-139): `visual_ae_forward` with the running statistics (K2-eval on
    the card), the mse against its input."""
    check_supported(cfg)

    @torch.no_grad()
    def evaluate(state: TrainState, batch, mode: int,
                 generator: Optional[torch.Generator] = None) -> Metrics:
        del mode, generator
        was_training = state.model.training
        state.model.eval()
        try:
            y_pg = _ae_phasegram(batch, cfg, device)
            loss = mse(state.model.visual_ae_forward(y_pg), y_pg)
            return _mean_metrics({"loss": loss, "v_loss": loss,
                                  "a_loss": torch.zeros((),
                                                        device=loss.device)})
        finally:
            state.model.train(was_training)

    return evaluate
