#!/usr/bin/env python3
"""Drive the PyTorch port (`maavss_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each, any failure exits non-zero (nothing is caught):

1. device: needs CUDA; prints the card's name and power limit (nvidia-smi),
   the torch / CUDA versions, and turns TF32 off for matmuls and cuDNN so
   the fp32 slices are held in fp32.
2. build: compiles every kernel of the serving and train paths from `csrc/`
   (one nvcc per source, in parallel, then one link).
3. k1_lstm (K1-fwd, LSTM recurrence): the kernel against its plain version
   at (B, T) = (8, 8), (32, 8), (8, 16), (256, 8) and (1024, 8) (B x num_seq
   of the full-encode step at batch 256), H=256, fp32 and bf16,
   both directions in one cluster launch, two calls bitwise equal; cuDNN's
   bidirectional nn.LSTM timed beside it.
4. k2_pgenc (K2-eval, fused phasegram-encoder layer): the kernel against
   its plain version at each of the 10 planned layers (R=64 rows, and R=88,
   the full-encode separator's span at batch 8; fp32 and bf16); two
   calls, x and w2 at an odd offset and a CUDA graph replay give the same
   bits; cuDNN's conv alone timed beside (conv_library_ms).
5. k1_bwd (K1-bwd, LSTM BPTT): against the plain BPTT and autograd through
   the plain recurrence, at the shapes of k1_lstm, two calls bitwise equal;
   the sweep's and dW_h's device times apart; cuDNN's nn.LSTM backward
   timed beside it.
   k1_gate: both K1 kernels, correctness only, at (B, T, H) = (2, 8, 256),
   (4, 8, 256), (8, 8, 448) and (12, 8, 96), fp32 and bf16: one and two
   rows per cluster, the largest H, a slice loaded one value at a time.
6. k2_train (K2-train and K2-bwd, the train-mode layer and its backward):
   at each of the 10 layers, R 64 and 256, and R 88 and 2816 (the
   full-encode span at batch 8 and 256), fp32 and bf16, against the plain
   versions and autograd through the plain forward; dcbias exactly 0; the
   backward reads the forward's yc and leaves it as it was, two calls give
   the same bits, and a retain_graph double backward repeats; the forward
   holds k2_pgenc's bit checks at R 64 (y, mu, var, yc). At R 2816 cuDNN's
   ten convs alone (F.conv2d) and their aten.convolution_backward (dx and
   dW, the conv's part of K2-bwd) are timed beside, in fp32 and bf16.
   k2_gate: K2's forward kernels, correctness only, at C=3 -> Co=5, R in
   {1, 3, 17, 2048, 8192}, S in {2, 6, 4098}, fp32 and bf16; the 10
   layers at R 2048 and 8192 (the bit checks at 8192); a cooperative grid
   over the resident blocks is refused.
7. k3_adam (K3, fused Adam): 3 steps over the flagship's parameter leaves
   against the plain formula, at a constant rate and again under
   --lr_schedule cosine, the count and the step's [c1, c2, lr] on the card
   (the kernel reads them through a pointer; held against the host
   formula and the schedule); timed at both rates;
   torch.optim.Adam(fused=True) timed beside it.
8. slice: the full-width fusion model (seeded random weights) behind the
   HTTP SeparationServer on 127.0.0.1; 8 requests of 1..8 rows checked
   against the direct separator built from the plain versions; request
   p50/p90 and K1-fwd/K2-eval launch counts from that run; the direct
   serving call's time (kernels vs plain) and a torch.profiler breakdown.
9. golden: the small-geometry JAX reference of
   tests/fixtures/torch_port_golden.npz, run through the port's kernels.
10. train: the full-width fusion train step (batch 8, scan windows, mode
   2) with every kernel, against the plain versions from one state_dict:
   per-step losses, parameters after step 1 (as the K4 phases: a leaf past
   1e-4 passes only by its gradient and Adam's bound), exact launch counts
   per step;
   step times, clips/s, one vectorized step and a torch.profiler breakdown,
   from which train_k2_launches checks K2's device launches per step
   (conv_bn_train_kernel once per forward layer call and no kernel of the
   three-launch forward; at most 3 device launches per pgenc_bwd call).
11. train_golden: the small-geometry JAX train trajectory of
   tests/fixtures/torch_port_train_golden.npz, run through the kernels.
12. fullenc_train: --fusion_encode full --pgram_cache (bench.py's fusion
   regime) on the full-width flagship, batch 8, mode 2, 3 steps with every
   kernel against the plain versions under the train phase's gates; exact
   launch counts per step (K1-fwd, K1-bwd, K3 and the STFT once, K2-train
   and K2-bwd once a layer), step times in turns with the scan window-mode
   step, a torch.profiler breakdown; one step from the frames in place of
   their float16 rows (loss within 2^-10 relative), and the fold and slice
   losses of MAAVSS_FULLENC_LOSS (equal within 1e-6 relative), timed in
   turns.
13. fullenc_slice: the full-width model with both flags behind the HTTP
   server, 8 requests of 1..8 rows of float16 phasegram rows checked
   against the plain separator; K1-fwd once and K2-eval once a layer per
   batch.
14. fullenc_golden: the small-geometry JAX fixture of
   tests/fixtures/torch_port_fullenc_golden.npz (the full-encode separator
   on float16 rows, 3 train steps), run through the kernels.
15. bench: tools/bench_torch.py's measure function at batch 8, 2 windows of
   5 steps (its defaults otherwise: full encode, rows, bf16), once more in
   fp32 and once at MAAVSS_BENCH_MULTISTEP=5 (one CUDA-graph replay a
   window), each JSON line as a phase; its kernel counts per optimizer
   step must be the full-encode step's.
16. k5_epilogue (K5, the frames encoder's fused BN + 2x2 max pool +
   LeakyReLU: stats, apply, bwd reduce, bwd dy): each kernel against its
   plain version at the flagship's stage-0 and stage-1 shapes, with a third
   of gamma negative, again on a tensor of exact ties, and with y at an odd
   offset (stats, apply and bwd dy then take 4-byte loads); apply and bwd
   reduce also at K5_EDGES (apply's scalar path where W/2 is not a multiple
   of 4, bwd reduce's one value a load), aligned and at an odd offset; two
   bwd reduce calls give the same bits; PyTorch's unfused tail
   (F.batch_norm, F.max_pool3d, F.leaky_relu under autograd) timed beside,
   and the earlier design's device times printed beside.
17. frames_train: the full-width frames train step (framesize 256, batch 8,
   4 windows, mode 2) with every kernel, against the plain versions from
   one state_dict: per-step losses, parameters after step 1, exact launch
   counts per step; step times, clips/s and a torch.profiler breakdown.
18. frames_slice: the full-width frames model behind the HTTP server, 6
   requests of uint8 frames checked against the plain separator.
19. frames_golden: the small-geometry JAX frames fixture of
   tests/fixtures/torch_port_frames_golden.npz (separator audio and 3
   train steps with K5 at stages 0 and 1), run through the kernels.
20. k4 (K4's standalone kernels: the complex-mask product, magphase,
   polar): each kernel against its plain version at the flagships' shapes,
   on gaussian data and on strided operands holding exact zeros, atan2's
   branch cut and phases of +-pi; the mask product also in conjugate mode;
   polar_to_rect (the real view of the polar kernel's spectrum form, the
   iSTFT's input) holding the spectrum's values bit for bit; torch.polar
   timed beside the polar kernel.
21. k4_head (the --mask_head head with K4's mask product fused in, forward
   and backward): against the plain version (F.linear, then the plain mask
   product) at fusion M = 1, 8, 32, 256 (a bias, the STFT a window view)
   and frames M = 8 (no bias, F = 129); two calls and a CUDA-graph replay
   give the same bits; cuBLAS' addmm alone and addmm + the standalone mask
   product timed beside.
22. k4_stft (the one-launch STFT frontend, magphase fused in): against
   stft_features_plain at fft_len 64, 256 and 2048, trim on and off,
   normalized on and off, (re, im) and polar, on gaussian, zero and DC-only
   audio, phases compared wrapped; torch.stft timed beside. Each route's
   kernels from a CUDA graph of one call (the kernel route one node, the
   STFT kernel; the plain route cuFFT's r2c) and from the profiler.
23. mask_train: --mask_head on the fusion and frames flagships, 3 steps
   each against the plain versions (the gates of phases 10 and 17, exact
   launch counts per step: the fused head once forward and once backward a
   window, no standalone mask product, the STFT kernel once); the
   default-head fusion step timed in turns.
24. mask_slice: the fusion flagship with --mask_head behind the HTTP
   server, 8 requests checked against the plain separator.
25. polar: --use_polar, 3 train steps of each family against the plain
   versions, and each family's serving function against the plain one,
   both sides on the STFT kernel's features (held against the plain
   features with phases wrapped); no magphase launch;
   istft_features(polar=True) must run one device launch and no copy
   (torch.complex, pad, contiguous) beyond the iSTFT of its spectrum.
26. k4_golden: the small-geometry JAX fixture of
   tests/fixtures/torch_port_k4_golden.npz (the --mask_head separator and
   3 train steps, the --use_polar separator), run through the kernels.
27. k5_epilogue_bf16 (--dtype bfloat16): K5's four kernels on a bf16 y
   against their plain versions at the stage-0 and stage-1 shapes,
   gaussian and tied data, and y at an odd offset: sel and the tie
   routing exact, out and dy within one bf16 ulp; timed, bounds in bf16
   bytes; the edges and bit checks of phase 16.
28. bf16_train: the full-width fusion step (--fusion_encode full
   --pgram_cache, batch 8) and frames step in bf16, 3 steps each, and one
   --mask_head step of each (the standalone mask product in fp32 after a
   bf16 a_fc1), kernels against the plain versions under the bf16 gates
   of tests/test_torch_bf16.py (losses within 5e-4; step-1 gradients at
   most 2x, and no further from the fp32 plain step's than 1.5x, the plain
   bf16 step's distance to it; the bf16 LSTM leaves within one ulp);
   exact launch counts; each family's bf16 step timed in turns with its
   fp32 step.
29. bf16_slice: HTTP serving in bf16, the fusion flagship on float16 rows
   (full encode) and the frames flagship on uint8 frames, against the
   plain bf16 serving function, at most its distance to the plain fp32
   one and as accurate; /healthz reports the compute dtype.
30. bf16_golden: the small-geometry JAX bf16 fixture of
   tests/fixtures/torch_port_bf16_golden.npz (separator audio, 3 train
   steps) through the kernels.
31. stft_route: --fft_len 4096, which the STFT kernel refuses (its
   launcher is called and must refuse): the STFT goes to cuFFT and, under
   --use_polar, to the standalone magphase kernel; 3 fusion train steps and
   one separator batch, default head and --use_polar, against the plain
   versions under the train phase's gates, no STFT kernel launch, one
   magphase launch a polar step or batch; magphase held and timed on those
   features.
32. graphs (--steps_per_dispatch, train/cuda_graph.py): K = 3 steps a
   dispatch as one CUDA-graph replay against K eager steps of a twin from
   one state_dict and one noise seed (noise_scalar 0.1, mode 2), three
   dispatches (the first runs eagerly and captures, two replay), for the
   full-encode fusion step at batch 8 (fp32, bf16) and 256 (bf16), the
   scan window step and the frames step at batch 8 (fp32, bf16), one
   --mask_head and one --use_polar step, and --noise_schedule (a new value
   a dispatch, no re-capture): with cuDNN's deterministic algorithms bit
   for bit (metrics, parameters, BatchNorm statistics, Adam's m, v and
   count), launches K times the eager step's, one capture. cuDNN's
   default fp32 conv weight gradient differs call to call, eagerly as
   under capture (shown alone); the batch-8 and batch-256 full-encode
   cases and the fp32 frames case run again with the default algorithms
   at the train gates, the fusion ones timed eager against graphed in
   turns with peak memory and one profile each.
33. frames_full: --frames_encode full --frames_halo 1 --microbatch 2 on
   the full-width frames flagship (batch 8), 3 steps in fp32 and in bf16
   with every kernel against the plain versions from one state_dict under
   the frames_train and bf16_train gates, exact launch counts per step
   (each K5 kernel 2 x microbatch, K1-fwd and K1-bwd microbatch, K3 and the
   STFT once); the duplicated-chunk identity (two equal halves: microbatch
   2 gives microbatch 1's loss and parameters); frames_full_slice, one HTTP
   request of 8 rows to a full-encode frames daemon against the plain
   separator batch at relative L2 1e-4.
34. fusion_microbatch: --microbatch 2 on the fusion flagship, 3
   full-encode steps on float16 rows at batch 8 and one scan window step
   at batch 16 (chunks of 8 rows), kernels
   against the plain versions under the train gates, K1 and K2 microbatch
   times the step's launches; the scan step at batch 8 (chunks of 4 rows,
   where v_fc1.bias's step-1 gradient, rms 2.2e-9, fails the train gates)
   with K2 on both sides under the train gates, and the kernels against
   the plain versions with the spread of the plain step whose two
   encoders run in fp64, rounded once to fp32.
35. frames_tuned: the tuned frames configuration (batch 256, full encode,
   microbatch 2, bf16): K5's four kernels at its stage-0 and stage-1
   shapes and K1-fwd and K1-bwd at its folded rows (B 512, T 16) against
   their plain versions, timed (the kernels line's *_tuned entries); two
   K = 2 graphed dispatches against 4 eager steps bit for bit under
   cuDNN's deterministic algorithms, then timed with peak memory; K5 on an
   fp32 y of 2.95e9 values (fp32 full encode at batch 256, microbatch 1),
   past 2^31, against the plain versions in slices.
36. trainer (train/trainer.py, in a temporary directory, the stores built
   there by build_synthetic_store): trainer_fusion, the flagship (the
   default RunConfig, scan windows) on a store at p_size 64, 2 epochs x 4
   steps at batch 8, val_steps 2, 'cycle', kernels against the plain
   versions from one state, each its own Trainer: losses and val losses
   within 1e-4, the BN-fed conv biases within Adam's bound a step and
   then synchronised (K2's, gradient exactly 0, never moved), the records,
   both epoch checkpoints and every step's and eval batch's launches
   exactly; trainer_resume, under cuDNN's
   deterministic algorithms at --steps_per_dispatch 2: a SIGTERM from a
   media_fn at step 6, every restored tensor perturbed, -c --cp_load_opt
   into the same captured state: equal to the checkpoint bit for bit, the
   first replay equal to two eager steps of a fresh state loaded from it,
   and two runs of the sequence writing equal records; trainer_record,
   the bench's configuration (batch 256, full encode, rows from disk that
   tools/save_phasegrams_torch.py writes, bf16) under warmup_cosine: a
   graphed K = 4 run equal to an eager one bit for bit with one capture
   while the rate changes every step, then the trainer's clips/s over 3
   windows of 32 steps on a warmed stream (median and spread), the host's
   batch times (PhaseTimer) and the idle share of 4 dispatches profiled
   through exp/profiling.trace beside tools/bench_torch.py's measure;
   trainer_frames, the frames family at framesize 256 (fit_torch.py's
   path), batch 8, 2 steps, 'random01', kernels against plain at the
   frames gates: records, launches, and every leaf after the run (the BN
   shifts ahead of a train-mode BN within Adam's bound a step and then
   synchronised). Its launches are added to the kernels line.
37. eval_plane (the evaluation plane and the model options a checkpoint
   can carry, in a temporary working directory; nothing caught): evaluate
   (tools/evaluate_torch.py) on the fusion flagship at batch 8 over 2
   validation batches and the frames flagship (framesize 256) at batch 4
   over 1, each from a checkpoint with seeded random BatchNorm
   statistics, with every kernel and with the plain versions: every
   clip's SI-SDR within 1e-3 dB, audio_out within 1e-4 relative L2, exact
   launches, the example wavs read back; separate
   (tools/separate_torch.py) on a 10 s two-channel wav (26 tiles), audio
   only and with a 256 px frame store resized to p_size 64, the written
   wavs within 1e-4; --rnn_cell gru, --rnn_cell none, --attn_diff and
   --compress_audio on both flagships (fp32, batch 8, noise 0): 2 train
   steps (losses within 1e-4) and one separator batch against the plain
   versions, exact launches (no K1 under gru and none), the fusion step
   with the LSTM, GRU and mixer timed in turns; one bf16 gru step under
   the bf16 gates and a K = 2 graphed gru dispatch bit for bit; the
   quality curve (tools/quality_curve_torch.py) on the committed anchor's
   recipe for 100 steps at --eval_every 50, the anchor enforced on the
   card: its records, train steps/s and eval seconds. Its launches are
   added to the kernels line.
38. regimes (the staged-training regimes) on the fusion flagship
   (batch 8, scan windows, noise 0, lr 1e-3): the STFT autoencoder step,
   the phasegram autoencoder step (K2-train and K2-bwd once a layer), the
   staged AV step (FUSION_SUBNETS trainable, K3 over their fp32 leaves
   alone) and the middle-frame step, with the fusion step beside: 3 steps
   each with every kernel against the plain versions from one state_dict
   under the train gates, exact launches a step, the frozen leaves
   unchanged bit for bit on both sides, kernel and plain step times in
   turns; the two autoencoder evals (the STFT kernel; K2-eval once a
   layer) against the plain versions; AVFusionModelConv at the flagship's
   shapes, K1 against the LSTM scan (eval and train forwards, the w_h
   gradients, within 1e-4); the staged step and the phasegram autoencoder
   as K = 3 graphed dispatches bit for bit under cuDNN's deterministic
   algorithms. Its launches are added to the kernels line.
39. remat (--remat): the fusion flagship's scan step and the
   frames flagship's window step (batch 8) under --remat, every kernel
   against the plain versions (both under --remat) for 3 steps under the
   train gates, each forward kernel in a checkpointed window launching
   twice (K1-fwd, K2-train, K5's stats and apply); each against its
   --remat-less step, both with every kernel, bit for bit under cuDNN's
   deterministic algorithms (running statistics included), with both
   peak memories and step times, the fusion case under both
   MAAVSS_REMAT_POLICY values (full and dots); a graphed K = 3 --remat
   fusion dispatch under each policy bit for bit. Its launches are added
   to the kernels line.
40. legacy (main.py's raw-FFT family; no hand-written kernel): the
   DataGenerator on a synthetic store of 256^2 frames (batch 4, x_fft [4,
   2, 2112], frames [4, 1, 8, 256, 256]), AVSEModel (274 M parameters) and
   tools/train_legacy_torch.py's SGD step at lr 1e-2, 3 steps on the card
   against the CPU from one state_dict (losses within 1e-4 relative;
   Dense_2's pre-activations and the gradient at v_out within 1e-4 of
   their largest value each step, the entries whose pre-activation has
   another sign on the card counted; every leaf within 1e-4 of its
   largest value elementwise, but for Dense_2's entries of the flipped
   units, reported beside), the step's ms and a profile;
   ops/fft_legacy's process_fft and inference_to_audio on the card
   against the CPU on the generator's audio (1e-5); one
   AVModelSTFT forward, train_ae forward and backward at (4, 2, 48, 128),
   (4, 1, 6, 64, 64), card against CPU (outputs and running statistics
   within 1e-4 of their largest value, each gradient within 1e-4 of its
   layer's largest plus twice the CPU's fp32 rounding against float64).
41. features (offline feature extraction; no hand-written kernel): the
   ViT-S/8 of tests/fixtures/dino_golden.npz against the fixture;
   VideoAttention over 64 frames of 256^2, two against the CPU port, ms a
   frame beside the fp32 bound (chip_smoke._vit_flops) and a profile;
   flow_magnitude over 64 frames of a 256^2 moving blob against the CPU,
   ms and a profile; tools/save_attn_videos_torch.py end to end on a
   store of two 32-frame grayscale videos and one 64-frame RGB video,
   with the shards read back; tools/flow_torch.py's flow_frames over the
   RGB video, card against CPU, and its ms.

Every phase that drives a train step or a serving batch counts the STFT
kernel's launches exactly (one a step or a batch; none in stft_route) and
runs its plain reference on stft_features_plain (cuFFT); the profiled train
steps must run no cuFFT rfft kernel (the iSTFT's irfft serves only
separation).

The line before the last two is one JSON object with each kernel's
launches, error, times and bound; then the nvidia-smi line; the last line
is {"ok": true, "device": {...}}. A kernel's `ms` is CUDA events over
back-to-back wrapper calls (the host's launch cost included); `device_ms`
the same calls queued behind a torch.cuda._sleep so that only the card's
work is timed, and `host_ms` their enqueue time on the host clock
(`split_ms`).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_golden.npz")
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "fixtures",
                            "torch_port_train_golden.npz")
FRAMES_GOLDEN = os.path.join(ROOT, "tests", "fixtures",
                             "torch_port_frames_golden.npz")
K4_GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_k4_golden.npz")
FULLENC_GOLDEN = os.path.join(ROOT, "tests", "fixtures",
                              "torch_port_fullenc_golden.npz")
# published H100 SXM peaks (NVIDIA H100 datasheet): HBM bytes/s and
# fp32 FLOP/s outside the tensor cores (every kernel here is fp32 math)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# dense bf16 products on the tensor cores (bf16 in, fp32 sums): the rate of
# the JAX kernels' bf16 x bf16 -> fp32 dots, a second bound for the bf16
# K1 and K2 lines (the kernels here compute in fp32) and the bound of the
# bf16 K1 entries at the tuned frames shapes (`_k1_at`)
BF16_TC_FLOP_PER_S = 989e12
ADAM_EPS = 1e-8  # the optimizer's eps (train/fused_adam.py)


def phase(label: str, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


def cuda_ms(fn, reps: int = 5, iters: int = 20) -> float:
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    from CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


def split_ms(fn, reps: int = 5, iters: int = 20):
    """(device ms, host ms) per call. The `iters` calls are enqueued behind
    torch.cuda._sleep, long enough (three times the host's enqueue time of
    a calibration round, at 2 GHz) that the host runs ahead and the events
    around the calls see only the card's work; the host's enqueue time per
    call is taken with time.perf_counter. Median over `reps`."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(3 * host_s * 2e9) + 200_000
    dev, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / iters)
        stop.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(stop) / iters)
    return statistics.median(dev), statistics.median(host)


def kernel_us(fn, calls: int = 5):
    """{kernel name: mean device microseconds per launch} over `calls`
    calls of `fn`, from torch.profiler (the name without its namespace,
    template arguments and parameters)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            name = re.search(r"(\w+)(<[^(]*)?\(", e.key)
            out[name.group(1) if name else e.key[:40]] = (
                e.device_time_total / e.count)
    return out


def bound_ms(n_bytes: float, flops: float,
             flop_rate: float = FP32_FLOP_PER_S):
    """(least time in ms, what sets it): the larger of bytes over the HBM
    rate and operations over the fp32 rate (or `flop_rate`)."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / flop_rate * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_close(what, got, want, atol, rtol, scale_atol=False):
    """Raise unless |got - want| <= atol' + rtol * |want| elementwise, with
    atol' = atol * max|want| when `scale_atol`; return max abs error."""
    got, want = got.float(), want.float()
    a = atol * want.abs().max().item() if scale_atol else atol
    err = (got - want).abs()
    if not bool((err <= a + rtol * want.abs()).all()):
        raise SystemExit(f"{what}: max abs err {err.max().item()} over "
                         f"atol {a} + rtol {rtol}")
    return err.max().item()


def max_err(got, want):
    d = (got.float() - want.float()).abs()
    return d.max().item(), (d / want.float().abs().clamp(min=1e-3)).max().item()


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; the "
                         "port's kernels need an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), tf32="off (matmul and cuDNN)")
    return smi


def build_phase():
    from maavss_tpu_torch.ops import _build

    res = _build.build()
    _build.library()
    regs = [ln.strip() for ln in res.log.splitlines() if "registers" in ln]
    phase("build", seconds=round(res.seconds, 3), library=os.path.relpath(
        res.path, ROOT), ptxas=regs)


K1_SHAPES = ((8, 8), (32, 8), (8, 16), (256, 8), (1024, 8))
# (B, T): the fusion window at batch 8; its vectorized and full-encode
# windows (B x num_seq); the frames family's channel axis; bench.py's batch
# 256 a window and B x num_seq in full encode


def _k1_inputs(b, t_len, dtype, g, h=256):
    import torch

    xws = [torch.randn(b, t_len, 4 * h, device="cuda", generator=g).to(dtype)
           for _ in range(2)]
    whs = [(torch.randn(h, 4 * h, device="cuda", generator=g) / 16).to(dtype)
           for _ in range(2)]
    dys = [torch.randn(b, t_len, h, device="cuda", generator=g).to(dtype)
           for _ in range(2)]
    return xws, whs, dys


def _k1_geometry(b, h):
    """The geometry the K1 wrappers launch at batch b on this card, with
    the count of clusters it runs side by side that set it."""
    from maavss_tpu_torch.ops.cuda_lstm import (
        _clusters_at_once,
        lstm_geometry,
    )

    clusters = _clusters_at_once(0)
    return dict(lstm_geometry(b, h, clusters=clusters)._asdict(),
                clusters_at_once=clusters)


def _same_bits(what, first, second):
    """Raise unless two runs' outputs are bitwise equal."""
    import torch

    for a, b in zip(first, second):
        for x, y in zip(a, b):
            if not torch.equal(x, y):
                raise SystemExit(f"{what}: the outputs differ in their bits")


def lstm_phase():
    """K1-fwd against its plain version at K1_SHAPES (bf16 at B = 1024 too,
    the full-encode step's rows at batch 256 under --dtype bfloat16), H=256,
    fp32 and bf16, both directions in one launch: ys, cs and the saved fp32 gate
    activations (atol 1e-5; rtol 1e-5 fp32, 2^-7 bf16: one bf16 rounding),
    two calls bitwise equal. cuDNN's bidirectional nn.LSTM timed beside
    (fp32)."""
    import torch

    from maavss_tpu_torch.ops.cuda_lstm import (
        lstm_recurrence,
        lstm_recurrence_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    h = 256
    report = None
    for b, t_len in K1_SHAPES:
        for dtype, atol, rtol in ((torch.float32, 1e-5, 1e-5),
                                  (torch.bfloat16, 1e-5, 2.0 ** -7)):
            xws, whs, _ = _k1_inputs(b, t_len, dtype, g, h)
            rev = [False, True]

            def kernel():
                return lstm_recurrence(xws, whs, rev, backend="kernel")

            def plain():
                return [lstm_recurrence_plain(x, w, r)
                        for x, w, r in zip(xws, whs, rev)]

            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            _same_bits(f"K1 lstm B={b} T={t_len} {dtype}", got, again)
            err = 0.0
            for outs, refs in zip(got, want):
                for a, w in zip(outs, refs):
                    ok = torch.allclose(a.float(), w.float(), atol=atol,
                                        rtol=rtol)
                    if not ok:
                        raise SystemExit(f"K1 lstm disagrees at B={b} "
                                         f"T={t_len} {dtype}: {max_err(a, w)}")
                    err = max(err, max_err(a, w)[0])
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            # the bytes the function must move: xw and w_h read, ys and cs
            # written, per direction (acts are this design's residual, not
            # the function's); h @ w_h each step
            work = (2 * (nbytes(xws[0], whs[0])
                         + nbytes(got[0][0], got[0][1])),
                    2 * t_len * 2 * b * h * 4 * h)
            bnd = bound_ms(*work)
            fp32 = dtype == torch.float32
            tc = None if fp32 else bound_ms(*work, BF16_TC_FLOP_PER_S)
            # cuDNN's bf16 LSTM at the full-encode rows of batch 256
            lib_ms = cudnn_lstm_ms(xws, whs) if fp32 or b == 1024 else None
            dev_ms, host_ms = split_ms(kernel) if fp32 else (None, None)
            # the serving path's launch: no gate activations written
            eval_dev_ms = split_ms(lambda: lstm_recurrence(
                xws, whs, rev, backend="kernel", save_acts=False))[0] \
                if fp32 else None
            phase("k1_lstm", B=b, T=t_len, H=h, dtype=str(dtype),
                  directions=2, geometry=_k1_geometry(b, h),
                  max_abs_err=err, atol=atol, rtol=rtol, bitwise_repeat=True,
                  ms=ms, device_ms=dev_ms, host_ms=host_ms,
                  device_ms_without_acts=eval_dev_ms,
                  plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                  bound_tensor_core=tc, library_ms=lib_ms)
            if (b, t_len) == (8, 8) and fp32:
                report = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bnd,
                              library_ms=lib_ms, device_ms=dev_ms,
                              host_ms=host_ms)
    return report


def cudnn_lstm_ms(xws, whs, d_in: int = 512):
    """cuDNN's bidirectional nn.LSTM(bias=False) on the same recurrent
    weights, as a yardstick: one call computes the recurrence AND the input
    projection (x [B, T, d_in] @ w_i, d_in 512 as the flagship's fusion
    input), so it does more work than K1-fwd."""
    import torch

    lstm, x = _cudnn_lstm(xws, whs, d_in)
    with torch.no_grad():
        return cuda_ms(lambda: lstm(x))


def _cudnn_lstm(xws, whs, d_in):
    """cuDNN's nn.LSTM in the dtype of `xws`, with `whs` as weight_hh."""
    import torch

    b, t_len, four_h = xws[0].shape
    dtype = xws[0].dtype
    lstm = torch.nn.LSTM(d_in, four_h // 4, bias=False, batch_first=True,
                         bidirectional=True).cuda().to(dtype)
    with torch.no_grad():
        lstm.weight_hh_l0.copy_(whs[0].T)
        lstm.weight_hh_l0_reverse.copy_(whs[1].T)
    return lstm, torch.randn(b, t_len, d_in, device="cuda", dtype=dtype)


def cudnn_lstm_bwd_ms(xws, whs, dys, d_in: int = 512):
    """cuDNN's backward of the same bidirectional nn.LSTM, as a yardstick
    for K1-bwd: torch.autograd.grad of its output against (dys_f | dys_b)
    for x and both weight_hh, over one retained forward graph. It does more
    work than K1-bwd: dx through w_i, and cuDNN's weight-gradient pass
    covers w_i too."""
    import torch

    lstm, x = _cudnn_lstm(xws, whs, d_in)
    x.requires_grad_(True)
    out, _ = lstm(x)
    dy = torch.cat([d.to(out.dtype) for d in dys], dim=-1)
    leaves = (x, lstm.weight_hh_l0, lstm.weight_hh_l0_reverse)
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, dy,
                                               retain_graph=True))


def _k2_contract(where, call, args):
    """K2's forward contract on the card: two calls of `call(*args)` give
    the same bits; x and w2 (args 0 and 1) one element into their storage,
    which takes the forward's 4-byte copies, give the aligned call's bits;
    one call captured in a torch.cuda.CUDAGraph and replayed three times
    gives them too. Returns the first call's outputs."""
    import torch

    def run(*a):
        out = call(*a)
        return out if isinstance(out, tuple) else (out,)

    first = run(*args)
    _same_bits(f"{where}: a second call", [run(*args)], [first])
    _same_bits(f"{where}: x and w2 at an odd offset",
               [run(_at_offset(args[0]), _at_offset(args[1]), *args[2:])],
               [first])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        _same_bits(f"{where}: a CUDA graph replay", [captured], [first])
    return first


def _conv_nchw(x, w2, dtype):
    """K2's layer as cuDNN takes it: x [C, R, S] -> the NCHW input
    [R, C, 1, S] and w2 [Co, 9 C] -> the weight [Co, C, 1, 9], in dtype."""
    c = x.shape[0]
    xr = x.to(dtype).permute(1, 0, 2).unsqueeze(2).contiguous()
    weight = w2.to(dtype).reshape(-1, 9, c).permute(0, 2, 1).unsqueeze(2)
    return xr, weight.contiguous()


def conv_library_ms(x, w2, cbias, dtype=None):
    """cuDNN's F.conv2d (TF32 off, with bias) of the layer's conv alone, on
    the NCHW view [R, C, 1, S], in `dtype` (default float32): a yardstick
    of K2's conv without BN or tanh."""
    import torch
    import torch.nn.functional as F

    dtype = dtype or torch.float32
    xr, weight = _conv_nchw(x, w2, dtype)
    return cuda_ms(lambda: F.conv2d(xr, weight, cbias.to(dtype),
                                    stride=(1, 2), padding=(0, 4)))


def conv_bwd_library_ms(x, w2, dy, dtype):
    """cuDNN's `aten.convolution_backward` of the layer's conv alone (dx
    and dW, no bias, TF32 off) in `dtype`: a yardstick of K2-bwd's conv
    part, without the BN backward."""
    import torch

    xr, weight = _conv_nchw(x, w2, dtype)
    go = dy.to(dtype).permute(1, 0, 2).unsqueeze(2).contiguous()
    return cuda_ms(lambda: torch.ops.aten.convolution_backward(
        go, xr, weight, None, [1, 2], [0, 4], [1, 1], False, [0, 0], 1,
        [True, True, False]))


def pgenc_phase():
    """K2-eval against its plain version at each of the 10 flagship layers,
    R = 64 and R = 88 (the full-encode separator's 11 frames at batch 8),
    fp32 (1e-5 absolute on the tanh outputs) and bf16 (2^-7), with
    its contract (_k2_contract); cuDNN's conv alone timed beside."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.models.shape_plan import plan_phasegram_encoder
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer, pgenc_layer_plain

    cfg = RunConfig()
    specs, _ = plan_phasegram_encoder(
        (8, 1, cfg.num_frames, cfg.p_size ** 2), cfg.latent_chan, cfg.fc_size)
    if len(specs) != 10:
        raise SystemExit(f"expected the 10-layer flagship encoder, got "
                         f"{len(specs)}")
    g = torch.Generator(device="cuda").manual_seed(2)
    r = 8 * cfg.num_frames
    totals = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0,
              "device_ms": 0.0, "host_ms": 0.0, "conv_library_ms": 0.0}
    # R = 64: a window at batch 8; R = 88: the full-encode span at batch 8
    # (B x (num_frames + num_seq - 1))
    r88 = 8 * (cfg.num_frames + cfg.num_seq - 1)
    runs = ((r, torch.float32, 1e-5), (r, torch.bfloat16, 2.0 ** -7),
            (r88, torch.float32, 1e-5), (r88, torch.bfloat16, 2.0 ** -7))
    for r, dtype, atol in runs:
        s = cfg.p_size ** 2
        for i, sp in enumerate(specs):
            c, co = sp.in_ch, sp.out_ch
            x = torch.randn(c, r, s, device="cuda", generator=g).to(dtype)
            w2 = (torch.randn(co, 9 * c, device="cuda", generator=g)
                  / (3.0 * c ** 0.5)).to(dtype)
            cb, beta, mean = (torch.randn(co, device="cuda", generator=g)
                              * 0.1 for _ in range(3))
            gamma = 1.0 + 0.1 * torch.randn(co, device="cuda", generator=g)
            var = 0.5 + torch.rand(co, device="cuda", generator=g)
            vecs = (cb, gamma, beta, mean, var)
            y, = _k2_contract(
                f"K2-eval layer {i} R={r} {dtype}",
                lambda *a: pgenc_layer(*a, backend="kernel"), (x, w2, *vecs))
            y_ref = pgenc_layer_plain(x, w2, *vecs)
            torch.cuda.synchronize()
            err = max_err(y, y_ref)[0]
            if not torch.allclose(y.float(), y_ref.float(), atol=atol, rtol=0):
                raise SystemExit(f"K2 pgenc disagrees at layer {i} {dtype}: "
                                 f"{err} > {atol}")
            ms = cuda_ms(lambda: pgenc_layer(x, w2, *vecs, backend="kernel"))
            plain_ms = cuda_ms(lambda: pgenc_layer_plain(x, w2, *vecs))
            phase("k2_pgenc", layer=i, C=c, Co=co, R=r, S=s, dtype=str(dtype),
                  max_abs_err=err, atol=atol, ms=ms, plain_ms=plain_ms)
            if dtype == torch.float32 and r == 8 * cfg.num_frames:
                split = split_ms(lambda: pgenc_layer(x, w2, *vecs,
                                                     backend="kernel"))
                totals["device_ms"] += split[0]
                totals["host_ms"] += split[1]
                totals["err"] = max(totals["err"], err)
                totals["ms"] += ms
                totals["plain_ms"] += plain_ms
                totals["bytes"] += nbytes(x, w2, y) + 5 * 4 * co
                totals["flops"] += 2 * co * 9 * c * r * (s // 2)
                totals["conv_library_ms"] += conv_library_ms(x, w2, cb)
            s //= 2
    totals["bound"] = bound_ms(totals["bytes"], totals["flops"])
    phase("k2_pgenc_stack", layers=len(specs), R=8 * cfg.num_frames,
          dtype="torch.float32",
          ms=totals["ms"], plain_ms=totals["plain_ms"],
          device_ms=totals["device_ms"], host_ms=totals["host_ms"],
          bound_ms=totals["bound"][0], bound_by=totals["bound"][1],
          conv_library_ms=totals["conv_library_ms"],
          contract="two calls, x and w2 at an odd offset and a CUDA graph "
                   "replay give the same bits")
    return totals


def profile_phase(label: str, fn, calls: int = 3, watch=()):
    """Where `calls` calls of `fn` spend their time, under the port's
    exp/profiling.trace (torch.profiler; its Chrome trace into a temporary
    directory): CUDA kernel events summed by kernel
    name, against the host-clock wall time of the same window (the device's
    idle share). The 14 largest kernels are listed, and every kernel whose
    name contains a `watch` string. Returns {kernel name: launches}."""
    import torch
    from torch.autograd import DeviceType

    from maavss_tpu_torch.exp.profiling import trace

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d, trace(d) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)
    top = top[:14] + [e for e in top[14:] if any(w in e.key for w in watch)]
    phase(label, calls=calls, wall_ms=wall_ms, device_busy_ms=busy_ms,
          idle_share=(1.0 - busy_ms / wall_ms) if busy_ms else None,
          kernel_launches=sum(e.count for e in kernels),
          top=[{"kernel": e.key[:80], "ms": e.device_time_total / 1e3,
                "count": e.count} for e in top])
    return {e.key: e.count for e in kernels}


def lstm_bwd_phase():
    """K1-bwd against the plain BPTT and against autograd through the plain
    recurrence, at the shapes of k1_lstm, from the kernel forward's saved
    ys, cs and gate activations; two calls bitwise equal. Tolerances: fp32
    dxw 1e-5 absolute + 1e-5 relative (dh_prev sums in another order than
    cuBLAS); dW_h, a sum of B*T terms, 1e-4 of its largest entry + 1e-4
    relative; bf16 2^-7 of the largest entry + 2^-7 relative (one bf16
    rounding of each). The sweep's and dW_h's device times per launch come
    from torch.profiler; cuDNN's nn.LSTM backward is timed beside (fp32)."""
    import torch

    from maavss_tpu_torch.ops.cuda_lstm import (
        lstm_recurrence,
        lstm_recurrence_bwd,
        lstm_recurrence_bwd_plain,
        lstm_recurrence_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(3)
    h = 256
    report = None
    for b, t_len in K1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xws, whs, dys = _k1_inputs(b, t_len, dtype, g, h)
            rev = [False, True]
            fwd = lstm_recurrence(xws, whs, rev, backend="kernel")
            yss, css, actss = ([o[i] for o in fwd] for i in range(3))

            def kernel():
                return lstm_recurrence_bwd(actss, whs, yss, css, dys, rev,
                                           backend="kernel")

            def plain():
                return [lstm_recurrence_bwd_plain(*a) for a in
                        zip(actss, whs, yss, css, dys, rev)]

            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            where = f"B={b} T={t_len} {dtype}"
            _same_bits(f"K1-bwd {where}", got, again)
            fp32 = dtype == torch.float32
            e_dx = e_dw = 0.0
            for (dxw, dwh), (dxw_r, dwh_r) in zip(got, want):
                e_dx = max(e_dx, check_close(
                    f"K1-bwd dxw {where}", dxw, dxw_r,
                    1e-5 if fp32 else 2.0 ** -7, 1e-5 if fp32 else 2.0 ** -7,
                    scale_atol=not fp32))
                e_dw = max(e_dw, check_close(
                    f"K1-bwd dW_h {where}", dwh, dwh_r,
                    1e-4 if fp32 else 2.0 ** -7, 1e-4 if fp32 else 2.0 ** -7,
                    scale_atol=True))
            e_auto = None
            if fp32:  # autograd through the plain forward loop
                e_auto = 0.0
                for k in range(2):
                    xw = xws[k].clone().requires_grad_(True)
                    wh = whs[k].clone().requires_grad_(True)
                    ys = lstm_recurrence_plain(xw, wh, rev[k])[0]
                    ys.backward(dys[k])
                    e_auto = max(e_auto, check_close(
                        "K1-bwd dxw vs autograd", got[k][0], xw.grad, 1e-5,
                        1e-5))
                    e_auto = max(e_auto, check_close(
                        "K1-bwd dW_h vs autograd", got[k][1], wh.grad, 1e-4,
                        1e-4, scale_atol=True))
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            # the function's bytes: xw, w_h, ys, cs and dys read, dxw and
            # dW_h written, per direction (this design reads acts for xw)
            n_bytes = 2 * (nbytes(xws[0], whs[0], yss[0], css[0], dys[0])
                           + nbytes(*got[0]))
            # two products a step: dh_prev = dgates @ w_h^T and dW_h's share
            bnd = bound_ms(n_bytes, 2 * t_len * 2 * 2 * b * h * 4 * h)
            tc = None if fp32 else bound_ms(
                n_bytes, 2 * t_len * 2 * 2 * b * h * 4 * h,
                BF16_TC_FLOP_PER_S)
            lib_ms = dev_ms = host_ms = split_us = None
            if fp32 or b == 1024:  # cuDNN's bf16 LSTM at B = 1024 too
                lib_ms = cudnn_lstm_bwd_ms(xws, whs, dys)
            if fp32:
                dev_ms, host_ms = split_ms(kernel)
                split_us = {k: v for k, v in kernel_us(kernel).items()
                            if k.startswith("lstm_bwd")}
            phase("k1_bwd", B=b, T=t_len, H=h, dtype=str(dtype),
                  directions=2, geometry=_k1_geometry(b, h),
                  max_abs_err_dxw=e_dx, max_abs_err_dwh=e_dw,
                  max_abs_err_vs_autograd=e_auto, bitwise_repeat=True,
                  ms=ms, device_ms=dev_ms, host_ms=host_ms,
                  device_us_per_launch=split_us, plain_ms=plain_ms,
                  bound_ms=bnd[0], bound_by=bnd[1], bound_tensor_core=tc,
                  library_ms=lib_ms,
                  library="cuDNN nn.LSTM backward (more work: dx through "
                          "w_i, dW_i)")
            if (b, t_len) == (8, 8) and fp32:
                report = dict(err=max(e_dx, e_dw), ms=ms, plain_ms=plain_ms,
                              bound=bnd, library_ms=lib_ms, device_ms=dev_ms,
                              host_ms=host_ms)
    return report


K1_GATE_SHAPES = ((2, 8, 256), (4, 8, 256), (8, 8, 448), (12, 8, 96))
# (B, T, H): one and two rows per cluster (K1_SHAPES take four and eight),
# the largest H, and an H whose w_h slice is loaded one value at a time


def k1_gate_phase():
    """Both K1 kernels at K1_GATE_SHAPES, fp32 and bf16, against their plain
    versions at k1_lstm's and k1_bwd's tolerances, two calls bitwise equal;
    correctness only, so that every instantiation lstm_geometry can pick
    and both slice loads are held on the card."""
    import torch

    from maavss_tpu_torch.ops.cuda_lstm import (
        lstm_recurrence,
        lstm_recurrence_bwd,
        lstm_recurrence_bwd_plain,
        lstm_recurrence_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(5)
    rev = [False, True]
    for b, t_len, h in K1_GATE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            fp32 = dtype == torch.float32
            tol = 1e-5 if fp32 else 2.0 ** -7
            where = f"B={b} T={t_len} H={h} {dtype}"
            xws, whs, dys = _k1_inputs(b, t_len, dtype, g, h)
            fwd = lstm_recurrence(xws, whs, rev, backend="kernel")
            again = lstm_recurrence(xws, whs, rev, backend="kernel")
            torch.cuda.synchronize()
            _same_bits(f"K1 lstm {where}", fwd, again)
            e_fwd = 0.0
            for outs, x, w, r in zip(fwd, xws, whs, rev):
                for a, want in zip(outs, lstm_recurrence_plain(x, w, r)):
                    e_fwd = max(e_fwd, check_close(
                        f"K1 lstm {where}", a, want, 1e-5, tol))
            args = ([f[2] for f in fwd], whs, [f[0] for f in fwd],
                    [f[1] for f in fwd], dys, rev)
            got = lstm_recurrence_bwd(*args, backend="kernel")
            again = lstm_recurrence_bwd(*args, backend="kernel")
            torch.cuda.synchronize()
            _same_bits(f"K1-bwd {where}", got, again)
            e_dx = e_dw = 0.0
            for k, (dxw, dwh) in enumerate(got):
                dxw_r, dwh_r = lstm_recurrence_bwd_plain(
                    *(a[k] for a in args))
                e_dx = max(e_dx, check_close(
                    f"K1-bwd dxw {where}", dxw, dxw_r, tol, tol,
                    scale_atol=not fp32))
                e_dw = max(e_dw, check_close(
                    f"K1-bwd dW_h {where}", dwh, dwh_r,
                    1e-4 if fp32 else tol, 1e-4 if fp32 else tol,
                    scale_atol=True))
            phase("k1_gate", B=b, T=t_len, H=h, dtype=str(dtype),
                  geometry=_k1_geometry(b, h),
                  max_abs_err_fwd=e_fwd, max_abs_err_dxw=e_dx,
                  max_abs_err_dwh=e_dw, bitwise_repeat=True)


def _pgenc_inputs(c, co, r, s, dtype, g):
    import torch

    x = torch.randn(c, r, s, device="cuda", generator=g).to(dtype)
    w2 = (torch.randn(co, 9 * c, device="cuda", generator=g)
          / (3.0 * c ** 0.5)).to(dtype)
    cb, beta = (torch.randn(co, device="cuda", generator=g) * 0.1
                for _ in range(2))
    gamma = 1.0 + 0.1 * torch.randn(co, device="cuda", generator=g)
    dy = torch.randn(co, r, s // 2, device="cuda", generator=g).to(dtype)
    return x, w2, cb, gamma, beta, dy


def pgenc_train_phase():
    """K2-train and K2-bwd at each of the 10 flagship layers, R 64 (scan
    windows) and 256 (vectorized), and R 88 and 2816 (the full-encode span
    of 11 frames at batch 8 and 256), fp32 and bf16, against the plain
    versions
    and (fp32, R=64) autograd through the plain forward. Tolerances: fp32 y
    2e-5 absolute (tanh outputs; conv and statistics sums in another
    order), mu and var 1e-4 relative + 1e-5 absolute; dx, dw2, dgamma and
    dbeta, sums of up to R*S/2 terms, 1e-4 of their largest entry + 1e-4
    relative; bf16 2^-7 (one bf16 rounding), statistics as fp32 (they are
    fp32 from the same inputs). dcbias must be exactly 0. The backward reads
    the forward's yc; two calls must give the same bits (fixed-order sums;
    an atomic counter only elects the last block of a dW2 tile), and a
    second backward through pgenc_layer_train under retain_graph the same
    gradients as the first. x, w2, yc and dy at an offset of one element
    (their 16-byte loads then off) must pass the same gates. At R 64 the
    forward holds its contract (_k2_contract: y, mu, var and yc). cuDNN's
    conv alone is timed beside (fp32). Bound of the backward: the dx and
    dw2 products
    (2*Co*9C*R*S/2 FLOPs each) and x, w2, yc, dy read and dx, dw2 written
    once."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.models.shape_plan import plan_phasegram_encoder
    from maavss_tpu_torch.ops.cuda_pgenc import (
        pgenc_bwd,
        pgenc_bwd_plain,
        pgenc_layer_train,
        pgenc_train,
        pgenc_train_plain,
    )

    cfg = RunConfig()
    specs, _ = plan_phasegram_encoder(
        (8, 1, cfg.num_frames, cfg.p_size ** 2), cfg.latent_chan, cfg.fc_size)
    g = torch.Generator(device="cuda").manual_seed(4)
    totals = {}
    span = cfg.num_frames + cfg.num_seq - 1  # the full-encode step's frames
    both = (torch.float32, torch.bfloat16)
    for r, dtypes in ((8 * cfg.num_frames, both),
                      (8 * cfg.num_seq * cfg.num_frames, both),
                      (8 * span, both), (256 * span, both)):
        for dtype in dtypes:
            fp32 = dtype == torch.float32
            tol = 2e-5 if fp32 else 2.0 ** -7
            gtol = 1e-4 if fp32 else 2.0 ** -7
            tot = {k: 0.0 for k in ("fwd_ms", "fwd_plain_ms", "bwd_ms",
                                    "bwd_plain_ms", "fwd_err", "bwd_err",
                                    "fwd_bytes", "fwd_flops", "bwd_bytes",
                                    "bwd_flops", "fwd_device_ms",
                                    "fwd_host_ms", "bwd_device_ms",
                                    "bwd_host_ms", "conv_library_ms",
                                    "conv_bwd_library_ms")}
            s = cfg.p_size ** 2
            for i, sp in enumerate(specs):
                c, co = sp.in_ch, sp.out_ch
                x, w2, cb, gamma, beta, dy = _pgenc_inputs(c, co, r, s, dtype,
                                                           g)
                vecs = (cb, gamma, beta)
                where = f"layer {i} R={r} {dtype}"
                if r == 8 * cfg.num_frames:
                    y, mu, var, yc = _k2_contract(
                        f"K2-train forward {where}",
                        lambda *a: pgenc_train(*a, backend="kernel"),
                        (x, w2, *vecs))
                else:
                    y, mu, var, yc = pgenc_train(x, w2, *vecs,
                                                 backend="kernel")
                y_r, mu_r, var_r, yc_r = pgenc_train_plain(x, w2, *vecs)
                bwd_args = (x, w2, yc, gamma, beta, mu, var, dy)
                yc_kept = yc.clone()
                grads = pgenc_bwd(*bwd_args, backend="kernel")
                grads_2 = pgenc_bwd(*bwd_args, backend="kernel")
                grads_r = pgenc_bwd_plain(*bwd_args)
                # x, w2, yc and dy one element into their storage: the
                # kernel's one-value copies in place of its 16-byte ones
                grads_u = pgenc_bwd(*[_at_offset(t) if k in (0, 1, 2, 7)
                                      else t for k, t in enumerate(bwd_args)],
                                    backend="kernel")
                torch.cuda.synchronize()
                e_f = max(check_close(f"K2-train y {where}", y, y_r, tol, 0.0),
                          check_close(f"K2-train mu {where}", mu, mu_r, 1e-5,
                                      1e-4),
                          check_close(f"K2-train var {where}", var, var_r,
                                      1e-5, 1e-4),
                          check_close(f"K2-train yc {where}", yc, yc_r, 1e-5,
                                      1e-4, scale_atol=True))
                if not torch.equal(yc, yc_kept):
                    raise SystemExit(f"K2-bwd wrote over the saved yc at "
                                     f"{where}")
                if not all(torch.equal(a, b) for a, b in zip(grads, grads_2)):
                    raise SystemExit(f"K2-bwd: two calls differ at {where}")
                leaves = [t.clone().requires_grad_(True)
                          for t in (x, w2, cb, gamma, beta)]
                y_l, _, _ = pgenc_layer_train(*leaves, backend="kernel")
                first = torch.autograd.grad(y_l, leaves, dy, retain_graph=True)
                second = torch.autograd.grad(y_l, leaves, dy)
                if not all(torch.equal(a, b) for a, b in zip(first, second)):
                    raise SystemExit(f"K2-bwd: the retain_graph double "
                                     f"backward differs at {where}")
                if bool((grads[2] != 0).any()):
                    raise SystemExit(f"K2-bwd dcbias is not exactly 0 at "
                                     f"{where}")
                if bool((grads_u[2] != 0).any()):
                    raise SystemExit(f"K2-bwd dcbias is not exactly 0 at "
                                     f"{where}, unaligned")
                e_b = 0.0
                for name, k in (("dx", 0), ("dw2", 1), ("dgamma", 3),
                                ("dbeta", 4)):
                    for got, tag in ((grads, ""), (grads_u, " unaligned")):
                        e_b = max(e_b, check_close(
                            f"K2-bwd {name} {where}{tag}", got[k], grads_r[k],
                            gtol, gtol, scale_atol=True))
                if fp32 and r == 8 * cfg.num_frames:
                    leaves = [t.clone().requires_grad_(True)
                              for t in (x, w2, gamma, beta)]
                    y_a = pgenc_train_plain(leaves[0], leaves[1], cb,
                                            leaves[2], leaves[3])[0]
                    y_a.backward(dy)
                    for name, a, leaf in zip(
                            ("dx", "dw2", "dgamma", "dbeta"),
                            (grads[0], grads[1], grads[3], grads[4]), leaves):
                        e_b = max(e_b, check_close(
                            f"K2-bwd {name} vs autograd {where}", a,
                            leaf.grad, gtol, gtol, scale_atol=True))

                def fwd():
                    return pgenc_train(x, w2, *vecs, backend="kernel")

                def bwd():
                    return pgenc_bwd(*bwd_args, backend="kernel")

                fwd_ms = cuda_ms(fwd, reps=3, iters=10)
                fwd_plain = cuda_ms(lambda: pgenc_train_plain(x, w2, *vecs),
                                    reps=3, iters=10)
                bwd_ms = cuda_ms(bwd, reps=3, iters=10)
                bwd_plain = cuda_ms(lambda: pgenc_bwd_plain(*bwd_args),
                                    reps=3, iters=10)
                split = {}
                if fp32 and r == 8 * cfg.num_frames:
                    for key, fn in (("fwd", fwd), ("bwd", bwd)):
                        split[key] = split_ms(fn, reps=3, iters=10)
                        tot[f"{key}_device_ms"] += split[key][0]
                        tot[f"{key}_host_ms"] += split[key][1]
                if fp32:
                    split["bwd_kernel_us"] = kernel_us(bwd)
                    split["fwd_kernel_us"] = kernel_us(fwd)
                if fp32 or r == 256 * span:
                    tot["conv_library_ms"] += conv_library_ms(x, w2, cb,
                                                              dtype)
                if r == 256 * span:
                    tot["conv_bwd_library_ms"] += conv_bwd_library_ms(
                        x, w2, dy, dtype)
                conv_flops = 2 * co * 9 * c * r * (s // 2)
                tot["fwd_bytes"] += nbytes(x, w2, y, mu, var) + 3 * 4 * co
                tot["fwd_flops"] += conv_flops
                tot["bwd_bytes"] += (nbytes(x, w2, yc, dy, mu, var, grads[0],
                                            grads[1]) + 7 * 4 * co)
                tot["bwd_flops"] += 2 * conv_flops  # dx, dw2
                tot["fwd_ms"] += fwd_ms
                tot["fwd_plain_ms"] += fwd_plain
                tot["bwd_ms"] += bwd_ms
                tot["bwd_plain_ms"] += bwd_plain
                tot["fwd_err"] = max(tot["fwd_err"], e_f)
                tot["bwd_err"] = max(tot["bwd_err"], e_b)
                phase("k2_train", layer=i, C=c, Co=co, R=r, S=s,
                      dtype=str(dtype), max_abs_err_fwd=e_f,
                      max_abs_err_bwd=e_b, fwd_ms=fwd_ms,
                      fwd_plain_ms=fwd_plain, bwd_ms=bwd_ms,
                      bwd_plain_ms=bwd_plain, **split)
                s //= 2
            tot["fwd_bound"] = bound_ms(tot["fwd_bytes"], tot["fwd_flops"])
            tot["bwd_bound"] = bound_ms(tot["bwd_bytes"], tot["bwd_flops"])
            tc = None if fp32 else {
                k: bound_ms(tot[f"{k}_bytes"], tot[f"{k}_flops"],
                            BF16_TC_FLOP_PER_S) for k in ("fwd", "bwd")}
            phase("k2_train_stack", layers=len(specs), R=r, dtype=str(dtype),
                  fwd_ms=tot["fwd_ms"], fwd_plain_ms=tot["fwd_plain_ms"],
                  fwd_device_ms=tot["fwd_device_ms"] or None,
                  fwd_host_ms=tot["fwd_host_ms"] or None,
                  bwd_device_ms=tot["bwd_device_ms"] or None,
                  bwd_host_ms=tot["bwd_host_ms"] or None,
                  conv_library_ms=tot["conv_library_ms"] or None,
                  conv_bwd_library_ms=tot["conv_bwd_library_ms"] or None,
                  fwd_bound_ms=tot["fwd_bound"][0],
                  fwd_bound_by=tot["fwd_bound"][1], bwd_ms=tot["bwd_ms"],
                  bwd_plain_ms=tot["bwd_plain_ms"],
                  bwd_bound_ms=tot["bwd_bound"][0],
                  bwd_bound_by=tot["bwd_bound"][1], bound_tensor_core=tc)
            totals[(r, str(dtype))] = tot
    return totals[(8 * cfg.num_frames, "torch.float32")]


K2_GATE_ROWS = (1, 3, 17, 2048, 8192)
K2_GATE_WIDTHS = (2, 6, 4098)


# (C, Co) at R 8192, S 64: layer 6 of the fusion flagship (4 channel
# blocks) and a layer of 5 channel blocks
K2_CROSSING = ((64, 64), (64, 80))


def _crossing_grid(tiles: int, per_cb: int, limit: int) -> int:
    """The largest prime grid under `limit` and `tiles` in which a block's
    contiguous run of tiles crosses from one channel block (per_cb tiles)
    into the next, as pgenc_train.cu's conv_bn_train_kernel splits them."""
    for grid in range(min(limit, tiles) - 1, 1, -1):
        if any(grid % f == 0 for f in range(2, int(grid ** 0.5) + 1)):
            continue
        if any(b * tiles // grid // per_cb
               != ((b + 1) * tiles // grid - 1) // per_cb
               for b in range(grid)):
            return grid
    raise SystemExit(f"no crossing grid under {limit} for {tiles} tiles")


def _k2_crossing_check(c, co, s, g):
    """K2-train's forward at R 8192 on a grid whose blocks walk across
    channel blocks, so that a block sums a new channel block's statistics
    while its last tile of the previous one may still be normalised: the
    sums' order depends on the plan alone, so it must give the default
    grid's bits (y, mu, var, yc)."""
    import torch

    from maavss_tpu_torch.ops import cuda_pgenc as k2

    r = 8192
    x, w2, cb, gamma, beta, _ = _pgenc_inputs(c, co, r, s, torch.float32, g)
    plan = k2.pgenc_plan(c, r, s, co)
    resident = k2._resident_blocks(x.device.index, plan.tc, 0, plan.threads,
                                   plan.smem)
    grid = _crossing_grid(plan.tiles, plan.per_cb, resident)
    want = k2.pgenc_train(x, w2, cb, gamma, beta, backend="kernel")
    got = k2._train_launch(x, w2, (cb, gamma, beta), plan, grid)
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "mu", "var", "yc"), got, want):
        if not torch.equal(a, b):
            raise SystemExit(f"K2-train forward C={c} Co={co} R={r} S={s}: "
                             f"{name} on a grid of {grid} differs from the "
                             f"default grid's by "
                             f"{(a - b).abs().max().item()}")
    return {"C": c, "Co": co, "R": r, "S": s, "grid": grid,
            "default_grid": k2.train_grid(plan, resident),
            "channel_blocks": plan.tiles // plan.per_cb}


def k2_gate_phase():
    """K2's forward kernels, correctness only, at the ragged edges of the
    tile plan and at the rows the system runs beyond k2_train's: x [3, R, S]
    -> Co = 5 at every R of K2_GATE_ROWS and S of K2_GATE_WIDTHS, fp32 and
    bf16 (K2-train at k2_train's tolerances, K2-eval at k2_pgenc's); the 10
    flagship layers at R 2048 and 8192 (bench.py's batch 256 in scan and
    vectorized mode), fp32, with the contract (_k2_contract) at R 8192; and
    grids whose blocks walk across channel blocks (_k2_crossing_check);
    and a cooperative grid one block over what the card keeps resident,
    which must be refused."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.models.shape_plan import plan_phasegram_encoder
    from maavss_tpu_torch.ops import cuda_pgenc as k2

    g = torch.Generator(device="cuda").manual_seed(6)

    def check(c, co, r, s, dtype, contract=False):
        x, w2, cb, gamma, beta, _ = _pgenc_inputs(c, co, r, s, dtype, g)
        mean = torch.randn(co, device="cuda", generator=g) * 0.1
        var = 0.5 + torch.rand(co, device="cuda", generator=g)
        where = f"C={c} Co={co} R={r} S={s} {dtype}"
        train_args = (x, w2, cb, gamma, beta)
        eval_args = train_args + (mean, var)

        def train(*a):
            return k2.pgenc_train(*a, backend="kernel")

        def evl(*a):
            return k2.pgenc_layer(*a, backend="kernel")

        if contract:
            got = _k2_contract(f"K2-train forward {where}", train, train_args)
            y_e = _k2_contract(f"K2-eval {where}", evl, eval_args)[0]
        else:
            got, y_e = train(*train_args), evl(*eval_args)
        want = k2.pgenc_train_plain(*train_args)
        y_e_ref = k2.pgenc_layer_plain(*eval_args)
        torch.cuda.synchronize()
        fp32 = dtype == torch.float32
        return max(
            check_close(f"K2-train y {where}", got[0], want[0],
                        2e-5 if fp32 else 2.0 ** -7, 0.0),
            check_close(f"K2-train mu {where}", got[1], want[1], 1e-5, 1e-4),
            check_close(f"K2-train var {where}", got[2], want[2], 1e-5,
                        1e-4),
            check_close(f"K2-train yc {where}", got[3], want[3], 1e-5, 1e-4,
                        scale_atol=True),
            check_close(f"K2-eval y {where}", y_e, y_e_ref,
                        1e-5 if fp32 else 2.0 ** -7, 0.0))

    err, shapes = 0.0, 0
    for r in K2_GATE_ROWS:
        for s in K2_GATE_WIDTHS:
            for dtype in (torch.float32, torch.bfloat16):
                err = max(err, check(3, 5, r, s, dtype))
                shapes += 1
    cfg = RunConfig()
    specs, _ = plan_phasegram_encoder(
        (8, 1, cfg.num_frames, cfg.p_size ** 2), cfg.latent_chan, cfg.fc_size)
    flagship_err = 0.0
    for r in (2048, 8192):
        s = cfg.p_size ** 2
        for sp in specs:
            flagship_err = max(flagship_err, check(
                sp.in_ch, sp.out_ch, r, s, torch.float32, contract=r == 8192))
            s //= 2
    crossing = [_k2_crossing_check(c, co, 64, g) for c, co in K2_CROSSING]
    # layer 0 at R 8192: more tiles than resident blocks, so a grid of one
    # block more than the card keeps resident is a grid the kernel takes
    # but a cooperative launch may not run
    x, w2, cb, gamma, beta, _ = _pgenc_inputs(1, 2, 8192, 4096, torch.float32,
                                              g)
    plan = k2.pgenc_plan(1, 8192, 4096, 2)
    resident = k2._resident_blocks(x.device.index, plan.tc, 0, plan.threads,
                                   plan.smem)
    if plan.tiles <= resident:
        raise SystemExit(f"k2_gate: {plan.tiles} tiles, {resident} resident")
    try:
        k2._train_launch(x, w2, (cb, gamma, beta), plan, resident + 1)
        torch.cuda.synchronize()
    except RuntimeError as e:
        refused = str(e)
    else:
        raise SystemExit("K2-train: a cooperative grid over the resident "
                         "blocks was launched")
    phase("k2_gate", C=3, Co=5, rows=K2_GATE_ROWS, widths=K2_GATE_WIDTHS,
          shapes=shapes, max_abs_err=err, flagship_rows=[2048, 8192],
          flagship_max_abs_err=flagship_err,
          contract_rows=[64, 8192], crossing_grids=crossing,
          layer0_r8192_plan=plan._asdict(),
          resident_blocks=resident, over_resident_grid=refused)


def _at_offset(t):
    """A contiguous copy of t that starts one element into its storage."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


ADAM_SCHEDULE_STEPS = 10  # the cosine horizon of k3_adam's scheduled run


def adam_phase(steps: int = 3):
    """K3 over the flagship's parameter leaves (shapes from build_fusion),
    the decoders' leaves without a gradient as on the train path, from
    seeded g, m and v: `steps` steps against the plain formula, m, v and p
    at 1e-6 absolute + 1e-5 relative (the same fp32 formula; the compiler
    may contract a multiply-add into an fma), first at a constant rate,
    then under --lr_schedule cosine (a horizon of ADAM_SCHEDULE_STEPS
    steps), from the same start. The count lives on the card, as the
    optimizer keeps it: both sides read the step's [c1, c2, lr] that
    `device_bias_corrections` and the schedule make there (the kernel
    through its pointer; the plain formula takes a constant rate as the
    Python float, a schedule's as the 0-d tensor bc[2]), and [c1, c2] are
    held against the host formula (`bias_corrections`): the powers b^count
    within 2 fp32 ulp; the scheduled rate against the schedule on the
    host's count within 1e-6 relative. The kernel is timed at both rates
    (the same launch: only the value of bc[2] differs)."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.ops.cuda_adam import (
        AdamTable,
        adam_multi_tensor,
        adam_update_plain,
        bias_corrections,
        device_bias_corrections,
    )
    from maavss_tpu_torch.train.setup import build_fusion
    from maavss_tpu_torch.train.state import cosine_decay_schedule

    model = build_fusion(RunConfig(), 8, "cuda")
    named = list(model.named_parameters())
    g = torch.Generator(device="cuda").manual_seed(5)
    ps0 = [p.detach().clone() for _, p in named]
    grads = [None if "decoder" in n else
             torch.randn(p.shape, device="cuda", generator=g) * 1e-3
             for n, p in named]
    ms0 = [torch.randn(p.shape, device="cuda", generator=g) * 1e-4
           for p in ps0]
    vs0 = [torch.rand(p.shape, device="cuda", generator=g) * 1e-6
           for p in ps0]
    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8
    sched = cosine_decay_schedule(lr, ADAM_SCHEDULE_STEPS)
    betas = torch.tensor([b1, b2], dtype=torch.float32).cuda()
    err = bc_ulps = lr_rel = 0.0
    for scheduled in (False, True):
        ms, vs, ps = ([t.clone() for t in col] for col in (ms0, vs0, ps0))
        ref = [[t.clone() for t in col] for col in (ms0, vs0, ps0)]
        table = AdamTable(ms, vs, ps)
        count = torch.zeros((), dtype=torch.float32, device="cuda")
        bc = torch.zeros(3, dtype=torch.float32, device="cuda")
        bc[2].fill_(lr)
        for step in range(1, steps + 1):
            if scheduled:
                bc[2].copy_(sched(count))
                want = float(sched(torch.tensor(float(step - 1))))
                lr_rel = max(lr_rel, abs(bc[2].item() - want) / want)
                if lr_rel > 1e-6:
                    raise SystemExit(f"K3 step {step}: device rate "
                                     f"{bc[2].item()} vs host {want}")
            count.add_(1.0)
            bc[:2].copy_(device_bias_corrections(count, betas))
            host = torch.tensor(bias_corrections(step, b1, b2))
            # in ulps of the powers b^count (1 - c is exact for b^count >=
            # 1/2)
            ulp = torch.finfo(torch.float32).eps * (1.0 - host)
            bc_ulps = max(bc_ulps,
                          ((bc[:2].cpu() - host).abs() / ulp).max().item())
            if bc_ulps > 2:
                raise SystemExit(f"K3 step {step}: device [c1, c2] "
                                 f"{bc[:2].tolist()} vs host "
                                 f"{host.tolist()}: {bc_ulps} ulp")
            adam_multi_tensor(grads, ms, vs, ps, bc, b1, b2, eps,
                              table=table, backend="kernel")
            rate = bc[2] if scheduled else lr
            for gr, m, v, p in zip(grads, *ref):
                adam_update_plain(gr, m, v, p, bc[0], bc[1], rate, b1, b2,
                                  eps)
            torch.cuda.synchronize()
            what = "cosine" if scheduled else "constant"
            for name, got_col, want_col in zip("mvp", (ms, vs, ps), ref):
                for a, b_ in zip(got_col, want_col):
                    err = max(err, check_close(
                        f"K3 {what} {name} step {step}", a, b_, 1e-6, 1e-5))
        bc[:2].copy_(device_bias_corrections(count + 1.0, betas))

        def launch():
            adam_multi_tensor(grads, ms, vs, ps, bc, b1, b2, eps,
                              table=table, backend="kernel")

        if scheduled:
            sched_ms = cuda_ms(launch, reps=5, iters=10)
            sched_dev, sched_host = split_ms(launch, iters=10)
            sched_rate = bc[2].item()
            continue
        ms_k = cuda_ms(launch, reps=5, iters=10)

        def plain():
            for gr, m, v, p in zip(grads, *ref):
                adam_update_plain(gr, m, v, p, bc[0], bc[1], lr, b1, b2, eps)

        plain_ms = cuda_ms(plain, reps=3, iters=3)
        lib_params = [p.clone().requires_grad_(True) for p in ps]
        for p, gr in zip(lib_params, grads):
            p.grad = torch.zeros_like(p) if gr is None else gr.clone()
        opt = torch.optim.Adam(lib_params, lr=lr, eps=eps, fused=True)
        library_ms = cuda_ms(opt.step, reps=5, iters=10)
        del lib_params, opt
        dev_ms, host_ms = split_ms(launch, iters=10)
    n = sum(p.numel() for p in ps0)
    n_grad = sum(gr.numel() for gr in grads if gr is not None)
    bnd = bound_ms(4 * (6 * n + n_grad), 12 * n)
    phase("k3_adam", leaves=len(ps0), params=n, params_with_grad=n_grad,
          steps=steps, max_abs_err=err, atol=1e-6, rtol=1e-5,
          bias_corrections="device", bc_max_ulps_vs_host=bc_ulps,
          lr_on_device="bc[2]", cosine_rate_rel_vs_host=lr_rel, ms=ms_k,
          plain_ms=plain_ms, library_ms=library_ms, bound_ms=bnd[0],
          bound_by=bnd[1], device_ms=dev_ms, host_ms=host_ms,
          cosine_ms=sched_ms, cosine_device_ms=sched_dev,
          cosine_host_ms=sched_host, cosine_rate_timed=sched_rate)
    return dict(err=err, ms=ms_k, plain_ms=plain_ms, bound=bnd,
                library_ms=library_ms, device_ms=dev_ms, host_ms=host_ms)


def _rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def slice_phase():
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.exp.export import (
        make_serving_fn,
        random_serving_inputs,
        serving_input_specs,
    )
    from maavss_tpu_torch.exp.serving import (
        BatchingExecutor,
        SeparationClient,
        SeparationServer,
    )
    from maavss_tpu_torch.ops.cuda_lstm import lstm_recurrence
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer
    from maavss_tpu_torch.ops.stft import stft_features
    from maavss_tpu_torch.train.setup import build_fusion

    batch, tol = 8, 1e-4
    cfg = RunConfig(batch_size=batch)
    t0 = time.perf_counter()
    model = build_fusion(cfg, batch, "cuda",
                         torch.Generator().manual_seed(cfg.seed))
    ref = build_fusion(cfg.replace(pgenc_kernel="xla"), batch, "cuda",
                       torch.Generator().manual_seed(cfg.seed + 1))
    ref.load_state_dict(model.state_dict())
    ref.lstm.backend = "scan"
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if model.pgenc_kernel != "pallas":
        raise SystemExit("the auto phasegram-encoder gate did not take the "
                         "kernel stack on CUDA")
    serve = make_serving_fn(model, cfg)
    serve_ref = _plain_k4(make_serving_fn(ref, cfg))
    a_spec, v_spec = serving_input_specs(cfg, batch)
    n_layers = len(model.phasegram_encoder.specs)

    # requests: 1..8 rows of gaussian audio and broadband frames in [0, 1]
    rng = np.random.default_rng(7)
    rows_list = [1, 8, 3, 5, 2, 8, 4, 7]
    requests = []
    for i, rows in enumerate(rows_list):
        audio, _ = random_serving_inputs(cfg, rows, seed=100 + i)
        frames = rng.uniform(0, 1, (rows,) + v_spec.shape[1:]).astype(
            np.float32)
        requests.append((audio, frames))

    # warm-up outside the counted run (cuDNN / cuBLAS handles, allocator)
    dev = [torch.from_numpy(x).cuda() for x in random_serving_inputs(cfg, batch)]
    serve(*dev)
    torch.cuda.synchronize()
    direct_ms = cuda_ms(lambda: serve(*dev), reps=3, iters=5)
    direct_plain_ms = cuda_ms(lambda: serve_ref(*dev), reps=3, iters=5)
    profile_phase("profile", lambda: serve(*dev))

    executor = BatchingExecutor(serve, batch, a_spec, v_spec, "cuda",
                                max_wait_ms=5.0)
    server = SeparationServer(executor, {"model": "fusion", "batch": batch},
                              host="127.0.0.1", port=0).start()
    host, port = server.address
    client = SeparationClient(f"http://{host}:{port}")
    lstm_recurrence.launches = 0
    pgenc_layer.launches = 0
    stft_features.launches = 0
    responses, lat_ms = [], []
    try:
        for audio, frames in requests:
            t = time.perf_counter()
            responses.append(client.separate(audio, frames))
            lat_ms.append((time.perf_counter() - t) * 1e3)
        launches = {"lstm": lstm_recurrence.launches,
                    "pgenc": pgenc_layer.launches,
                    "stft": stft_features.launches}
        stats = client.get_json("/stats")
    finally:
        client.close()
        server.stop()

    batches = stats["batches"]
    want = {"lstm": batches * cfg.num_seq,
            "pgenc": batches * cfg.num_seq * n_layers, "stft": batches}
    if launches != want or batches < 1:
        raise SystemExit(f"kernel launches {launches} != {want} for "
                         f"{batches} batches of {cfg.num_seq} windows")
    worst = 0.0
    for (audio, frames), out in zip(requests, responses):
        rows = audio.shape[0]
        if out.shape != audio.shape or not np.all(np.isfinite(out)):
            raise SystemExit(f"bad response {out.shape} for {audio.shape}")
        pad_a = np.zeros(a_spec.shape, np.float32)
        pad_v = np.zeros(v_spec.shape, np.float32)
        pad_a[:rows], pad_v[:rows] = audio, frames
        exp = serve_ref(torch.from_numpy(pad_a).cuda(),
                        torch.from_numpy(pad_v).cuda())[:rows].cpu().numpy()
        worst = max(worst, _rel_l2(out, exp))
    if worst > tol:
        raise SystemExit(f"served audio vs plain separator rel L2 {worst} > "
                         f"{tol}")
    lat = sorted(lat_ms)
    phase("slice", requests=len(requests), rows=rows_list, batches=batches,
          params=n_params, build_s=round(build_s, 3),
          rel_l2_vs_plain=worst, tol=tol,
          p50_ms=statistics.median(lat),
          p90_ms=lat[min(len(lat) - 1, int(0.9 * len(lat)))],
          direct_batch8_ms=direct_ms, direct_batch8_plain_ms=direct_plain_ms,
          launches=launches)
    return launches


def golden_phase():
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.convert import from_flax, random_flax_tree, unflatten_tree
    from maavss_tpu_torch.exp.export import make_serving_fn
    from maavss_tpu_torch.ops.cuda_lstm import lstm_recurrence
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer
    from maavss_tpu_torch.train.setup import build_fusion

    tol = 1e-4
    with np.load(GOLDEN) as z:
        meta = json.loads(str(z["meta"]))
        audio, visual, want = z["audio"], z["visual"], z["audio_out"]
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    for path, total in meta["checksums"].items():
        if not np.isclose(float(flat[path].astype(np.float64).sum()), total,
                          rtol=1e-6, atol=1e-6):
            raise SystemExit(f"golden weights do not regenerate: {path}")
    tree = unflatten_tree(flat)
    cfg = RunConfig(**meta["cfg"])
    model = build_fusion(cfg, audio.shape[0], "cuda")
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    before = (lstm_recurrence.launches, pgenc_layer.launches)
    got = make_serving_fn(model, cfg)(torch.from_numpy(audio).cuda(),
                                      torch.from_numpy(visual).cuda())
    got = got.cpu().numpy()
    if (lstm_recurrence.launches, pgenc_layer.launches) <= before:
        raise SystemExit("the golden run did not go through both kernels")
    err = _rel_l2(got, want)
    if got.shape != want.shape or not np.all(np.isfinite(got)) or err > tol:
        raise SystemExit(f"port vs JAX golden: rel L2 {err} > {tol}")
    phase("golden", cfg=meta["cfg"], rel_l2_vs_jax=err, tol=tol)


def train_phase(steps: int = 3):
    """The full-width train step: kernels (every gate auto) against the
    plain versions (pgenc_kernel xla, LSTM scan, opt_kernel xla) from one
    state_dict, batch 8, scan windows, mode 2, noise_scalar 0, lr 1e-3 (so
    that one Adam step moves every parameter well past the tolerance); the
    leaves after step 1 as `_step1_close`, the gate of the K4 phases' steps
    of the same model, with the gradient's way open only to a leaf whose
    step-1 gradient has an rms under Adam's eps (v_fc1.bias, rms ~2e-9,
    whose update carries the gradient's last digits whole:
    tools/fusion_step1_probe_torch.py); every other leaf at relative L2
    1e-4."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.ops.cuda_adam import adam_multi_tensor
    from maavss_tpu_torch.ops.cuda_lstm import (
        lstm_recurrence,
        lstm_recurrence_bwd,
    )
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_bwd, pgenc_train
    from maavss_tpu_torch.ops.stft import stft_features
    from maavss_tpu_torch.train.setup import build_fusion, build_fusion_state
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_fusion_step

    batch_size, lr, tol = 8, 1e-3, 1e-4
    cfg = RunConfig(batch_size=batch_size, noise_scalar=0.0, learning_rate=lr)
    model, state = build_fusion_state(cfg, batch_size, "cuda",
                                      torch.Generator().manual_seed(cfg.seed))
    if model.pgenc_kernel != "pallas" or state.tx.kernel != "pallas":
        raise SystemExit("the auto gates did not take the kernels on CUDA")
    plain_cfg = cfg.replace(pgenc_kernel="xla", opt_kernel="xla")
    ref = build_fusion(plain_cfg, batch_size, "cuda",
                       torch.Generator().manual_seed(cfg.seed + 1))
    ref.load_state_dict(model.state_dict())
    ref.lstm.backend = "scan"
    ref_state = create_train_state(ref, plain_cfg, "cuda")
    step = make_fusion_step(model, cfg, device="cuda")
    ref_step = _plain_k4(make_fusion_step(ref, plain_cfg, device="cuda"))
    n_layers = len(model.phasegram_encoder.specs)
    names = ("lstm_fwd", "lstm_bwd", "pgenc_train", "pgenc_bwd", "adam",
             "stft")
    counters = (lstm_recurrence, lstm_recurrence_bwd, pgenc_train, pgenc_bwd,
                adam_multi_tensor, stft_features)
    ns = cfg.num_seq
    want = dict(zip(names, (ns, ns, ns * n_layers, ns * n_layers, 1, 1)))
    batches = [synthetic_av_batch(cfg, batch_size, seed=cfg.seed + i)
               for i in range(steps)]

    def run(fn, st, batch):
        for c in counters:
            c.launches = 0
        st, metrics = fn(st, batch, 2)
        torch.cuda.synchronize()
        return st, metrics, dict(zip(names, (c.launches for c in counters)))

    losses, ref_losses, worst = [], [], None
    grads = [_grab_step1_grads(st, mod) for st, mod in ((state, model),
                                                         (ref_state, ref))]
    alt_grads = _reordered_step1_grads(cfg, ref, batches[0], False)
    for i, batch in enumerate(batches):
        state, m, launches = run(step, state, batch)
        if launches != want:
            raise SystemExit(f"train step {i + 1}: launches {launches} != "
                             f"{want}")
        ref_state, rm, ref_launches = run(ref_step, ref_state, batch)
        if any(ref_launches.values()):
            raise SystemExit(f"the plain train step launched kernels: "
                             f"{ref_launches}")
        losses.append(float(m["loss"]))
        ref_losses.append(float(rm["loss"]))
        if i == 0:
            worst = _step1_close("train", model, ref, *grads, lr, tol, None,
                                 alt_grads, grad_rms_max=ADAM_EPS)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    if max(rel) > tol:
        raise SystemExit(f"train losses {losses} vs plain {ref_losses}: rel "
                         f"{rel} > {tol}")

    def step_ms(fn, st):
        """Median over 3 rounds of the mean of 2 back-to-back steps, from
        CUDA events; the step is host-bound, so the events span the host's
        launch time as well as the device's work."""
        return cuda_ms(lambda: fn(st, batches[0], 2), reps=3, iters=2)

    # kernels, plain, kernels, plain: two readings of each side in turns
    ms, plain_ms = step_ms(step, state), step_ms(ref_step, ref_state)
    ms_2, plain_ms_2 = step_ms(step, state), step_ms(ref_step, ref_state)
    vec = make_fusion_step(model, cfg, window_mode="vectorized",
                           device="cuda")
    _, _, vec_launches = run(vec, state, batches[0])
    vec_ms = step_ms(vec, state)
    phase("train", batch=batch_size, window_mode="scan", mode=2, lr=lr,
          steps=steps, params=sum(p.numel() for p in model.parameters()),
          leaves=len(list(model.parameters())), losses=losses,
          plain_losses=ref_losses, loss_rel_diff=max(rel), tol=tol,
          **worst, launches_per_step=want, step_ms=[ms, ms_2],
          plain_step_ms=[plain_ms, plain_ms_2],
          clips_per_s=batch_size / (min(ms, ms_2) / 1e3),
          plain_clips_per_s=batch_size / (min(plain_ms, plain_ms_2) / 1e3),
          vectorized_step_ms=vec_ms,
          vectorized_clips_per_s=batch_size / (vec_ms / 1e3),
          vectorized_launches=vec_launches)
    counts = profile_phase("train_profile",
                           lambda: step(state, batches[0], 2), calls=1,
                           watch=("conv_bn_train_kernel", "bn_bwd_kernel",
                                  "grads_kernel"))

    _no_rfft_kernels("train step", counts)

    def launches_of(name):
        return sum(n for k, n in counts.items()
                   if re.search(rf"\b{name}\b", k))

    # the forward is one cooperative launch a layer call; the kernels of
    # the kernels of its earlier three-launch form must not run
    k2 = {"pgenc_train_device": launches_of("conv_bn_train_kernel"),
          "three_launch_form": launches_of("conv_kernel")
          + launches_of("stats_kernel") + launches_of("apply_kernel"),
          "pgenc_bwd_device": launches_of("bn_bwd_kernel")
          + launches_of("grads_kernel")}
    calls = want["pgenc_train"]
    if (k2["pgenc_train_device"] != calls or k2["three_launch_form"]
            or k2["pgenc_bwd_device"] > 3 * want["pgenc_bwd"]):
        raise SystemExit(f"train step K2 device launches {k2} for {calls} "
                         f"layer calls: want conv_bn_train_kernel == {calls} "
                         f"(one a forward call), no conv_kernel, "
                         f"stats_kernel or apply_kernel, and <= 3 per "
                         f"pgenc_bwd call")
    phase("train_k2_launches", per_step=k2, pgenc_train_calls=calls,
          device_launches_per_pgenc_train=k2["pgenc_train_device"] / calls,
          pgenc_bwd_calls=want["pgenc_bwd"],
          device_launches_per_pgenc_bwd=k2["pgenc_bwd_device"]
          / want["pgenc_bwd"])
    return want


def train_golden_phase():
    """The small-geometry JAX train trajectory (3 steps, scan, mode 2,
    noise 0) through the port's kernels: per-step losses at relative 1e-4,
    and the per-leaf sums of the final parameters and statistics at 1e-4 of
    each leaf's sum of absolute values, the conv biases that feed a
    train-mode BatchNorm and their running means left out."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.convert import (
        flatten_tree,
        from_flax,
        random_flax_tree,
        to_flax,
        unflatten_tree,
    )
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.ops.cuda_lstm import lstm_recurrence_bwd
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_bwd
    from maavss_tpu_torch.train.setup import build_fusion_state
    from maavss_tpu_torch.train.steps import make_fusion_step

    tol = 1e-4
    with np.load(TRAIN_GOLDEN) as z:
        meta = json.loads(str(z["meta"]))
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    for path, total in meta["checksums"].items():
        if not np.isclose(float(flat[path].astype(np.float64).sum()), total,
                          rtol=1e-6, atol=1e-6):
            raise SystemExit(f"train golden weights do not regenerate: {path}")
    tree = unflatten_tree(flat)
    cfg = RunConfig(**meta["cfg"])
    model, state = build_fusion_state(cfg, cfg.batch_size, "cuda")
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=meta["batch_seed"])
    noise = np.random.default_rng(meta["frames_noise_seed"]).standard_normal(
        batch["frames"].shape).astype(np.float32)
    batch["frames"] = np.clip(batch["frames"] + meta["frames_noise"] * noise,
                              0.0, 1.0)
    step = make_fusion_step(model, cfg, device="cuda")
    before = (lstm_recurrence_bwd.launches, pgenc_bwd.launches)
    losses = []
    for _ in meta["losses"]:
        state, m = step(state, batch, meta["mode"])
        losses.append(float(m["loss"]))
    if (lstm_recurrence_bwd.launches, pgenc_bwd.launches) <= before:
        raise SystemExit("the train golden run did not go through the "
                         "backward kernels")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, meta["losses"]))
    if rel > tol:
        raise SystemExit(f"train golden losses {losses} vs JAX "
                         f"{meta['losses']}: rel {rel} > {tol}")
    params, stats = to_flax(model.state_dict())
    got = flatten_tree({"params": params, "batch_stats": stats})
    worst = 0.0
    for path, (total, abs_total) in meta["sums"].items():
        d = abs(float(got[path].astype(np.float64).sum()) - total)
        worst = max(worst, d / max(abs_total, 1e-12))
        if d > tol * abs_total + 1e-7:
            raise SystemExit(f"train golden leaf {path}: sum off by {d}")
    phase("train_golden", cfg=meta["cfg"], losses=losses,
          jax_losses=meta["losses"], loss_rel_diff=rel,
          worst_leaf_sum_rel=worst, leaves=len(meta["sums"]),
          left_out=len(meta["bn_fed"]), tol=tol)


def _rel_check(what, got, want, tol):
    """Raise unless the relative L2 error of `got` against `want` is at
    most `tol`; return the max abs error."""
    import torch

    d = (got.double() - want.double())
    rel = (torch.linalg.vector_norm(d)
           / torch.linalg.vector_norm(want.double()).clamp(min=1e-30)).item()
    if rel > tol:
        raise SystemExit(f"{what}: relative L2 error {rel} > {tol}")
    return d.abs().max().item()


def _k5_inputs(shape, g, ties):
    import torch

    b, c, t, h, w = shape
    y = torch.randn(shape, device="cuda", generator=g) * 0.7
    if ties:  # a coarse grid: ~1/3 of the windows hold their max twice
        y = torch.round(y * 2.0) / 2.0
    gamma = 0.8 * torch.randn(c, device="cuda", generator=g)
    gamma[: c // 3] = -gamma[: c // 3].abs() - 0.1
    beta = 0.3 * torch.randn(c, device="cuda", generator=g)
    g_out = torch.randn((b, c, t, h // 2, w // 2), device="cuda", generator=g)
    g_mu, g_var = (torch.randn(c, device="cuda", generator=g)
                   for _ in range(2))
    return y, gamma, beta, g_out, g_mu, g_var


K5_SHAPES = ((8, 16, 8, 256, 256), (8, 32, 8, 128, 128))
# edge geometries of apply and bwd reduce: W/2 of 1, 3, 9 and 65 (not a
# multiple of apply's 4 windows a thread: its scalar path; and L not a
# multiple of a 16-byte load: bwd reduce's one value a load), H = 2, C = 1
# and 3 windows a row on the vector path
K5_EDGES = ((2, 3, 2, 6, 2), (2, 3, 2, 6, 6), (2, 3, 2, 6, 18),
            (2, 3, 2, 6, 130), (2, 3, 2, 2, 16), (2, 1, 2, 6, 16),
            (3, 5, 2, 4, 24))
# the earlier design's device ms of the two redesigned K5 kernels at
# stages 0+1, (fp32, bf16): one thread a window for apply, one value a load
# and a second combine launch for bwd reduce (PERF.md's kernel table, NVIDIA
# H100 80GB HBM3, 700.00 W)
K5_EARLIER_DEVICE_MS = {"apply": (0.218, 0.194),
                        "bwd_reduce": (0.095, 0.0622)}


def k5_phase():
    """K5's four kernels against their plain versions at the flagship
    frames encoder's stage-0 and stage-1 conv outputs (batch 8, 8 frames,
    K5_SHAPES), each on gaussian y and on a tensor of exact ties (y rounded
    to 0.5: about a third of the windows tie at their max, and the
    first-match routing decides dy there), a
    third of gamma negative, nonzero cotangents on mu and var. Each kernel
    and its plain version get the same inputs (the kernels' own upstream
    results). Tolerances: mu, var, rstd and out relative L2 1e-5 (fp32 sums
    in another order); sel bitwise; dgamma, dbeta and the dy constants k
    relative L2 1e-4 (sums over 1/4 of the elements); dy within 1e-4 of its
    largest entry + 1e-4 relative. Times (gaussian case) are median of 5 x
    20 calls; the unfused PyTorch tail and the fused autograd Function are
    timed forward + backward beside."""
    import torch
    import torch.nn.functional as F

    from maavss_tpu_torch.ops.cuda_epilogue import (
        epilogue_apply,
        epilogue_apply_plain,
        epilogue_bwd_dy,
        epilogue_bwd_dy_plain,
        epilogue_bwd_reduce,
        epilogue_bwd_reduce_plain,
        epilogue_stats,
        epilogue_stats_plain,
        fused_bn_pool_leaky,
    )

    g = torch.Generator(device="cuda").manual_seed(6)
    names = ("stats", "apply", "bwd_reduce", "bwd_dy")
    rep = {n: dict(err=0.0, ms=0.0, plain_ms=0.0, bytes=0, flops=0,
                   device_ms=0.0, host_ms=0.0) for n in names}
    rep["stats"]["library_ms"] = 0.0
    tails = []
    for stage, shape in enumerate(K5_SHAPES):
        for ties in (False, True):
            y, gamma, beta, g_out, g_mu, g_var = _k5_inputs(shape, g, ties)
            where = f"stage {stage} {'ties' if ties else 'gaussian'}"
            mu, var, rstd = epilogue_stats(y)
            stats_p = epilogue_stats_plain(y)
            out, sel = epilogue_apply(y, gamma, beta, mu, rstd)
            out_p, sel_p = epilogue_apply_plain(y, gamma, beta, mu, rstd)
            red = epilogue_bwd_reduce(g_out, sel, gamma, beta, mu, rstd,
                                      g_mu, g_var)
            red_p = epilogue_bwd_reduce_plain(g_out, sel, gamma, beta, mu,
                                              rstd, g_mu, g_var)
            dy = epilogue_bwd_dy(y, g_out, sel, gamma, beta, mu, rstd,
                                 red[2])
            dy_p = epilogue_bwd_dy_plain(y, g_out, sel, gamma, beta, mu,
                                         rstd, red[2])
            torch.cuda.synchronize()
            if not torch.equal(sel, sel_p):
                raise SystemExit(f"K5 apply sel differs at {where}")
            errs = {
                "stats": max(_rel_check(f"K5 stats {n} {where}", a, b, 1e-5)
                             for n, a, b in zip(("mu", "var", "rstd"),
                                                (mu, var, rstd), stats_p)),
                "apply": _rel_check(f"K5 apply out {where}", out, out_p,
                                    1e-5),
                "bwd_reduce": max(_rel_check(f"K5 bwd reduce {n} {where}",
                                             a, b, 1e-4)
                                  for n, a, b in zip(("dgamma", "dbeta", "k"),
                                                     red, red_p)),
                "bwd_dy": check_close(f"K5 dy {where}", dy, dy_p, 1e-4, 1e-4,
                                      scale_atol=True),
            }
            _k5_reduce_bits(where, (g_out, sel, gamma, beta, mu, rstd, g_mu,
                                    g_var))
            y4 = y.view(shape[:3] + (shape[3] // 2, 2, shape[4] // 2, 2))
            m = y4.amax(dim=(4, 6), keepdim=True)
            tied = ((y4 == m).sum(dim=(4, 6)) > 1).float().mean().item()
            for n in names:
                rep[n]["err"] = max(rep[n]["err"], errs[n])
            phase("k5_check", stage=stage, shape=list(shape), ties=ties,
                  tied_window_share=tied, **{f"max_abs_err_{n}": errs[n]
                                             for n in names})
            if not ties:
                _k5_unaligned(where, y, gamma, beta, g_out, red[2],
                              (mu, rstd), (out, sel, dy))
            if ties:
                continue
            calls = {
                "stats": (lambda: epilogue_stats(y),
                          lambda: epilogue_stats_plain(y)),
                "apply": (lambda: epilogue_apply(y, gamma, beta, mu, rstd),
                          lambda: epilogue_apply_plain(y, gamma, beta, mu,
                                                       rstd)),
                "bwd_reduce": (
                    lambda: epilogue_bwd_reduce(g_out, sel, gamma, beta, mu,
                                                rstd, g_mu, g_var),
                    lambda: epilogue_bwd_reduce_plain(g_out, sel, gamma, beta,
                                                      mu, rstd, g_mu, g_var)),
                "bwd_dy": (
                    lambda: epilogue_bwd_dy(y, g_out, sel, gamma, beta, mu,
                                            rstd, red[2]),
                    lambda: epilogue_bwd_dy_plain(y, g_out, sel, gamma, beta,
                                                  mu, rstd, red[2])),
            }
            n_el, c = y.numel(), shape[1]
            moved = {"stats": nbytes(y, mu, var, rstd),
                     "apply": nbytes(y, out, sel) + 4 * 4 * c,
                     "bwd_reduce": nbytes(g_out, sel) + 12 * 4 * c,
                     "bwd_dy": nbytes(y, g_out, sel, dy) + 8 * 4 * c}
            ops = {"stats": 3 * n_el, "apply": 9 * n_el // 4,
                   "bwd_reduce": 8 * n_el // 4, "bwd_dy": 10 * n_el}
            times = {}
            for n in names:
                times[n] = (cuda_ms(calls[n][0]), cuda_ms(calls[n][1]))
                split = split_ms(calls[n][0])
                rep[n]["device_ms"] += split[0]
                rep[n]["host_ms"] += split[1]
                rep[n]["ms"] += times[n][0]
                rep[n]["plain_ms"] += times[n][1]
                rep[n]["bytes"] += moved[n]
                rep[n]["flops"] += ops[n]
            # the biased per-channel statistics in one PyTorch call
            rep["stats"]["library_ms"] += cuda_ms(lambda: torch.var_mean(
                y, dim=(0, 2, 3, 4), correction=0))
            leaves = [t.clone().requires_grad_(True) for t in (y, gamma, beta)]

            def unfused():
                for t in leaves:
                    t.grad = None
                z = F.batch_norm(leaves[0], None, None, leaves[1], leaves[2],
                                 training=True, eps=1e-5)
                o = F.leaky_relu(F.max_pool3d(z, (1, 2, 2)), 0.01)
                o.backward(g_out)

            def fused():
                for t in leaves:
                    t.grad = None
                o, _, _ = fused_bn_pool_leaky(*leaves)
                o.backward(g_out)

            tail_ms, fused_ms = cuda_ms(unfused), cuda_ms(fused)
            tails.append((tail_ms, fused_ms))
            phase("k5_time", stage=stage, shape=list(shape),
                  **{f"{n}_ms": times[n][0] for n in names},
                  **{f"{n}_plain_ms": times[n][1] for n in names},
                  **{f"{n}_bound_ms": bound_ms(moved[n], ops[n])[0]
                     for n in names},
                  fused_fwd_bwd_ms=fused_ms, unfused_torch_fwd_bwd_ms=tail_ms)
    edges = _k5_edges(torch.float32, lambda what, a, b: _rel_check(
        what, a, b, 1e-5))
    for n, err in edges.items():
        rep[n]["err"] = max(rep[n]["err"], err)
    for n in names:
        rep[n]["bound"] = bound_ms(rep[n]["bytes"], rep[n]["flops"])
        rep[n].setdefault("library_ms", None)
    phase("k5_epilogue", shapes=[list(s) for s in K5_SHAPES],
          **{n: {k: v for k, v in r.items() if k not in ("bytes", "flops")}
             for n, r in rep.items()},
          earlier_design_device_ms={n: v[0] for n, v in
                                    K5_EARLIER_DEVICE_MS.items()},
          fused_fwd_bwd_ms=sum(f for _, f in tails),
          unfused_torch_fwd_bwd_ms=sum(t for t, _ in tails))
    return rep


def _k5_unaligned(where, y, gamma, beta, g_out, k, stats, aligned):
    """K5's stats, apply and bwd dy on a y one float into its storage (not
    8- or 16-byte aligned, so the kernels take 4-byte loads) against the
    plain versions at k5_phase's gates; apply and dy are elementwise, so
    they also give the aligned call's bits."""
    import torch

    from maavss_tpu_torch.ops.cuda_epilogue import (
        epilogue_apply,
        epilogue_apply_plain,
        epilogue_bwd_dy,
        epilogue_bwd_dy_plain,
        epilogue_stats,
        epilogue_stats_plain,
    )

    yo = _at_offset(y)
    if yo.data_ptr() % 8 == 0:
        raise SystemExit("K5 unaligned check: y is aligned")
    where = f"{where} y at an odd offset"
    mu, var, rstd = epilogue_stats(yo)
    errs = [_rel_check(f"K5 stats {n} {where}", a, b, 1e-5)
            for n, a, b in zip(("mu", "var", "rstd"), (mu, var, rstd),
                               epilogue_stats_plain(yo))]
    out, sel = epilogue_apply(yo, gamma, beta, mu, rstd)
    out_p, sel_p = epilogue_apply_plain(yo, gamma, beta, mu, rstd)
    dy = epilogue_bwd_dy(yo, g_out, sel, gamma, beta, mu, rstd, k)
    dy_p = epilogue_bwd_dy_plain(yo, g_out, sel, gamma, beta, mu, rstd, k)
    torch.cuda.synchronize()
    if not torch.equal(sel, sel_p):
        raise SystemExit(f"K5 apply sel differs at {where}")
    errs.append(_rel_check(f"K5 apply out {where}", out, out_p, 1e-5))
    errs.append(check_close(f"K5 dy {where}", dy, dy_p, 1e-4, 1e-4,
                            scale_atol=True))
    # with the aligned call's statistics, apply and dy are the same bits
    out, sel = epilogue_apply(yo, gamma, beta, *stats)
    dy = epilogue_bwd_dy(yo, g_out, sel, gamma, beta, *stats, k)
    same = all(torch.equal(a, b) for a, b in zip((out, sel, dy), aligned))
    if not same:
        raise SystemExit(f"K5 at an odd offset: apply/dy differ from the "
                         f"aligned call's bits at {where}")
    phase("k5_unaligned", where=where, y_offset_bytes=yo.data_ptr() % 16,
          max_abs_err=max(errs), same_bits_as_aligned=same)


def _k5_reduce_bits(where, args):
    """bwd reduce twice: the same bits (fixed-order sums, no atomics on
    them). Returns the first call's (dgamma, dbeta, k)."""
    from maavss_tpu_torch.ops.cuda_epilogue import epilogue_bwd_reduce

    first = epilogue_bwd_reduce(*args)
    _same_bits(f"K5 bwd reduce, two calls, {where}", [first],
               [epilogue_bwd_reduce(*args)])
    return first


def _k5_edges(dtype, out_close):
    """apply and bwd reduce at K5_EDGES, each with y (and g) aligned and
    one element into its storage, against the plain versions: apply's plan
    takes the vector path exactly where W/2 is a multiple of 4 and y is
    aligned; sel bitwise, out by `out_close(what, got, want)`; dgamma,
    dbeta and k at relative L2 1e-4; two bwd reduce calls bitwise equal.
    Returns the worst errors of apply and bwd reduce."""
    import torch

    from maavss_tpu_torch.ops.cuda_epilogue import (
        apply_plan,
        epilogue_apply,
        epilogue_apply_plain,
        epilogue_bwd_reduce_plain,
        epilogue_stats,
    )

    g = torch.Generator(device="cuda").manual_seed(26)
    worst = {"apply": 0.0, "bwd_reduce": 0.0}
    paths = []
    for shape in K5_EDGES:
        y, gamma, beta, g_out, g_mu, g_var = _k5_inputs(shape, g, False)
        y, g_out = y.to(dtype), g_out.to(dtype)
        for odd in (False, True):
            yy, gg = (_at_offset(y), _at_offset(g_out)) if odd else (y, g_out)
            where = f"{list(shape)} {dtype} {'odd offset' if odd else ''}"
            mu, _, rstd = epilogue_stats(yy)
            out, sel = epilogue_apply(yy, gamma, beta, mu, rstd)
            out_p, sel_p = epilogue_apply_plain(yy, gamma, beta, mu, rstd)
            plan = apply_plan(yy.shape, yy.element_size(), yy.data_ptr(),
                              out.data_ptr(), sel.data_ptr())
            vector = shape[4] // 2 % 4 == 0 and not odd
            if (plan.windows == 4) != vector:
                raise SystemExit(f"K5 apply plan {plan} at {where}")
            args = (gg, sel, gamma, beta, mu, rstd, g_mu, g_var)
            red = _k5_reduce_bits(where, args)
            red_p = epilogue_bwd_reduce_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(sel, sel_p):
                raise SystemExit(f"K5 apply sel differs at {where}")
            worst["apply"] = max(worst["apply"], out_close(
                f"K5 apply out {where}", out, out_p))
            worst["bwd_reduce"] = max(worst["bwd_reduce"], *(
                _rel_check(f"K5 bwd reduce {n} {where}", a, b, 1e-4)
                for n, a, b in zip(("dgamma", "dbeta", "k"), red, red_p)))
            paths.append("vector" if plan.windows == 4 else "scalar")
    phase("k5_edges", dtype=str(dtype), shapes=[list(s) for s in K5_EDGES],
          apply_paths=paths, **{f"max_abs_err_{n}": e
                                for n, e in worst.items()})
    return worst


def _epilogue_counters():
    from maavss_tpu_torch.ops import cuda_epilogue as ep

    return (ep.epilogue_stats, ep.epilogue_apply, ep.epilogue_bwd_reduce,
            ep.epilogue_bwd_dy)


def _unfused(fn):
    """`fn` run with every frames stage on the unfused tail (no stage is
    large enough for the fused epilogue): TorchBatchNorm, F.max_pool3d and
    F.leaky_relu under autograd, the PyTorch model without K5."""
    def run(*args):
        old = os.environ.get("MAAVSS_S2D_MIN_HW")
        os.environ["MAAVSS_S2D_MIN_HW"] = str(1 << 30)
        try:
            return fn(*args)
        finally:
            if old is None:
                os.environ.pop("MAAVSS_S2D_MIN_HW")
            else:
                os.environ["MAAVSS_S2D_MIN_HW"] = old
    return run


def _plain_k5(fn):
    """`fn` run with the fused stages on K5's plain versions (forward and
    explicit backward) in place of its kernels."""
    from maavss_tpu_torch.models import layers
    from maavss_tpu_torch.ops.cuda_epilogue import fused_bn_pool_leaky_plain

    def run(*args):
        kernels = layers.fused_bn_pool_leaky
        layers.fused_bn_pool_leaky = fused_bn_pool_leaky_plain
        try:
            return fn(*args)
        finally:
            layers.fused_bn_pool_leaky = kernels
    return run


def _frames_params_close(model, ref, tol: float, enc_tol: float,
                         what: str = "frames train: after step 1"):
    """Every state_dict leaf of `model` against `ref` after one step:
    relative L2 <= tol, the visual encoder's <= enc_tol. Those are
    ill-conditioned at full width: the frames are flat over most of their
    area, so each conv weight gradient after a train-mode BN is a near-total
    cancellation, and a 4e-7 relative change of one stage's batch variance
    (fp32 sums in another order) moves Conv_0's gradient by ~2e-3 relative,
    while the plain versions fed the kernels' statistics agree with the
    kernels to ~1e-6 (tools/frames_grad_probe.py measures both). enc_tol is
    the JAX package's own tolerance between its fused epilogue and XLA's
    unfused tail on the encoder's gradients
    (tests/test_pallas_epilogue.py:176-178). Every leaf past its gate is
    named. Returns the worst relative L2 (encoder, rest)."""
    import torch

    sd, sd_ref = model.state_dict(), ref.state_dict()
    worst, bad = [0.0, 0.0], []
    for k, v in sd.items():
        a, b = v.float(), sd_ref[k].float()
        enc = k.startswith("visual_encoder.")
        rel = (torch.linalg.vector_norm(a - b)
               / torch.linalg.vector_norm(b).clamp(min=1e-12)).item()
        worst[1 - enc] = max(worst[1 - enc], rel)
        if rel > (enc_tol if enc else tol):
            bad.append(f"{k} rel L2 {rel}")
    if bad:
        raise SystemExit(f"{what}: " + "; ".join(bad))
    return worst


def frames_train_phase(steps: int = 3):
    """The full-width frames train step (framesize 256, batch 8, 4 windows
    of 8 frames, mode 2, noise_scalar 0, lr 1e-3): every kernel on its path
    (K5 at stages 0 and 1 of each window, K1-fwd, K1-bwd, K3), against the
    plain versions from one state_dict (K5's plain forward and explicit
    backward, the LSTM scan, the plain Adam formula): per-step losses at
    relative 1e-4, the leaves after step 1 as `_frames_params_close`, launch
    counts exactly, per step. Timed in turns: kernels, the PyTorch model
    without K5 (the unfused tail, every other kernel on), plain versions."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.ops.cuda_adam import adam_multi_tensor
    from maavss_tpu_torch.ops.cuda_lstm import (
        lstm_recurrence,
        lstm_recurrence_bwd,
    )
    from maavss_tpu_torch.ops.cuda_pgenc import (
        pgenc_bwd,
        pgenc_layer,
        pgenc_train,
    )
    from maavss_tpu_torch.ops.stft import stft_features
    from maavss_tpu_torch.train.setup import (
        build_frames_model,
        build_frames_state,
    )
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_frames_step

    os.environ.pop("MAAVSS_S2D_MIN_HW", None)  # the default, 128
    batch_size, lr, tol, enc_tol = 8, 1e-3, 1e-4, 2e-3
    cfg = RunConfig(batch_size=batch_size, noise_scalar=0.0, learning_rate=lr)
    t0 = time.perf_counter()
    model, state = build_frames_state(
        cfg, batch_size, generator=torch.Generator().manual_seed(cfg.seed))
    if state.tx.kernel != "pallas":
        raise SystemExit("the auto optimizer gate did not take K3 on CUDA")
    plain_cfg = cfg.replace(opt_kernel="xla")
    ref = build_frames_model(plain_cfg, batch_size, generator=torch.Generator()
                             .manual_seed(cfg.seed + 1))
    ref.load_state_dict(model.state_dict())
    ref.lstm.backend = "scan"
    ref_state = create_train_state(ref, plain_cfg, "cuda")
    build_s = time.perf_counter() - t0
    step = make_frames_step(model, cfg)
    ref_step = _plain_k4(_plain_k5(make_frames_step(ref, plain_cfg)))
    ns = cfg.num_seq
    names = ("lstm_fwd", "lstm_bwd", "adam", "epilogue_stats",
             "epilogue_apply", "epilogue_bwd_reduce", "epilogue_bwd_dy",
             "pgenc_eval", "pgenc_train", "pgenc_bwd", "stft")
    counters = (lstm_recurrence, lstm_recurrence_bwd, adam_multi_tensor,
                *_epilogue_counters(), pgenc_layer, pgenc_train, pgenc_bwd,
                stft_features)
    # stages 0 and 1 (inputs 256^2 and 128^2) take K5 in every window
    want = dict(zip(names, (ns, ns, 1) + (2 * ns,) * 4 + (0, 0, 0, 1)))
    batches = [synthetic_av_batch(cfg, batch_size, seed=cfg.seed + i,
                                  frame_size=cfg.framesize)
               for i in range(steps)]

    def run(fn, st, batch):
        for c in counters:
            c.launches = 0
        st, metrics = fn(st, batch, 2)
        torch.cuda.synchronize()
        return st, metrics, dict(zip(names, (c.launches for c in counters)))

    torch.cuda.reset_peak_memory_stats()
    losses, ref_losses, worst = [], [], None
    for i, batch in enumerate(batches):
        state, m, launches = run(step, state, batch)
        if launches != want:
            raise SystemExit(f"frames train step {i + 1}: launches "
                             f"{launches} != {want}")
        ref_state, rm, ref_launches = run(ref_step, ref_state, batch)
        if any(ref_launches.values()):
            raise SystemExit(f"the plain frames step launched kernels: "
                             f"{ref_launches}")
        losses.append(float(m["loss"]))
        ref_losses.append(float(rm["loss"]))
        if i == 0:
            worst = _frames_params_close(model, ref, tol, enc_tol)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    if max(rel) > tol or not all(map(math.isfinite, losses)):
        raise SystemExit(f"frames train losses {losses} vs plain "
                         f"{ref_losses}: rel {rel} > {tol}")

    def step_ms(fn, st):
        """Median over 3 rounds of the mean of 2 back-to-back steps, from
        CUDA events."""
        return cuda_ms(lambda: fn(st, batches[0], 2), reps=3, iters=2)

    unfused_step = _unfused(step)
    times = {"kernels": [], "unfused_tail": [], "plain": []}
    for _ in range(2):  # in turns: kernels, unfused tail, plain, twice
        times["kernels"].append(step_ms(step, state))
        times["unfused_tail"].append(step_ms(unfused_step, state))
        times["plain"].append(step_ms(ref_step, ref_state))
    clips = {k: batch_size / (min(v) / 1e3) for k, v in times.items()}
    phase("frames_train", batch=batch_size, framesize=cfg.framesize,
          windows=ns, mode=2, lr=lr, steps=steps,
          params=sum(p.numel() for p in model.parameters()),
          leaves=len(list(model.parameters())), build_s=round(build_s, 3),
          losses=losses, plain_losses=ref_losses, loss_rel_diff=max(rel),
          tol=tol, encoder_tol=enc_tol, step1_worst_rel_l2_encoder=worst[0],
          step1_worst_rel_l2_rest=worst[1], launches_per_step=want,
          step_ms=times["kernels"], unfused_tail_step_ms=times["unfused_tail"],
          plain_step_ms=times["plain"], clips_per_s=clips["kernels"],
          unfused_tail_clips_per_s=clips["unfused_tail"],
          plain_clips_per_s=clips["plain"],
          peak_mem_gib_both_models=peak_gb)
    k5_names = ("partials_kernel", "combine_kernel", "apply_kernel",
                "apply_vec_kernel", "dy_kernel")
    profile_phase("frames_train_profile",
                  lambda: step(state, batches[0], 2), calls=1, watch=k5_names)
    profile_phase("frames_unfused_profile",
                  lambda: unfused_step(state, batches[0], 2), calls=1)
    return want


def frames_slice_phase(label="frames_slice", rows_list=(1, 8, 3, 5, 2, 7),
                       **flags):
    """The full-width frames model (seeded random weights, eval mode; cfg
    `flags` over the defaults) behind the HTTP server: requests of
    `rows_list` rows of uint8 frames at 256^2, checked against the plain
    separator (the LSTM scan) at relative L2 1e-4. Eval mode runs K1-fwd
    once a window and no K5; under --frames_encode full the trunk runs once
    a batch (not a kernel of the port)."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.exp.export import (
        make_serving_fn,
        random_serving_inputs,
        serving_input_specs,
    )
    from maavss_tpu_torch.exp.serving import (
        BatchingExecutor,
        SeparationClient,
        SeparationServer,
    )
    from maavss_tpu_torch.ops.cuda_lstm import lstm_recurrence
    from maavss_tpu_torch.ops.stft import stft_features
    from maavss_tpu_torch.train.setup import build_frames_model

    batch, tol = 8, 1e-4
    cfg = RunConfig(batch_size=batch, **flags)
    model = build_frames_model(cfg, batch, generator=torch.Generator()
                               .manual_seed(cfg.seed))
    ref = build_frames_model(cfg, batch, generator=torch.Generator()
                             .manual_seed(cfg.seed + 1))
    ref.load_state_dict(model.state_dict())
    ref.lstm.backend = "scan"
    serve = make_serving_fn(model, cfg, frames_model=True)
    serve_ref = _plain_k4(make_serving_fn(ref, cfg, frames_model=True))
    a_spec, v_spec = serving_input_specs(cfg, batch, frames_model=True)
    rows_list = list(rows_list)
    requests = [random_serving_inputs(cfg, rows, frames_model=True,
                                      seed=200 + i)
                for i, rows in enumerate(rows_list)]
    dev = [torch.from_numpy(x).cuda()
           for x in random_serving_inputs(cfg, batch, frames_model=True)]
    serve(*dev)
    torch.cuda.synchronize()
    direct_ms = cuda_ms(lambda: serve(*dev), reps=3, iters=3)
    direct_plain_ms = cuda_ms(lambda: serve_ref(*dev), reps=3, iters=3)
    executor = BatchingExecutor(serve, batch, a_spec, v_spec, "cuda",
                                max_wait_ms=5.0)
    server = SeparationServer(executor, {"model": "frames", "batch": batch},
                              host="127.0.0.1", port=0).start()
    host, port = server.address
    client = SeparationClient(f"http://{host}:{port}")
    counters = (lstm_recurrence,) + _epilogue_counters() + (stft_features,)
    for c in counters:
        c.launches = 0
    responses, lat_ms = [], []
    try:
        for audio, frames in requests:
            t = time.perf_counter()
            responses.append(client.separate(audio, frames))
            lat_ms.append((time.perf_counter() - t) * 1e3)
        launches = [c.launches for c in counters]
        stats = client.get_json("/stats")
    finally:
        client.close()
        server.stop()
    batches = stats["batches"]
    if launches != [batches * cfg.num_seq, 0, 0, 0, 0, batches] \
            or batches < 1:
        raise SystemExit(f"{label} launches {launches} for "
                         f"{batches} batches of {cfg.num_seq} windows")
    worst = 0.0
    for (audio, frames), out in zip(requests, responses):
        rows = audio.shape[0]
        if out.shape != audio.shape or not np.all(np.isfinite(out)):
            raise SystemExit(f"{label}: bad response {out.shape}")
        pad_a = np.zeros(a_spec.shape, a_spec.dtype)
        pad_v = np.zeros(v_spec.shape, v_spec.dtype)
        pad_a[:rows], pad_v[:rows] = audio, frames
        exp = serve_ref(torch.from_numpy(pad_a).cuda(),
                        torch.from_numpy(pad_v).cuda())[:rows].cpu().numpy()
        worst = max(worst, _rel_l2(out, exp))
    if worst > tol:
        raise SystemExit(f"{label}: served audio vs plain separator rel "
                         f"L2 {worst} > {tol}")
    lat = sorted(lat_ms)
    phase(label, **flags, requests=len(requests), rows=rows_list,
          batches=batches, rel_l2_vs_plain=worst, tol=tol,
          p50_ms=statistics.median(lat),
          p90_ms=lat[min(len(lat) - 1, int(0.9 * len(lat)))],
          direct_batch8_ms=direct_ms, direct_batch8_plain_ms=direct_plain_ms,
          lstm_launches=launches[0], stft_launches=launches[5])
    return {"lstm_fwd": launches[0], "stft": launches[5]}


def frames_golden_phase():
    """The small-geometry JAX frames fixture through the kernels, with
    MAAVSS_S2D_MIN_HW as the fixture was made (stages 0 and 1 on K5): the
    separator's audio at relative L2 1e-4, 3 train steps' losses at relative
    1e-4, the final leaf sums within 1e-4 of each leaf's absolute sum."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.convert import (
        flatten_tree,
        from_flax,
        random_flax_tree,
        to_flax,
        unflatten_tree,
    )
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.ops.cuda_epilogue import epilogue_bwd_dy
    from maavss_tpu_torch.ops.cuda_lstm import lstm_recurrence
    from maavss_tpu_torch.train.infer import make_frames_separator
    from maavss_tpu_torch.train.setup import build_frames_state
    from maavss_tpu_torch.train.steps import make_frames_step

    tol = 1e-4
    with np.load(FRAMES_GOLDEN) as z:
        meta = json.loads(str(z["meta"]))
        want_audio = z["audio_out"]
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    for path, total in meta["checksums"].items():
        if not np.isclose(float(flat[path].astype(np.float64).sum()), total,
                          rtol=1e-6, atol=1e-6):
            raise SystemExit(f"frames golden weights do not regenerate: "
                             f"{path}")
    tree = unflatten_tree(flat)
    cfg = RunConfig(**meta["cfg"])
    os.environ["MAAVSS_S2D_MIN_HW"] = str(meta["s2d_min_hw"])
    try:
        model, state = build_frames_state(cfg, cfg.batch_size,
                                          latent_channels=meta["latent"])
        model.load_state_dict(from_flax(tree["params"],
                                        tree["batch_stats"]))
        batch = synthetic_av_batch(cfg, cfg.batch_size,
                                   seed=meta["batch_seed"],
                                   frame_size=cfg.framesize)
        noise = np.random.default_rng(meta["frames_noise_seed"])
        noise = noise.standard_normal(batch["frames"].shape)
        batch["frames"] = np.clip(batch["frames"] + meta["frames_noise"]
                                  * noise.astype(np.float32), 0.0, 1.0)
        dev = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        before = (lstm_recurrence.launches, epilogue_bwd_dy.launches)
        audio = make_frames_separator(model, cfg)(dev)["audio_out"]
        audio = audio.cpu().numpy()
        err = _rel_l2(audio, want_audio)
        if audio.shape != want_audio.shape or err > tol:
            raise SystemExit(f"frames golden audio rel L2 {err} > {tol}")
        step = make_frames_step(model, cfg)
        losses = []
        for _ in meta["losses"]:
            state, m = step(state, dev, meta["mode"])
            losses.append(float(m["loss"]))
    finally:
        os.environ.pop("MAAVSS_S2D_MIN_HW")
    after = (lstm_recurrence.launches, epilogue_bwd_dy.launches)
    if not all(a > b for a, b in zip(after, before)):
        raise SystemExit("the frames golden run did not go through K1 and K5")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, meta["losses"]))
    if rel > tol:
        raise SystemExit(f"frames golden losses {losses} vs JAX "
                         f"{meta['losses']}: rel {rel} > {tol}")
    params, stats = to_flax(model.state_dict())
    got = flatten_tree({"params": params, "batch_stats": stats})
    worst = 0.0
    for path, (total, abs_total) in meta["sums"].items():
        d = abs(float(got[path].astype(np.float64).sum()) - total)
        worst = max(worst, d / max(abs_total, 1e-12))
        if d > tol * abs_total + 1e-7:
            raise SystemExit(f"frames golden leaf {path}: sum off by {d}")
    phase("frames_golden", cfg=meta["cfg"], audio_rel_l2_vs_jax=err,
          losses=losses, jax_losses=meta["losses"], loss_rel_diff=rel,
          worst_leaf_sum_rel=worst, leaves=len(meta["sums"]), tol=tol)


class _Count:
    """A launch counter kept in attribute `attr` of `obj`, read and reset
    through `.launches` as the wrappers' own counters are."""

    def __init__(self, obj, attr):
        self.obj, self.attr = obj, attr

    @property
    def launches(self):
        return getattr(self.obj, self.attr)

    @launches.setter
    def launches(self, value):
        setattr(self.obj, self.attr, value)


K4_NAMES = ("mask_mul", "magphase", "polar", "mask_head", "mask_head_bwd",
            "stft")


def _k4_counters():
    """The counters of K4_NAMES: the standalone mask product and magphase,
    the polar kernel, the fused head forward and backward, the STFT."""
    from maavss_tpu_torch.ops import cuda_complex as cc
    from maavss_tpu_torch.ops.cuda_mask_head import mask_head_apply
    from maavss_tpu_torch.ops.stft import stft_features

    return (cc.mask_mul, cc.magphase_fwd, cc.polar_spectrum_fwd,
            mask_head_apply, _Count(mask_head_apply, "bwd_launches"),
            stft_features)


def _plain_k4(fn, kernel_features=False):
    """`fn` run with K4's plain versions (forward and explicit backward) in
    place of its kernels: the mask head of both models (the fused head, or
    under --dtype bfloat16 the standalone mask product), the STFT features
    (unless `kernel_features`: the --use_polar gates feed both sides the
    STFT kernel's features, since the sign of a real bin's rounding-noise
    imaginary part, a phase of +pi or -pi, differs between cuFFT and the
    kernel; k4_stft holds the kernel against its plain version with phases
    wrapped) and the polar kernel before the iSTFT."""
    from maavss_tpu_torch.models import fusion, fusion_frames
    from maavss_tpu_torch.ops import cuda_complex as cc
    from maavss_tpu_torch.ops import stft
    from maavss_tpu_torch.ops.cuda_mask_head import mask_head_apply_plain
    from maavss_tpu_torch.train import steps

    swaps = ((fusion, "mask_head_apply", mask_head_apply_plain),
             (fusion_frames, "mask_head_apply", mask_head_apply_plain),
             (fusion, "complex_mask_apply", cc.complex_mask_apply_plain),
             (fusion_frames, "complex_mask_apply",
              cc.complex_mask_apply_plain),
             (stft, "polar_to_spectrum", cc.polar_to_spectrum_plain))
    if not kernel_features:
        swaps += ((steps, "stft_features", stft.stft_features_plain),)

    def run(*args):
        kept = [getattr(mod, name) for mod, name, _ in swaps]
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        try:
            return fn(*args)
        finally:
            for (mod, name, _), k in zip(swaps, kept):
                setattr(mod, name, k)
    return run


# (the tensor an operand is sliced from, the slice along T) at the two
# flagships: the fusion window of the clip's STFT (T 96, window 64 at hop
# 16 of the 2nd window) and the frames model's middle-frame columns of its
# window (T 64, frame 1 of 8 hops); the whole clip for magphase and polar
K4_MASK = (((8, 2, 96, 128), slice(16, 80)), ((8, 2, 64, 129), slice(8, 16)))
K4_CLIP = ((8, 2, 96, 128), (8, 2, 96, 129))


def _k4_special(x, g):
    """x with the cases a kernel must not get wrong: exact zeros (both
    planes), negative real parts with imaginary parts +0.0 and -0.0 (atan2's
    branch cut: +pi and -pi), and phases of exactly +-pi and +-0."""
    import torch

    u = torch.rand(x.shape[:-3] + x.shape[-2:], device="cuda", generator=g)
    re, im = x[..., 0, :, :], x[..., 1, :, :]
    re[u < 0.1] = 0.0
    im[u < 0.1] = 0.0
    cut = (u >= 0.1) & (u < 0.3)
    re[cut] = -re[cut].abs() - 0.01
    im[cut & (u < 0.2)] = 0.0
    im[cut & (u >= 0.2)] = -0.0
    im[(u >= 0.3) & (u < 0.35)] = math.pi
    im[(u >= 0.35) & (u < 0.4)] = -math.pi
    return x


def k4_phase():
    """K4's three kernels against their plain versions at the flagships'
    shapes (K4_MASK, K4_CLIP), each on gaussian data and on `_k4_special`
    data through strided (sliced) operands, the mask product forward and
    in conjugate mode (its backward). Tolerance relative L2 1e-6 (each
    product and sum is rounded as the plain version rounds it; atan2f,
    sqrtf and sincosf against PyTorch's CUDA functions); the branch-cut
    bins' phases must equal +-pi exactly, by the sign of the zero. Times
    (gaussian, main-path layout) are median of 5 x 20 calls; bound = the
    bytes each call must move over 3.35 TB/s; torch.polar timed beside the
    polar kernel. The polar kernel's main-path form writes the complex
    spectrum the iSTFT reads (the fusion clip's with a zero Nyquist bin, the
    frames clip's as it is): polar_to_rect, its real view in planar order,
    must hold its values bit for bit; its row times that form, as
    torch.polar writes interleaved complex."""
    import torch

    from maavss_tpu_torch.ops.cuda_complex import (
        magphase_fwd,
        magphase_fwd_plain,
        mask_mul,
        mask_mul_plain,
        polar_fwd_plain,
        polar_spectrum_fwd,
        polar_spectrum_fwd_plain,
        polar_to_rect,
    )

    g = torch.Generator(device="cuda").manual_seed(9)
    tol = 1e-6
    rep = {n: dict(err=0.0, ms=0.0, plain_ms=0.0, bytes=0, flops=0,
                   library_ms=None, device_ms=0.0, host_ms=0.0)
           for n in ("mask_mul", "magphase", "polar")}

    def account(name, kernel, plain, n_bytes, flops, lib=None):
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        r = rep[name]
        dev_ms, host_ms = split_ms(kernel)
        r["device_ms"] += dev_ms
        r["host_ms"] += host_ms
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bytes"] += n_bytes
        r["flops"] += flops
        if lib is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + cuda_ms(lib)
        return ms, plain_ms

    for full, win in K4_MASK:
        for special in (False, True):
            x = torch.randn(full, device="cuda", generator=g)
            m_full = torch.randn(full, device="cuda", generator=g)
            if special:
                x, m_full = _k4_special(x, g), _k4_special(m_full, g)
            a = x[:, :, win]  # strided, as the models read it
            # the mask is the head's contiguous output; the special case
            # reads a strided slice
            b = m_full[:, :, win] if special else m_full[:, :, win].clone()
            gr = torch.randn(a.shape, device="cuda", generator=g)
            where = f"{tuple(a.shape)} {'special' if special else 'gaussian'}"
            errs = []
            for args in ((a, b, False), (gr, a, True)):
                got, want = mask_mul(*args), mask_mul_plain(*args)
                torch.cuda.synchronize()
                errs.append(_rel_check(f"K4 mask_mul conj={args[2]} {where}",
                                       got, want, tol))
            rep["mask_mul"]["err"] = max(rep["mask_mul"]["err"], *errs)
            times = {}
            if not special:
                n_bytes = 3 * a.numel() * 4
                times["fwd"] = account(
                    "mask_mul", lambda: mask_mul(a, b),
                    lambda: mask_mul_plain(a, b), n_bytes, 3 * a.numel())
                times["conj"] = (cuda_ms(lambda: mask_mul(gr, a, True)),
                                 cuda_ms(lambda: mask_mul_plain(gr, a, True)))
            phase("k4_mask_mul", shape=list(a.shape), special=special,
                  operand_strides=list(a.stride()), max_abs_err=errs[0],
                  max_abs_err_conj=errs[1], tol_rel_l2=tol,
                  **({"ms": times["fwd"][0], "plain_ms": times["fwd"][1],
                      "conj_ms": times["conj"][0],
                      "conj_plain_ms": times["conj"][1],
                      "bound_ms": bound_ms(3 * a.numel() * 4,
                                           3 * a.numel())[0]}
                     if times else {}))

    for shape in K4_CLIP:
        for special in (False, True):
            big = (shape[0], 2, shape[2] + 8, shape[3])
            x = torch.randn(big if special else shape, device="cuda",
                            generator=g)
            if special:
                x = _k4_special(x, g)[:, :, 4:4 + shape[2]]  # strided
            where = f"{shape} {'special' if special else 'gaussian'}"
            pad = 1 if shape[3] == 128 else 0  # fusion trims Nyquist
            mp, mp_p = magphase_fwd(x), magphase_fwd_plain(x)
            rt, rt_p = polar_to_rect(x), polar_fwd_plain(x)
            sp = polar_spectrum_fwd(x, pad)
            sp_p = polar_spectrum_fwd_plain(x, pad)
            torch.cuda.synchronize()
            e_mp = _rel_check(f"K4 magphase {where}", mp, mp_p, tol)
            e_rt = max(_rel_check(f"K4 polar {where}", rt, rt_p, tol),
                       _rel_check(f"K4 polar spectrum {where}",
                                  torch.view_as_real(sp),
                                  torch.view_as_real(sp_p), tol))
            f_in = shape[3]
            if not torch.equal(torch.view_as_real(sp[..., :f_in]),
                               torch.stack([rt[:, 0], rt[:, 1]], dim=-1)) \
                    or bool(sp[..., f_in:].any()):
                raise SystemExit(f"K4 polar spectrum is not the planar "
                                 f"form bit for bit (pad {pad}) at {where}")
            n_cut = 0
            if special:
                re, im = x[:, 0], x[:, 1]
                cut = (im == 0) & (re < 0)
                want = torch.where(torch.signbit(im[cut]), -math.pi,
                                   math.pi).float()
                for what, ph in (("kernel", mp[:, 1]), ("plain", mp_p[:, 1])):
                    if not torch.equal(ph[cut], want):
                        raise SystemExit(f"K4 magphase {what}: the branch-cut"
                                         f" phases are not +-pi at {where}")
                zero = (re == 0) & (im == 0)
                if not bool((mp[:, 0][zero] == 0).all()):
                    raise SystemExit(f"K4 magphase |0| != 0 at {where}")
                n_cut = int(cut.sum())
            rep["magphase"]["err"] = max(rep["magphase"]["err"], e_mp)
            rep["polar"]["err"] = max(rep["polar"]["err"], e_rt)
            fields = {}
            if not special:
                n_bytes = 2 * x.numel() * 4
                t_mp = account("magphase", lambda: magphase_fwd(x),
                               lambda: magphase_fwd_plain(x), n_bytes,
                               5 * x.numel() // 2)
                t_rt = account("polar", lambda: polar_spectrum_fwd(x, pad),
                               lambda: polar_spectrum_fwd_plain(x, pad),
                               x.numel() * 4 + sp.numel() * 8, 2 * x.numel(),
                               lib=lambda: torch.polar(x[:, 0], x[:, 1]))
                fields = dict(magphase_ms=t_mp[0], magphase_plain_ms=t_mp[1],
                              polar_spectrum_ms=t_rt[0],
                              polar_spectrum_plain_ms=t_rt[1],
                              polar_to_rect_ms=cuda_ms(
                                  lambda: polar_to_rect(x)),
                              nyquist_pad=pad,
                              bound_ms=bound_ms(n_bytes, 5 * x.numel() // 2)[0])
            phase("k4_polar", shape=list(shape), special=special,
                  operand_strides=list(x.stride()), branch_cut_bins=n_cut,
                  max_abs_err_magphase=e_mp, max_abs_err_polar=e_rt,
                  tol_rel_l2=tol, **fields)
    for r in rep.values():
        r["bound"] = bound_ms(r["bytes"], r["flops"])
    phase("k4", mask_shapes=[[s[0], 2, w.stop - w.start, s[3]]
                             for s, w in K4_MASK],
          clip_shapes=[list(s) for s in K4_CLIP],
          **{n: {k: v for k, v in r.items() if k not in ("bytes", "flops")}
             for n, r in rep.items()})
    return rep


# (M, frames family): the fusion head at one row, a scan window's batch,
# the vectorized windows' batch and bench.py's batch, and the frames head
K4_HEAD = ((1, False), (8, False), (32, False), (256, False), (8, True))
K4_HEAD_MAIN = ((8, False), (8, True))  # the main path's shapes


def _head_inputs(m, frames_model, g):
    """(h, W, b or None, stft view, cotangent) of the --mask_head head at
    the flagship's widths: K 512; the fusion window (rows 16:80 of the
    clip's [m, 2, 96, 128] STFT, 2P = 16384, a bias) or the frames model's
    middle-frame columns (rows 8:16 of [m, 2, 64, 129], 2P = 2064, no
    bias)."""
    import torch

    full, win = K4_MASK[1 if frames_model else 0]
    full = (m,) + full[1:]
    t, f = win.stop - win.start, full[3]
    h = torch.randn(m, 512, device="cuda", generator=g)
    w = torch.randn(2 * t * f, 512, device="cuda", generator=g) / 512 ** 0.5
    b = None if frames_model else 0.1 * torch.randn(2 * t * f, device="cuda",
                                                    generator=g)
    clip = torch.randn(full, device="cuda", generator=g)
    gr = torch.randn((m, 2, t, f), device="cuda", generator=g)
    return h, w, b, clip[:, :, win], gr


def _head_graph_bits(where, fwd, bwd, first):
    """One forward and one backward wrapper call captured in a
    torch.cuda.CUDAGraph and replayed three times give `first`'s bits."""
    import torch

    def run():
        out, _ = fwd()
        return (out,) + tuple(x for x in bwd() if x is not None)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        _same_bits(f"{where}: a CUDA graph replay", [captured], [first])


def k4_head_phase():
    """The fused --mask_head head (csrc/mask_head.cu) against its plain
    version (F.linear, then the plain mask product, under autograd) at
    K4_HEAD's shapes: the output and d_h, dW, db at relative L2 1e-5 (fp32
    dot products of 512 terms forward, 16384 terms for d_h, summed in
    another order than cuBLAS'); two calls and a CUDA-graph replay give the
    same bits. Times of the forward and the backward against the plain
    version's, the bound (bytes: h, W, b, the STFT window and the output
    forward; g, the STFT, h and W in, d_h, dW and db out backward;
    operations: 2 M K 2P FMAs each), cuBLAS' addmm (mm without a bias)
    alone as the library call, and the route it replaces, addmm and the
    standalone K4 mask product (two launches), and that route's backward
    (K4's conjugate product, two cuBLAS products and the bias sum),
    beside. The main-path shapes
    (K4_HEAD_MAIN) are summed into the kernels line's entries."""
    import torch

    from maavss_tpu_torch.ops import cuda_complex as cc
    from maavss_tpu_torch.ops import cuda_mask_head as cmh

    g = torch.Generator(device="cuda").manual_seed(12)
    tol = 1e-5
    rep = {n: dict(err=0.0, ms=0.0, plain_ms=0.0, bytes=0, flops=0,
                   library_ms=None, device_ms=0.0, host_ms=0.0)
           for n in ("fwd", "bwd")}
    for m, frames_model in K4_HEAD:
        h, w, b, stft, gr = _head_inputs(m, frames_model, g)
        where = f"K4 head M={m} {'frames' if frames_model else 'fusion'}"
        leaves = [x.clone().requires_grad_(True) for x in (h, w, b)
                  if x is not None]

        def grads(fn):
            args = [x.detach().clone().requires_grad_(True) for x in leaves]
            hh, ww = args[0], args[1]
            bb = args[2] if b is not None else None
            out = fn(hh, ww, bb, stft)
            out.backward(gr)
            return [out.detach()] + [x.grad for x in args]

        got, again = grads(cmh.mask_head_apply), grads(cmh.mask_head_apply)
        want = grads(cmh.mask_head_apply_plain)
        torch.cuda.synchronize()
        _same_bits(f"{where}: a second call", [got], [again])
        errs = [_rel_check(f"{where} {name}", x, y, tol)
                for name, x, y in zip(("out", "d_h", "dW", "db"), got, want)]
        has_b = b is not None
        fwd = lambda: cmh.mask_head_fwd(h, w, b, stft)  # noqa: E731
        bwd = lambda: cmh.mask_head_bwd(gr, h, w, stft, has_b)  # noqa: E731
        _head_graph_bits(where, fwd, bwd, got)
        p2 = w.shape[0]
        n_fwd = nbytes(h, w, stft, got[0]) + (nbytes(b) if has_b else 0)
        n_bwd = nbytes(gr, stft, h, w, *got[1:])
        flops = 2 * m * h.shape[1] * p2
        lib = ((lambda: torch.addmm(b, h, w.t())) if has_b
               else (lambda: torch.mm(h, w.t())))
        two = lambda: cc.mask_mul(stft, lib().view(gr.shape))  # noqa: E731

        def old_bwd():
            """The replaced route's backward: K4 in conjugate mode, then
            cuBLAS' two products and the bias reduction."""
            d_mask = cc.mask_mul(gr, stft, conj=True).view(m, -1)
            return (d_mask.mm(w), d_mask.t().mm(h),
                    d_mask.sum(0) if has_b else None)
        t = dict(
            fwd_ms=cuda_ms(fwd),
            fwd_plain_ms=cuda_ms(
                lambda: cmh.mask_head_fwd_plain(h, w, b, stft)),
            bwd_ms=cuda_ms(bwd),
            bwd_plain_ms=cuda_ms(
                lambda: cmh.mask_head_bwd_plain(gr, h, w, stft, has_b)),
            addmm_ms=cuda_ms(lib), addmm_then_mask_mul_ms=cuda_ms(two),
            replaced_bwd_ms=cuda_ms(old_bwd))
        dev = dict(zip(("fwd", "bwd"), (split_ms(fwd), split_ms(bwd))))
        lib_dev, _ = split_ms(lib)
        t.update(addmm_then_mask_mul_device_ms=split_ms(two)[0],
                 replaced_bwd_device_ms=split_ms(old_bwd)[0])
        bounds = {"fwd": bound_ms(n_fwd, flops),
                  "bwd": bound_ms(n_bwd, 2 * flops)}
        if (m, frames_model) in K4_HEAD_MAIN:
            for n, nb, fl in (("fwd", n_fwd, flops), ("bwd", n_bwd,
                                                       2 * flops)):
                r = rep[n]
                r["err"] = max(r["err"], *errs)
                r["ms"] += t[f"{n}_ms"]
                r["plain_ms"] += t[f"{n}_plain_ms"]
                r["device_ms"] += dev[n][0]
                r["host_ms"] += dev[n][1]
                r["bytes"] += nb
                r["flops"] += fl
            rep["fwd"]["library_ms"] = ((rep["fwd"]["library_ms"] or 0.0)
                                        + t["addmm_ms"])
        phase("k4_head", m=m, family="frames" if frames_model else "fusion",
              k=h.shape[1], out_cols=p2, bias=has_b,
              stft_strides=list(stft.stride()), max_abs_err=dict(
                  zip(("out", "d_h", "dW", "db"), errs)), tol_rel_l2=tol,
              same_bits_two_calls=True, same_bits_graph_replay=True, **t,
              fwd_device_ms=dev["fwd"][0], fwd_host_ms=dev["fwd"][1],
              bwd_device_ms=dev["bwd"][0], bwd_host_ms=dev["bwd"][1],
              addmm_device_ms=lib_dev,
              fwd_bound_ms=bounds["fwd"][0], fwd_bound_by=bounds["fwd"][1],
              bwd_bound_ms=bounds["bwd"][0], bwd_bound_by=bounds["bwd"][1])
    for r in rep.values():
        r["bound"] = bound_ms(r["bytes"], r["flops"])
    phase("k4_head_main", shapes=[list(s) for s in K4_HEAD_MAIN],
          **{n: {k: v for k, v in r.items() if k not in ("bytes", "flops")}
             for n, r in rep.items()})
    return rep


def _wrapped_phase_err(ph, ph_ref, mag_ref):
    """(max |wrapped phase difference| * magnitude / max magnitude, max
    |wrapped difference| on bins above 1e-3 of the largest magnitude)."""
    import torch

    d = torch.remainder(ph.double() - ph_ref.double() + math.pi,
                        2 * math.pi) - math.pi
    top = mag_ref.max().clamp(min=1e-30)
    keep = mag_ref > 1e-3 * top
    return ((d.abs() * mag_ref).max() / top).item(), \
        (d[keep].abs().max().item() if bool(keep.any()) else 0.0)


def _kernel_names(fn, attempts: int = 1, until=bool):
    """The names (namespace, template arguments and parameters cut) of the
    device kernels one call of `fn` runs, from torch.profiler with CPU and
    CUDA activities, as profile_phase traces. The profiler can drop device
    events: a profile whose names fail `until` is taken again, up to
    `attempts` profiles. Returns (names, profiles taken)."""
    import torch
    from torch.autograd import DeviceType

    from maavss_tpu_torch.exp.profiling import trace

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with tempfile.TemporaryDirectory() as d, trace(d) as prof:
            fn()
        names = set()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.count:
                name = re.search(r"(\w+)(<[^(]*)?\(", e.key)
                names.add(name.group(1) if name else e.key[:40])
        if until(names):
            break
    return names, attempt


def _graph_nodes(fn):
    """The nodes of a CUDA graph that captures one call of `fn` (two calls
    first on the capture's stream), read from the CUDA runtime's DOT dump
    of the graph (cudaGraphDebugDotPrint), not from the profiler: a list
    of (node type, kernel's mangled name or None)."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        err = ctypes.CDLL("libcudart.so.12").cudaGraphDebugDotPrint(
            ctypes.c_void_p(graph.raw_cuda_graph()), path.encode(),
            ctypes.c_uint(1))  # cudaGraphDebugDotFlagsVerbose
        if err:
            raise SystemExit(f"cudaGraphDebugDotPrint returned {err}")
        with open(path) as f:
            dot = f.read()
    nodes = []
    for label in re.findall(r'label="\{(.*?)"\];', dot, re.S):
        kind = re.match(r"\w+", label).group(0)
        name = re.search(r"\(topoId: \d+\) \| (\S+?)\\<", label)
        nodes.append((kind, name.group(1) if name else None))
    return nodes


def _no_rfft_kernels(what, counts):
    """Raise if a profile's kernels ({name: launches}) hold a cuFFT
    real-to-complex kernel: in a train step only the forward STFT's rfft
    would run one (the phasegram's fft2 runs complex-to-complex kernels),
    and the STFT kernel does that transform."""
    rfft = {k: n for k, n in counts.items()
            if "fft" in k.lower() and "r2c" in k.lower()}
    if rfft:
        raise SystemExit(f"{what}: cuFFT's rfft ran in the forward STFT: "
                         f"{rfft}")


def _polar_features_close(what, cfg, audio, frames_model):
    """The STFT kernel's polar features of `audio` against
    stft_features_plain: magnitudes at relative L2 1e-6, phases as wrapped
    differences weighted by magnitude within 1e-5 of the largest; returns
    the measured values."""
    from maavss_tpu_torch.ops.stft import stft_features, stft_features_plain

    args = (audio, cfg.fft_len, cfg.hop, cfg.normalize_fft, not frames_model,
            True)
    got, want = stft_features(*args), stft_features_plain(*args)
    mag_err = _rel_check(f"{what} features: magnitude", got[:, 0],
                         want[:, 0], 1e-6)
    weighted, top_bins = _wrapped_phase_err(got[:, 1], want[:, 1], want[:, 0])
    if weighted > 1e-5:
        raise SystemExit(f"{what} features: phase error weighted by "
                         f"magnitude {weighted} > 1e-5")
    return dict(mag_max_abs_err=mag_err, phase_err_weighted=weighted,
                phase_err_bins_above_1e3_of_max=top_bins)


# (fft_len, hop, samples): the tests' geometry, the flagships' (T 96) and
# the kernel's largest fft_len
K4_STFT = ((64, 16, 16 * 96), (256, 66, 66 * 96), (2048, 512, 512 * 24))


def k4_stft_phase():
    """The STFT kernel (csrc/stft_feat.cu) against stft_features_plain
    (cuFFT's rfft) at K4_STFT's geometries, batch 8, trim_end on and off,
    normalized on and off, (re, im) and polar, on gaussian audio and on
    special audio (all zeros; a constant, DC-only signal). (re, im) at
    relative L2 1e-6 and the DC bin's (and, untrimmed, the Nyquist bin's)
    imaginary part exactly 0; polar: magnitudes at relative L2 1e-6, phases
    as wrapped differences weighted by magnitude within 1e-5 of the largest
    (the first frame is real: its phases of +pi or -pi follow the FFT's
    rounding noise); zero audio gives exact zeros. Times at the flagships'
    (re, im) features (fusion trimmed, frames untrimmed) against the plain
    version and torch.stft (the complex spectrum alone, the window given)
    as the library call; bound = (audio + features) bytes over 3.35 TB/s
    against the FFT's operations."""
    import torch

    from maavss_tpu_torch.ops.stft import (
        stft_features,
        stft_features_plain,
        stft_kernel_refusal,
    )
    from maavss_tpu_torch.ops.windows import hamming_window

    g = torch.Generator(device="cuda").manual_seed(13)
    tol = 1e-6
    rep = dict(err=0.0, ms=0.0, plain_ms=0.0, bytes=0, flops=0,
               library_ms=0.0, device_ms=0.0, host_ms=0.0)
    worst = dict(rect_rel_l2=0.0, phase_err_weighted=0.0)
    for n, hop, samples in K4_STFT:
        if stft_kernel_refusal(n, hop, samples) is not None:
            raise SystemExit(f"k4_stft geometry {n, hop, samples} refused")
        gauss = torch.randn(8, samples, device="cuda", generator=g)
        data = {"gaussian": gauss,
                "zeros": torch.zeros(8, samples, device="cuda"),
                "dc": torch.full((8, samples), 0.25, device="cuda")}
        for kind, audio in data.items():
            for trim in (True, False):
                for normalized in (True, False):
                    args = (audio, n, hop, normalized, trim)
                    where = (f"K4 stft N={n} {kind} trim={trim} "
                             f"normalized={normalized}")
                    got = stft_features(*args)
                    want = stft_features_plain(*args)
                    mp = stft_features(*args, polar=True)
                    torch.cuda.synchronize()
                    if kind == "zeros":
                        if bool(got.any()) or bool(mp[:, 0].any()):
                            raise SystemExit(f"{where}: zero audio gave "
                                             f"non-zero features")
                        continue
                    err = _rel_check(f"{where} (re, im)", got, want, tol)
                    d = got.double() - want.double()
                    rel = (torch.linalg.vector_norm(d) / torch.linalg
                           .vector_norm(want.double())).item()
                    worst["rect_rel_l2"] = max(worst["rect_rel_l2"], rel)
                    rep["err"] = max(rep["err"], err)
                    zero_bins = [0] + ([] if trim else [n // 2])
                    if bool(got[:, 1, :, zero_bins].any()):
                        raise SystemExit(f"{where}: the DC / Nyquist bins' "
                                         f"imaginary parts are not 0")
                    mag = want.square().sum(1).sqrt()
                    _rel_check(f"{where} magnitude", mp[:, 0], mag, tol)
                    ph_ref = torch.atan2(want[:, 1], want[:, 0])
                    weighted, top = _wrapped_phase_err(mp[:, 1], ph_ref, mag)
                    if weighted > 1e-5:
                        raise SystemExit(f"{where}: phase error weighted by "
                                         f"magnitude {weighted} > 1e-5")
                    worst["phase_err_weighted"] = max(
                        worst["phase_err_weighted"], weighted)
            if kind == "gaussian":
                fields = {}
                for trim in (True, False):
                    args = (audio, n, hop, True, trim)
                    out = stft_features(*args)
                    window = hamming_window(n, device="cuda")
                    kernel = lambda: stft_features(*args)  # noqa: E731
                    lib = lambda: torch.stft(  # noqa: E731
                        audio, n, hop, window=window, center=True,
                        pad_mode="reflect", return_complex=True)
                    t = dict(ms=cuda_ms(kernel),
                             plain_ms=cuda_ms(
                                 lambda: stft_features_plain(*args)),
                             polar_ms=cuda_ms(
                                 lambda: stft_features(*args, polar=True)),
                             polar_plain_ms=cuda_ms(
                                 lambda: stft_features_plain(*args,
                                                             polar=True)),
                             library_ms=cuda_ms(lib))
                    dev_ms, host_ms = split_ms(kernel)
                    frames = out.shape[0] * out.shape[2]
                    half = n // 2
                    n_bytes = nbytes(audio, out)
                    flops = frames * (n + 5 * half * math.log2(half)
                                      + 12 * out.shape[-1])
                    key = "trim" if trim else "untrimmed"
                    fields[key] = dict(t, device_ms=dev_ms, host_ms=host_ms,
                                       bound_ms=bound_ms(n_bytes, flops)[0],
                                       shape=list(out.shape))
                    if n == 256:  # the flagships: fusion trims, frames not
                        for k in ("ms", "plain_ms", "library_ms"):
                            rep[k] += t[k]
                        rep["device_ms"] += dev_ms
                        rep["host_ms"] += host_ms
                        rep["bytes"] += n_bytes
                        rep["flops"] += flops
                phase("k4_stft", fft_len=n, hop=hop, samples=samples,
                      batch=8, **fields)
    rep["bound"] = bound_ms(rep["bytes"], rep["flops"])
    # which device kernels each route runs. From a CUDA graph of one call:
    # the kernel route is one node, the STFT kernel; the plain route runs
    # cuFFT's real-to-complex transform and not the STFT kernel. From the
    # profiler (whose names _no_rfft_kernels reads): the plain route's
    # rfft is named *fft*r2c*, and the kernel route lists no other kernel.
    # The profiler drops device events at times (once every event of both
    # routes), so the plain route's profile is taken up to 3 times.
    audio = torch.randn(8, 66 * 96, device="cuda", generator=g)

    def r2c(names):
        return any("fft" in k.lower() and "r2c" in k.lower() for k in names)

    routes, profiles, graphs = {}, {}, {}
    for name, fn, until, attempts in (
            ("kernel", stft_features, bool, 1),
            ("plain", stft_features_plain, r2c, 3)):
        call = lambda fn=fn: fn(audio, 256, 66)  # noqa: E731
        names, profiles[name] = _kernel_names(call, attempts, until)
        routes[name] = sorted(names)
        graphs[name] = _graph_nodes(call)
    kernel_nodes = graphs["kernel"]
    plain_names = [n for kind, n in graphs["plain"] if kind == "KERNEL"]
    if (len(kernel_nodes) != 1 or kernel_nodes[0][0] != "KERNEL"
            or "stft_feat_kernel" not in (kernel_nodes[0][1] or "")
            or not r2c(plain_names)
            or any("stft_feat_kernel" in n for n in plain_names)):
        raise SystemExit(f"k4_stft: graph nodes by route {graphs}")
    if not set(routes["kernel"]) <= {"stft_feat_kernel"} or not r2c(
            routes["plain"]):
        raise SystemExit(f"k4_stft: device kernels by route {routes} "
                         f"(profiles taken {profiles})")
    graph_nodes = {"kernel": kernel_nodes,
                   "plain": dict(nodes=len(graphs["plain"]),
                                 kernels=len(plain_names),
                                 r2c=[n for n in plain_names if r2c([n])])}
    phase("k4_stft_checks", geometries=[list(x) for x in K4_STFT],
          data=["gaussian", "zeros", "dc"], tol_rel_l2=tol,
          phase_tol_weighted=1e-5, **worst, device_kernels=routes,
          profiles_taken=profiles, graph_nodes=graph_nodes,
          main={k: v for k, v in rep.items() if k not in ("bytes", "flops")})
    return rep


def _fusion_counters():
    from maavss_tpu_torch.ops.cuda_adam import adam_multi_tensor
    from maavss_tpu_torch.ops.cuda_lstm import (
        lstm_recurrence,
        lstm_recurrence_bwd,
    )
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_bwd, pgenc_train

    return (("lstm_fwd", "lstm_bwd", "pgenc_train", "pgenc_bwd", "adam",
             *K4_NAMES),
            (lstm_recurrence, lstm_recurrence_bwd, pgenc_train, pgenc_bwd,
             adam_multi_tensor, *_k4_counters()))


def _frames_counters():
    from maavss_tpu_torch.ops.cuda_adam import adam_multi_tensor
    from maavss_tpu_torch.ops.cuda_lstm import (
        lstm_recurrence,
        lstm_recurrence_bwd,
    )

    return (("lstm_fwd", "lstm_bwd", "adam", "epilogue_stats",
             "epilogue_apply", "epilogue_bwd_reduce", "epilogue_bwd_dy",
             *K4_NAMES),
            (lstm_recurrence, lstm_recurrence_bwd, adam_multi_tensor,
             *_epilogue_counters(), *_k4_counters()))


def _plain_cfg(cfg, frames_model: bool, k2_plain: bool = True):
    """cfg of the plain versions: the plain Adam formula, and ConvStack in
    place of K2 for the fusion model unless `k2_plain` is False."""
    if frames_model or not k2_plain:
        return cfg.replace(opt_kernel="xla")
    return cfg.replace(pgenc_kernel="xla", opt_kernel="xla")


def _train_pair(cfg, frames_model: bool, k2_plain: bool = True,
                kernel_features: bool = False, make_step=None,
                trainable=None):
    """(model, state, step, ref, ref_state, ref_step) at batch 8: the
    flagship of `cfg` with every kernel, and the plain versions from the same
    state_dict (ConvStack unless `k2_plain` is False, the LSTM scan, the
    plain Adam formula, K5's and K4's plain versions; the STFT kernel's
    features on both sides with `kernel_features`). `make_step` (default
    the family's train step) is the step factory of train/steps.py to run;
    `trainable` (top-level module prefixes) the staged freeze of both
    optimizers."""
    import torch

    from maavss_tpu_torch.train import setup
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step

    if frames_model:
        build_state, build = setup.build_frames_state, setup.build_frames_model
        make_step = make_step or make_frames_step
        extra = {}
    else:
        build_state, build = setup.build_fusion_state, setup.build_fusion
        make_step = make_step or make_fusion_step
        extra = dict(trainable=trainable)
    plain_cfg = _plain_cfg(cfg, frames_model, k2_plain)
    model, state = build_state(cfg, cfg.batch_size, device="cuda",
                               generator=torch.Generator().manual_seed(
                                   cfg.seed), **extra)
    ref = build(plain_cfg, cfg.batch_size, device="cuda",
                generator=torch.Generator().manual_seed(cfg.seed + 1))
    ref.load_state_dict(model.state_dict())
    ref.lstm.backend = "scan"
    ref_state = create_train_state(ref, plain_cfg, "cuda",
                                   trainable=trainable)
    ref_step = _plain_k4(make_step(ref, plain_cfg, device="cuda"),
                         kernel_features)
    if frames_model:
        ref_step = _plain_k5(ref_step)
    return (model, state, make_step(model, cfg, device="cuda"), ref,
            ref_state, ref_step)


def _grab_step1_grads(state, model):
    """A dict that the next optimizer update of `state` fills with a copy
    of every parameter's gradient, by state_dict name, before it updates."""
    grads = {}
    update = state.tx.step

    def grab_then_update():
        grads.update({n: p.grad.detach().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
        del state.tx.step  # the optimizer's own method again
        update()

    state.tx.step = grab_then_update
    return grads


def _plain_twin(cfg, ref, frames_model, k2_plain=True,
                kernel_features=False, make_step=None, trainable=None):
    """(model, state, grads, step): the plain versions once more, from
    `ref`'s state_dict (as `_train_pair` builds them), with the dict that
    their next update fills with the step-1 gradients (`_grab_step1_grads`)."""
    import torch

    from maavss_tpu_torch.train import setup
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step

    plain_cfg = _plain_cfg(cfg, frames_model, k2_plain)
    build = setup.build_frames_model if frames_model else setup.build_fusion
    alt = build(plain_cfg, cfg.batch_size, device="cuda",
                generator=torch.Generator().manual_seed(0))
    alt.load_state_dict(ref.state_dict())
    alt.lstm.backend = "scan"
    alt_state = create_train_state(alt, plain_cfg, "cuda",
                                   trainable=trainable)
    grads = _grab_step1_grads(alt_state, alt)
    make_step = make_step or (make_frames_step if frames_model
                              else make_fusion_step)
    step = _plain_k4(make_step(alt, plain_cfg, device="cuda"),
                     kernel_features)
    if frames_model:
        step = _plain_k5(step)
    return alt, alt_state, grads, step


def _reordered_step1_grads(cfg, ref, batch, frames_model, k2_plain=True,
                           kernel_features=False, make_step=None,
                           trainable=None):
    """The step-1 gradients of the plain versions once more, from `ref`'s
    state_dict, on `batch` with its rows in reverse order and with the
    batch statistics of every TorchBatchNorm summed in fp64 (under
    --microbatch the rows reversed within each chunk): the same
    gradients in exact arithmetic, every sum over the batch (weight
    gradients, the loss) taken in another fp32 order, and the statistics,
    whose E[x^2] - E[x]^2 cancels digits, without their fp32 rounding. How
    far these stand from the plain versions' is how far the rounding of one
    correct fp32 step moves its gradients."""
    import numpy as np
    import torch

    from maavss_tpu_torch.models import layers

    _, alt_state, grads, step = _plain_twin(cfg, ref, frames_model, k2_plain,
                                            kernel_features, make_step,
                                            trainable)

    def bn_fp64(self, x):
        bn = self.BatchNorm_0
        if not self.training:
            return bn_fp32(self, x)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        axes = (0,) + tuple(range(2, x.ndim))
        x64 = x.double()
        mean = x64.mean(dim=axes)
        var = torch.clamp((x64 * x64).mean(dim=axes) - mean * mean, min=0.0)
        mean, var = mean.float(), var.float()
        layers.update_running_stats(bn, mean, var)
        mul = bn.weight * torch.rsqrt(var + self.EPS)
        return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)

    def reverse_rows(v):
        # within each --microbatch chunk, so that every chunk's BatchNorm
        # sees the same rows
        v = np.asarray(v)
        chunks = v.reshape((cfg.microbatch, -1) + v.shape[1:])
        return np.ascontiguousarray(chunks[:, ::-1].reshape(v.shape))

    bn_fp32 = layers.TorchBatchNorm.forward
    layers.TorchBatchNorm.forward = bn_fp64
    try:
        step(alt_state, {k: reverse_rows(v) for k, v in batch.items()}, 2)
    finally:
        layers.TorchBatchNorm.forward = bn_fp32
    torch.cuda.synchronize()
    return grads


def _step1_close(what, model, ref, grads, ref_grads, lr, tol, enc_tol,
                 alt_grads, grad_rms_max=None, fed_by_gradient=False,
                 params_only=False):
    """The leaves after step 1, kernels (`model`) against plain (`ref`):
    each at relative L2 `tol` (enc_tol None: the fusion model, whose conv
    biases that feed a train-mode BatchNorm move within lr of each other)
    or as `_frames_params_close` (the visual encoder's leaves at enc_tol),
    and one more way for a leaf to pass. Adam's first step moves each element
    by lr * g / (|g| + 1e-8), so a leaf whose gradient holds elements near 0
    (a BatchNorm shift ahead of LeakyReLU, a conv and another train-mode
    BatchNorm is a near-total cancellation) carries those elements' last
    digits into its parameters whole. Such a leaf passes if its gradient
    agrees at the leaf's tolerance and each element ends no further from
    the plain one than Adam's first step makes of the gradients'
    difference: lr * |g - g_ref| / (min(|g|, |g_ref|) + 1e-8), at most 2 lr
    (plus 1e-6 of the parameter and of lr for rounding). Where a leaf's
    gradient is a near-total cancellation (PERF.md, Findings) the fp32 order
    of its sums alone moves it: its gradient may then differ by up to
    twice the spread of the plain step against itself with its batch
    statistics in fp64 and the batch in reverse row order (`alt_grads`,
    `_reordered_step1_grads`). With `grad_rms_max`, only a leaf whose
    plain step-1 gradient has an rms under it may pass by its gradient.
    With `fed_by_gradient`, a conv bias that feeds a train-mode BatchNorm
    (true gradient 0: its gradient is the rounding noise of a cancelling
    sum, and where that noise reaches Adam's eps the two steps can move it
    apart by up to 2 lr, Adam's first step in opposite directions) and
    differs by more than lr may also pass by its gradient.
    With `params_only`, the parameters alone (not BatchNorm's running
    statistics). Returns the worst relative L2s and the leaves that passed
    by their gradients."""
    import torch

    fed = set() if enc_tol is not None else set(model.bn_fed_biases())
    if params_only:
        sd, sd_ref = ({n: p.detach() for n, p in m.named_parameters()}
                      for m in (model, ref))
    else:
        sd, sd_ref = model.state_dict(), ref.state_dict()
    worst = {"step1_worst_rel_l2": 0.0}
    if enc_tol is None:
        worst["step1_worst_bn_fed_bias_abs"] = 0.0
    else:
        worst["step1_worst_rel_l2_encoder"] = 0.0
    by_grads = []

    def rel_l2(a, b):
        return (torch.linalg.vector_norm(a - b)
                / torch.linalg.vector_norm(b).clamp(min=1e-12)).item()

    for k, v in sd.items():
        a, b = v.float(), sd_ref[k].float()
        if k in fed:
            d = (a - b).abs().max().item()
            worst["step1_worst_bn_fed_bias_abs"] = max(
                worst["step1_worst_bn_fed_bias_abs"], d)
            if d <= lr * 1.0001:
                continue
            if not fed_by_gradient:
                raise SystemExit(f"{what}: {k} differs by {d} > lr {lr}")
        enc = enc_tol is not None and k.startswith("visual_encoder.")
        limit = enc_tol if enc else tol
        rel = rel_l2(a, b)
        if rel <= limit:
            key = "step1_worst_rel_l2_encoder" if enc else "step1_worst_rel_l2"
            worst[key] = max(worst[key], rel)
            continue
        if k not in grads:
            raise SystemExit(f"{what}: {k} rel L2 {rel} > {limit} after "
                             f"step 1")
        g, g_ref = grads[k].float(), ref_grads[k].float()
        g_rms = g_ref.square().mean().sqrt().item()
        if grad_rms_max is not None and g_rms >= grad_rms_max:
            raise SystemExit(f"{what}: {k} rel L2 {rel} > {limit} after "
                             f"step 1 (its gradient's rms {g_rms} is not "
                             f"under {grad_rms_max})")
        g_rel = rel_l2(g, g_ref)
        spread = rel_l2(alt_grads[k].float(), g_ref)
        g_limit = max(limit, 2 * spread)
        step_lim = torch.clamp(lr * (g - g_ref).abs()
                               / (torch.minimum(g.abs(), g_ref.abs()) + 1e-8),
                               max=2 * lr)
        excess = ((a - b).abs() - step_lim * 1.0001
                  - 1e-6 * (b.abs() + lr)).max().item()
        if g_rel > g_limit or excess > 0:
            raise SystemExit(f"{what}: {k} rel L2 {rel} > {limit} after step "
                             f"1; its gradient's rel L2 {g_rel} (limit "
                             f"{g_limit}, the plain step's own spread "
                             f"{spread}), elements past Adam's step of the "
                             f"gradient difference by up to {excess}")
        by_grads.append({"leaf": k, "param_rel_l2": rel,
                         "grad_rel_l2": g_rel, "plain_spread": spread,
                         "min_abs_grad": g_ref.abs().min().item(),
                         "grad_rms": g_rms})
    worst["step1_passed_by_gradient"] = by_grads
    return worst


def _train_vs_plain(what, cfg, frames_model, want, steps=3, timed=(),
                    k2_plain=True, kernel_features=False, profile=None,
                    fed_by_gradient=False, make_step=None, trainable=None,
                    time_plain=False):
    """`steps` steps of the flagship of `cfg` (mode 2) with every kernel
    against the plain versions from one state_dict: exact launch counts per
    step (`want`, by counter name; the plain run launches none but K2's
    when `k2_plain` is False and the STFT kernel's with `kernel_features`),
    per-step losses at relative 1e-4, the leaves after step 1 as
    `_step1_close`. The batches are synthetic frames, or under
    --pgram_cache their float16 phasegram rows. Then the step times, in
    turns, of the kernel step and of each (label, fn, state) of `timed`, and
    with `profile` a torch.profiler breakdown of one kernel step under that
    label. `make_step` and `trainable` as `_train_pair` takes them; under
    `trainable` every frozen leaf must end the steps on both sides with
    the bits it started with. `time_plain` times the plain step in the
    same turns."""
    import torch

    from maavss_tpu_torch.data.synthetic import (
        synthetic_av_batch,
        with_pgram_rows,
    )

    lr, tol, enc_tol = cfg.learning_rate, 1e-4, 2e-3
    model, state, step, ref, ref_state, ref_step = _train_pair(
        cfg, frames_model, k2_plain, kernel_features, make_step, trainable)
    frozen = ({n: p.detach().clone() for (n, p), t in zip(
        model.named_parameters(), state.tx.trainable) if not t}
        if trainable else {})
    names, counters = _frames_counters() if frames_model \
        else _fusion_counters()
    want = {n: want.get(n, 0) for n in names}
    frame_size = cfg.framesize if frames_model else None
    batches = [synthetic_av_batch(cfg, cfg.batch_size, seed=cfg.seed + i,
                                  frame_size=frame_size)
               for i in range(steps)]
    if cfg.pgram_cache and not frames_model:
        batches = [with_pgram_rows(b, "cuda") for b in batches]

    def run(fn, st, batch):
        for c in counters:
            c.launches = 0
        st, metrics = fn(st, batch, 2)
        torch.cuda.synchronize()
        return st, metrics, dict(zip(names, (c.launches for c in counters)))

    losses, ref_losses, worst = [], [], None
    grads = [_grab_step1_grads(st, mod) for st, mod in ((state, model),
                                                         (ref_state, ref))]
    alt_grads = _reordered_step1_grads(cfg, ref, batches[0], frames_model,
                                       k2_plain, kernel_features, make_step,
                                       trainable)
    for i, batch in enumerate(batches):
        state, m, launches = run(step, state, batch)
        if launches != want:
            raise SystemExit(f"{what} step {i + 1}: launches {launches} != "
                             f"{want}")
        ref_state, rm, ref_launches = run(ref_step, ref_state, batch)
        if not k2_plain:
            for n in ("pgenc_train", "pgenc_bwd"):
                ref_launches[n] -= want[n]
        if kernel_features:
            ref_launches["stft"] -= want["stft"]
        if any(ref_launches.values()):
            raise SystemExit(f"{what}: the plain step launched kernels: "
                             f"{ref_launches}")
        losses.append(float(m["loss"]))
        ref_losses.append(float(rm["loss"]))
        if i == 0:
            worst = _step1_close(what, model, ref, *grads, lr, tol,
                                 enc_tol if frames_model else None,
                                 alt_grads, fed_by_gradient=fed_by_gradient)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    if max(rel) > tol or not all(map(math.isfinite, losses)):
        raise SystemExit(f"{what} losses {losses} vs plain {ref_losses}: "
                         f"rel {rel} > {tol}")
    moved = [n for mod in (model, ref) for n, p in mod.named_parameters()
             if n in frozen and not torch.equal(p.detach(), frozen[n])]
    if moved:
        raise SystemExit(f"{what}: frozen leaves moved in {steps} steps: "
                         f"{moved[:8]} ({len(moved)} in all)")
    times = {}
    turns = (("kernels", step, state),) + tuple(timed)
    if time_plain:
        turns += (("plain", ref_step, ref_state),)
    for _ in range(2 if len(turns) > 1 else 1):
        for label, fn, st in turns:
            times.setdefault(label, []).append(
                cuda_ms(lambda: fn(st, batches[0], 2), reps=3, iters=1))
    if profile:
        _no_rfft_kernels(what, profile_phase(
            profile, lambda: step(state, batches[0], 2), calls=1))
    out = dict(batch=cfg.batch_size, mode=2, lr=lr, steps=steps,
               losses=losses, plain_losses=ref_losses, loss_rel_diff=max(rel),
               tol=tol, launches_per_step=want, **worst)
    if trainable:
        out.update(trainable=list(trainable), frozen_leaves=len(frozen),
                   frozen_unchanged=True)
    for label, ms in times.items():
        key = "step_ms" if label == "kernels" else f"{label}_step_ms"
        out[key] = ms
        out[key.replace("step_ms", "clips_per_s")] = (
            cfg.batch_size / (min(ms) / 1e3))
    return out


def mask_train_phase():
    """--mask_head at full width: the fusion flagship (batch 8, scan
    windows, mode 2, lr 1e-3, noise 0) and the frames flagship, 3 steps
    each with every kernel against the plain versions from one state_dict,
    under the gates of the train and frames_train phases. The STFT input of
    the mask is data, so each window launches the fused head once forward
    and once backward (d_h, dW, db; no d_stft) and the standalone mask
    product never; the STFT kernel runs once a step. The fusion step with
    the default head (a model of the same width and seed) is timed in turns
    beside."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.train.setup import build_fusion_state
    from maavss_tpu_torch.train.steps import make_fusion_step

    ns = RunConfig().num_seq
    cfg = RunConfig(batch_size=8, noise_scalar=0.0, learning_rate=1e-3,
                    mask_head=True)
    default_cfg = cfg.replace(mask_head=False)
    default, default_state = build_fusion_state(
        default_cfg, 8, "cuda", torch.Generator().manual_seed(cfg.seed))
    fusion = _train_vs_plain(
        "mask_train fusion", cfg, False,
        dict(lstm_fwd=ns, lstm_bwd=ns, pgenc_train=10 * ns,
             pgenc_bwd=10 * ns, adam=1, mask_head=ns, mask_head_bwd=ns,
             stft=1),
        timed=(("default_head", make_fusion_step(default, default_cfg,
                                                 device="cuda"),
                default_state),), profile="mask_train_profile")
    del default, default_state
    os.environ.pop("MAAVSS_S2D_MIN_HW", None)  # the default, 128
    frames = _train_vs_plain(
        "mask_train frames", cfg, True,
        dict(lstm_fwd=ns, lstm_bwd=ns, adam=1, epilogue_stats=2 * ns,
             epilogue_apply=2 * ns, epilogue_bwd_reduce=2 * ns,
             epilogue_bwd_dy=2 * ns, mask_head=ns, mask_head_bwd=ns, stft=1))
    phase("mask_train", fusion=fusion, frames=frames)
    return {n: fusion["launches_per_step"][n] + frames["launches_per_step"][n]
            for n in K4_NAMES}


def _serve_pair(cfg, frames_model: bool, kernel_features: bool = False):
    """(serve, serve_ref, model) at batch 8: the serving function of the
    flagship of `cfg` with every kernel, and of the plain versions from the
    same state_dict (the STFT kernel's features with `kernel_features`)."""
    import torch

    from maavss_tpu_torch.exp.export import make_serving_fn
    from maavss_tpu_torch.train.setup import build_frames_model, build_fusion

    build = build_frames_model if frames_model else build_fusion
    plain_cfg = cfg if frames_model else cfg.replace(pgenc_kernel="xla")
    model = build(cfg, cfg.batch_size, device="cuda",
                  generator=torch.Generator().manual_seed(cfg.seed))
    ref = build(plain_cfg, cfg.batch_size, device="cuda",
                generator=torch.Generator().manual_seed(cfg.seed + 1))
    ref.load_state_dict(model.state_dict())
    ref.lstm.backend = "scan"
    return (make_serving_fn(model, cfg, frames_model),
            _plain_k4(make_serving_fn(ref, plain_cfg, frames_model),
                      kernel_features), model)


def mask_slice_phase():
    """The full-width fusion model with --mask_head (seeded random weights)
    behind the HTTP server: 8 requests of 1..8 rows against the plain
    separator (the plain versions of K1, K2 and K4) at relative L2 1e-4;
    the fused head reads each window of the clip's STFT in place, one
    launch per window of every batch, and the STFT kernel runs once a
    batch."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.exp.export import (
        random_serving_inputs,
        serving_input_specs,
    )
    from maavss_tpu_torch.exp.serving import (
        BatchingExecutor,
        SeparationClient,
        SeparationServer,
    )

    batch, tol = 8, 1e-4
    cfg = RunConfig(batch_size=batch, mask_head=True)
    serve, serve_ref, _ = _serve_pair(cfg, False)
    a_spec, v_spec = serving_input_specs(cfg, batch)
    rng = np.random.default_rng(8)
    rows_list = [1, 8, 3, 5, 2, 8, 4, 7]
    requests = []
    for i, rows in enumerate(rows_list):
        audio, _ = random_serving_inputs(cfg, rows, seed=400 + i)
        frames = rng.uniform(0, 1, (rows,) + v_spec.shape[1:]).astype(
            np.float32)
        requests.append((audio, frames))
    dev = [torch.from_numpy(x).cuda() for x in random_serving_inputs(cfg, batch)]
    serve(*dev)
    torch.cuda.synchronize()
    direct_ms = cuda_ms(lambda: serve(*dev), reps=3, iters=5)
    direct_plain_ms = cuda_ms(lambda: serve_ref(*dev), reps=3, iters=5)
    executor = BatchingExecutor(serve, batch, a_spec, v_spec, "cuda",
                                max_wait_ms=5.0)
    server = SeparationServer(executor, {"model": "fusion", "batch": batch,
                                         "mask_head": True},
                              host="127.0.0.1", port=0).start()
    host, port = server.address
    client = SeparationClient(f"http://{host}:{port}")
    names, counters = _fusion_counters()
    for c in counters:
        c.launches = 0
    responses, lat_ms = [], []
    try:
        for audio, frames in requests:
            t = time.perf_counter()
            responses.append(client.separate(audio, frames))
            lat_ms.append((time.perf_counter() - t) * 1e3)
        launches = dict(zip(names, (c.launches for c in counters)))
        stats = client.get_json("/stats")
    finally:
        client.close()
        server.stop()
    batches = stats["batches"]
    if (batches < 1 or launches["mask_head"] != batches * cfg.num_seq
            or launches["lstm_fwd"] != batches * cfg.num_seq
            or launches["stft"] != batches or launches["mask_head_bwd"]
            or launches["mask_mul"] or launches["magphase"]
            or launches["polar"]):
        raise SystemExit(f"mask_slice launches {launches} for {batches} "
                         f"batches of {cfg.num_seq} windows")
    worst = 0.0
    for (audio, frames), out in zip(requests, responses):
        rows = audio.shape[0]
        if out.shape != audio.shape or not np.all(np.isfinite(out)):
            raise SystemExit(f"bad mask_slice response {out.shape}")
        pad_a = np.zeros(a_spec.shape, np.float32)
        pad_v = np.zeros(v_spec.shape, np.float32)
        pad_a[:rows], pad_v[:rows] = audio, frames
        exp = serve_ref(torch.from_numpy(pad_a).cuda(),
                        torch.from_numpy(pad_v).cuda())[:rows].cpu().numpy()
        worst = max(worst, _rel_l2(out, exp))
    if worst > tol:
        raise SystemExit(f"mask_slice audio vs plain separator rel L2 "
                         f"{worst} > {tol}")
    lat = sorted(lat_ms)
    phase("mask_slice", requests=len(requests), rows=rows_list,
          batches=batches, rel_l2_vs_plain=worst, tol=tol,
          p50_ms=statistics.median(lat),
          p90_ms=lat[min(len(lat) - 1, int(0.9 * len(lat)))],
          direct_batch8_ms=direct_ms, direct_batch8_plain_ms=direct_plain_ms,
          launches=launches)
    return launches


def _istft_polar_extra(cfg):
    """What istft_features(polar=True) runs beyond the iSTFT of the
    spectrum itself, at the fusion flagship's clip ([8, 2, 96, 128]
    features, Nyquist trimmed): ({aten op: count} from torch.profiler over
    one call of each after a warm-up, the polar kernel's launches per
    call)."""
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile

    from maavss_tpu_torch.ops import cuda_complex as cc
    from maavss_tpu_torch.ops.stft import istft, istft_features

    g = torch.Generator(device="cuda").manual_seed(10)
    feats = torch.randn(8, 2, 96, cfg.fft_len // 2, device="cuda",
                        generator=g)
    spec = cc.polar_to_spectrum(feats, 1)
    length = 96 * cfg.hop

    def ops(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        return Counter({e.key: e.count for e in prof.key_averages()
                        if e.key.startswith("aten::")})

    before = cc.polar_spectrum_fwd.launches
    full = ops(lambda: istft_features(
        feats, cfg.fft_len, cfg.hop, normalized=cfg.normalize_fft,
        trim_end=True, polar=True, length=length))
    launches = (cc.polar_spectrum_fwd.launches - before) / 2
    base = ops(lambda: istft(spec, cfg.fft_len, cfg.hop,
                             normalized=cfg.normalize_fft, length=length))
    return dict(full - base), launches


def polar_phase():
    """--use_polar at full width: 3 fusion train steps and 3 frames train
    steps (the polar features from the STFT kernel once per step, no
    standalone magphase) with every kernel against the plain versions,
    under the gates of `_train_vs_plain`; then the serving function of each
    family (the STFT kernel on the clip, the polar kernel before the iSTFT,
    once per call) against the plain versions at relative L2 1e-4. Both
    sides take the STFT kernel's features (`_plain_k4`): the clip's first
    frame is real, and the sign of its rounding-noise imaginary parts, a
    phase of +pi or -pi, is the FFT's own; each family's features are held
    against stft_features_plain here with phases wrapped, as in k4_stft.
    The fusion steps run K2 on both sides: under this loss the step-1 gradients of both encoders move by up
    to ~3e-4 when the phasegram latent moves by the ~3e-6 that K2 and
    ConvStack differ by in fp32, and the plain step fed K2's latent moves
    the same (tools/polar_grad_probe.py); K2 is held against ConvStack in
    the k2_train and train phases."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.exp.export import random_serving_inputs

    ns = RunConfig().num_seq
    cfg = RunConfig(batch_size=8, noise_scalar=0.0, learning_rate=1e-3,
                    use_polar=True)
    fusion = _train_vs_plain(
        "polar fusion train", cfg, False,
        dict(lstm_fwd=ns, lstm_bwd=ns, pgenc_train=10 * ns,
             pgenc_bwd=10 * ns, adam=1, stft=1), k2_plain=False,
        kernel_features=True)
    os.environ.pop("MAAVSS_S2D_MIN_HW", None)
    frames = _train_vs_plain(
        "polar frames train", cfg, True,
        dict(lstm_fwd=ns, lstm_bwd=ns, adam=1, epilogue_stats=2 * ns,
             epilogue_apply=2 * ns, epilogue_bwd_reduce=2 * ns,
             epilogue_bwd_dy=2 * ns, stft=1), kernel_features=True)
    served, tol = {}, 1e-4
    launches = {n: fusion["launches_per_step"][n]
                + frames["launches_per_step"][n] for n in K4_NAMES}
    for frames_model in (False, True):
        family = "frames" if frames_model else "fusion"
        serve, serve_ref, _ = _serve_pair(cfg.replace(noise_scalar=0.0),
                                          frames_model, kernel_features=True)
        inputs = [torch.from_numpy(x).cuda() for x in random_serving_inputs(
            cfg, 8, frames_model, seed=500)]
        for c in _k4_counters():
            c.launches = 0
        got = serve(*inputs)
        torch.cuda.synchronize()
        counts = dict(zip(K4_NAMES, (c.launches for c in _k4_counters())))
        if counts != dict(mask_mul=0, magphase=0, polar=1, mask_head=0,
                          mask_head_bwd=0, stft=1):
            raise SystemExit(f"polar {family} serving: K4 launches {counts} "
                             f"!= one polar and one STFT launch")
        for n in K4_NAMES:
            launches[n] += counts[n]
        feats = _polar_features_close(f"polar {family}", cfg, inputs[0],
                                      frames_model)
        got = got.cpu().numpy()
        want = serve_ref(*inputs).cpu().numpy()
        err = _rel_l2(got, want)
        if got.shape != want.shape or not np.all(np.isfinite(got)) \
                or err > tol:
            raise SystemExit(f"polar {family} served audio vs plain rel L2 "
                             f"{err} > {tol}")
        served[family] = dict(
            rel_l2_vs_plain=err, tol=tol, k4_launches=counts, features=feats,
            direct_batch8_ms=cuda_ms(lambda: serve(*inputs), reps=3,
                                     iters=3),
            direct_batch8_plain_ms=cuda_ms(lambda: serve_ref(*inputs),
                                           reps=3, iters=3))
    extra_ops, extra_launches = _istft_polar_extra(cfg)
    copies = {"aten::complex", "aten::pad", "aten::constant_pad_nd",
              "aten::contiguous", "aten::clone", "aten::copy_"}
    if extra_launches != 1 or copies & set(extra_ops):
        raise SystemExit(f"istft_features(polar=True) runs the polar kernel "
                         f"{extra_launches} times per call and the ops "
                         f"{extra_ops} beyond the iSTFT: want one launch "
                         f"and no copy")
    phase("polar", fusion_train=fusion, frames_train=frames, serving=served,
          istft_polar_extra_ops=extra_ops,
          istft_polar_launches_per_call=extra_launches)
    return launches


STFT_ROUTE_FFT_LEN = 4096  # refused by the STFT kernel; the fusion plan
# reaches its latent from its 2048 bins


def stft_route_phase(steps: int = 3):
    """--fft_len 4096, which the STFT kernel refuses: `stft_route` sends
    the STFT to cuFFT (the plain framing and rfft) and, under --use_polar,
    magnitude and phase to K4's standalone magphase kernel. 3 fusion train
    steps (scan windows, fp32, batch 8, noise 0, lr 1e-3) of the default
    head and of --use_polar, each against the plain versions from one
    state_dict under `_train_vs_plain`'s gates (the polar steps run K2 on
    both sides, as the polar phase does). At 2048 bins the STFT encoder's
    BatchNorm-fed conv biases carry gradient noise at Adam's eps, so one
    of them may also pass by its gradient (`fed_by_gradient`); then one
    separator batch of each
    against the plain separator at relative L2 1e-4. Each counts no STFT
    kernel launch, and exactly one magphase launch a polar step or batch.
    The STFT kernel's launcher itself refuses fft_len 4096. The magphase
    kernel is held against its plain version and timed on the features it
    gets here."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.exp.export import random_serving_inputs
    from maavss_tpu_torch.ops import _build, stft
    from maavss_tpu_torch.ops.cuda_complex import (
        magphase_fwd,
        magphase_fwd_plain,
    )

    n = STFT_ROUTE_FFT_LEN
    ns = RunConfig().num_seq
    base = RunConfig(batch_size=8, noise_scalar=0.0, learning_rate=1e-3,
                     fft_len=n)
    audio = torch.from_numpy(synthetic_av_batch(
        base, 8, seed=base.seed)["audio"]).cuda()  # the train step's clip
    samples = audio.shape[-1]
    if stft.stft_route(n, base.hop, samples) != "fft":
        raise SystemExit(f"stft_route takes fft_len {n} to the kernel")
    window, tw, norm = stft._stft_tables(n, audio.device)
    t_len = samples // base.hop
    out = torch.empty(8, 2, t_len, n // 2, device="cuda")
    try:
        _build.launch("maavss_stft_feat", audio.device, (
            audio.data_ptr(), samples, 8, samples, n, base.hop, t_len,
            n // 2, window.data_ptr(), tw.data_ptr(), norm, 0,
            out.data_ptr()))
    except RuntimeError as e:
        refused = str(e)
    else:
        raise SystemExit(f"the STFT kernel took fft_len {n}")
    result = {"kernel_refuses": refused}
    launches = dict.fromkeys(K4_NAMES, 0)
    for polar in (False, True):
        label = "polar" if polar else "rect"
        cfg = base.replace(use_polar=polar)
        res = _train_vs_plain(
            f"stft_route {label} train", cfg, False,
            dict(lstm_fwd=ns, lstm_bwd=ns, pgenc_train=10 * ns,
                 pgenc_bwd=10 * ns, adam=1, magphase=int(polar)),
            steps=steps, k2_plain=not polar, fed_by_gradient=True)
        serve, serve_ref, _ = _serve_pair(cfg, False)
        inputs = [torch.from_numpy(x).cuda() for x in random_serving_inputs(
            cfg, 8, False, seed=600)]
        for c in _k4_counters():
            c.launches = 0
        got = serve(*inputs)
        torch.cuda.synchronize()
        counts = dict(zip(K4_NAMES, (c.launches for c in _k4_counters())))
        if counts != dict(mask_mul=0, magphase=int(polar), polar=int(polar),
                          mask_head=0, mask_head_bwd=0, stft=0):
            raise SystemExit(f"stft_route {label} serving: K4 launches "
                             f"{counts}")
        got = got.cpu().numpy()
        want = serve_ref(*inputs).cpu().numpy()
        err = _rel_l2(got, want)
        if got.shape != want.shape or not np.all(np.isfinite(got)) \
                or err > 1e-4:
            raise SystemExit(f"stft_route {label} served audio vs plain rel "
                             f"L2 {err} > 1e-4")
        for k in K4_NAMES:
            launches[k] += res["launches_per_step"][k] + counts[k]
        result[label] = dict(train=res, serving_rel_l2_vs_plain=err,
                             serving_k4_launches=counts)
    feats = stft.stft_features(audio, n, base.hop)
    got, want = magphase_fwd(feats), magphase_fwd_plain(feats)
    torch.cuda.synchronize()
    rep = dict(err=_rel_check("magphase on the fft route's features", got,
                              want, 1e-6),
               ms=cuda_ms(lambda: magphase_fwd(feats)),
               plain_ms=cuda_ms(lambda: magphase_fwd_plain(feats)),
               bound=bound_ms(2 * feats.numel() * 4, 5 * feats.numel() // 2),
               library_ms=None)
    rep["device_ms"], rep["host_ms"] = split_ms(lambda: magphase_fwd(feats))
    phase("stft_route", fft_len=n, route="fft", steps=steps, **result,
          magphase_shape=list(feats.shape),
          magphase={k: v for k, v in rep.items()})
    return launches, rep


def k4_golden_phase():
    """The small-geometry JAX fixture tests/fixtures/torch_port_k4_golden.npz
    through the kernels: the fusion --mask_head separator's audio and 3
    train steps (losses at relative 1e-4, leaf sums within 1e-4 of each
    leaf's absolute sum, the conv biases that feed a train-mode BatchNorm
    and their running means left out), and the fusion --use_polar
    separator's audio, each at relative L2 1e-4. The JAX side ran its
    complex-mask and polar Pallas kernels (interpret mode). The polar
    separator takes the fixture's JAX features in place of its own: the
    clip's first frame is real (even-symmetric after reflect padding), and
    the sign of its rounding-noise imaginary parts, so a phase of +pi or
    -pi, differs between FFTs (tests/test_torch_k4.py); the STFT kernel's
    polar features are held against their plain version in the k4_stft and
    polar phases."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.convert import (
        flatten_tree,
        from_flax,
        random_flax_tree,
        to_flax,
        unflatten_tree,
    )
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.train import steps
    from maavss_tpu_torch.train.infer import make_separator
    from maavss_tpu_torch.train.setup import build_fusion, build_fusion_state

    tol = 1e-4
    with np.load(K4_GOLDEN) as z:
        meta = json.loads(str(z["meta"]))
        want_mask, want_polar = z["audio_mask"], z["audio_polar"]
        feats_polar = z["feats_polar"]
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    for path, total in meta["checksums"].items():
        if not np.isclose(float(flat[path].astype(np.float64).sum()), total,
                          rtol=1e-6, atol=1e-6):
            raise SystemExit(f"k4 golden weights do not regenerate: {path}")
    tree = unflatten_tree(flat)
    sd = from_flax(tree["params"], tree["batch_stats"])
    cfg = RunConfig(**meta["cfg"])
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=meta["batch_seed"])
    rng = np.random.default_rng(meta["noise_seed"])
    batch["frames"] = np.clip(batch["frames"] + meta["frames_noise"] *
                              rng.standard_normal(batch["frames"].shape)
                              .astype(np.float32), 0.0, 1.0)
    batch["audio"] = (batch["audio"] + meta["audio_dc"] + meta["audio_noise"]
                      * rng.standard_normal(batch["audio"].shape)
                      .astype(np.float32)).astype(np.float32)
    dev = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    for c in _k4_counters():
        c.launches = 0
    mask_cfg = cfg.replace(mask_head=True)
    model, state = build_fusion_state(mask_cfg, cfg.batch_size, "cuda")
    model.load_state_dict(sd)
    audio = make_separator(model, mask_cfg)(dev)["audio_out"].cpu().numpy()
    err_mask = _rel_l2(audio, want_mask)
    if audio.shape != want_mask.shape or err_mask > tol:
        raise SystemExit(f"k4 golden --mask_head audio rel L2 {err_mask} > "
                         f"{tol}")
    step = steps.make_fusion_step(model, mask_cfg, device="cuda")
    losses = []
    for _ in meta["losses"]:
        state, m = step(state, batch, meta["mode"])
        losses.append(float(m["loss"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, meta["losses"]))
    if rel > tol:
        raise SystemExit(f"k4 golden losses {losses} vs JAX "
                         f"{meta['losses']}: rel {rel} > {tol}")
    params, stats = to_flax(model.state_dict())
    got = flatten_tree({"params": params, "batch_stats": stats})
    worst = 0.0
    for path, (total, abs_total) in meta["sums"].items():
        d = abs(float(got[path].astype(np.float64).sum()) - total)
        worst = max(worst, d / max(abs_total, 1e-12))
        if d > tol * abs_total + 1e-7:
            raise SystemExit(f"k4 golden leaf {path}: sum off by {d}")
    polar_cfg = cfg.replace(use_polar=True)
    polar_model = build_fusion(polar_cfg, cfg.batch_size, "cuda")
    polar_model.load_state_dict(sd)
    own = steps.stft_features
    steps.stft_features = lambda *args, **kwargs: torch.from_numpy(
        feats_polar).cuda()
    try:
        audio = make_separator(polar_model, polar_cfg)(dev)["audio_out"]
    finally:
        steps.stft_features = own
    audio = audio.cpu().numpy()
    err_polar = _rel_l2(audio, want_polar)
    if audio.shape != want_polar.shape or err_polar > tol:
        raise SystemExit(f"k4 golden --use_polar audio rel L2 {err_polar} > "
                         f"{tol}")
    counts = dict(zip(K4_NAMES, (c.launches for c in _k4_counters())))
    if not (counts["mask_head"] and counts["mask_head_bwd"]
            and counts["polar"] and counts["stft"]):
        raise SystemExit(f"the k4 golden run missed a K4 kernel: {counts}")
    phase("k4_golden", cfg=meta["cfg"], mask_audio_rel_l2_vs_jax=err_mask,
          losses=losses, jax_losses=meta["losses"], loss_rel_diff=rel,
          worst_leaf_sum_rel=worst, leaves=len(meta["sums"]),
          left_out=len(meta["bn_fed"]), polar_audio_rel_l2_vs_jax=err_polar,
          k4_launches=counts, tol=tol)


FULLENC_LAYERS = 10  # the flagship phasegram encoder's layers


def _fullenc_want():
    """Launches per full-encode train step: the encoders and heads once."""
    return dict(lstm_fwd=1, lstm_bwd=1, pgenc_train=FULLENC_LAYERS,
                pgenc_bwd=FULLENC_LAYERS, adam=1, stft=1)


def _fullenc_kernel_step(cfg, loss_impl):
    """(step, state) of the kernel model of `cfg` from its seed (the init
    `_train_pair` draws), with MAAVSS_FULLENC_LOSS set to `loss_impl` while
    the step is made."""
    import torch

    from maavss_tpu_torch.train.setup import build_fusion_state
    from maavss_tpu_torch.train.steps import make_fusion_step

    model, state = build_fusion_state(
        cfg, cfg.batch_size, "cuda", torch.Generator().manual_seed(cfg.seed))
    old = os.environ.get("MAAVSS_FULLENC_LOSS")
    os.environ["MAAVSS_FULLENC_LOSS"] = loss_impl
    try:
        step = make_fusion_step(model, cfg, device="cuda")
    finally:
        if old is None:
            del os.environ["MAAVSS_FULLENC_LOSS"]
        else:
            os.environ["MAAVSS_FULLENC_LOSS"] = old
    return step, state


def fullenc_train_phase(steps: int = 3):
    """--fusion_encode full --pgram_cache, the bench's fusion regime, on
    the full-width flagship at batch 8, mode 2, lr 1e-3, noise 0: `steps`
    steps with every kernel against the plain versions from one state_dict
    under the gates of the K4 phases' steps of the same model (losses at
    relative 1e-4; the leaves after step 1 at relative L2 1e-4, or by
    their gradient as `_step1_close` lets a BatchNorm shift ahead of
    another train-mode BatchNorm pass, phasegram_encoder.TorchBatchNorm_7's
    here; the BatchNorm-fed conv biases within lr). Both
    sides take the STFT kernel's features, as the polar phase's do: the
    full-encode step's step-1 gradients move by up to 3.5e-4 between the
    kernel's features and cuFFT's, which stand 2e-7 apart, while K1 and K2
    in place of their plain versions move them by at most 8e-6
    (tools/fusion_step1_probe_torch.py, PERF.md, PR 9); the features are
    held against cuFFT's in k4_stft. Exact launch counts per step (K1-fwd,
    K1-bwd,
    K3 and the STFT kernel once, K2-train and K2-bwd once a layer), step
    times in turns with the scan window-mode step of a model of the same
    width and seed, and a torch.profiler breakdown. Then, each from the
    seeded state, one step on the frames in place of their rows, whose
    loss must be within 2^-10 relative of the rows' (twice float16's
    relative rounding of the rows, 2^-11), and one step with each loss of
    MAAVSS_FULLENC_LOSS, fold and slice, equal within 1e-6 relative; the
    two steps are timed in turns."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import (
        synthetic_av_batch,
        with_pgram_rows,
    )
    from maavss_tpu_torch.train.setup import build_fusion_state
    from maavss_tpu_torch.train.steps import make_fusion_step

    cfg = RunConfig(batch_size=8, noise_scalar=0.0, learning_rate=1e-3,
                    fusion_encode="full", pgram_cache=True)
    scan_cfg = cfg.replace(fusion_encode="window", pgram_cache=False)
    scan, scan_state = build_fusion_state(
        scan_cfg, 8, "cuda", torch.Generator().manual_seed(cfg.seed))
    out = _train_vs_plain(
        "fullenc_train", cfg, False, _fullenc_want(), steps=steps,
        timed=(("scan_window", make_fusion_step(scan, scan_cfg,
                                                device="cuda"),
                scan_state),),
        kernel_features=True, profile="fullenc_train_profile")
    del scan, scan_state
    frames = synthetic_av_batch(cfg, 8, seed=cfg.seed)
    rows = with_pgram_rows(frames, "cuda")
    first = {}
    for label, batch, loss_impl in (("rows_fold", rows, "fold"),
                                    ("rows_slice", rows, "slice"),
                                    ("frames_fold", frames, "fold")):
        step, state = _fullenc_kernel_step(cfg, loss_impl)
        state, m = step(state, batch, 2)
        first[label] = (float(m["loss"]), step, state)
    frames_rel = abs(first["frames_fold"][0] - first["rows_fold"][0]) \
        / abs(first["rows_fold"][0])
    fold_slice_rel = abs(first["rows_slice"][0] - first["rows_fold"][0]) \
        / abs(first["rows_fold"][0])
    if frames_rel > 2.0 ** -10 or fold_slice_rel > 1e-6:
        raise SystemExit(f"fullenc_train: step-1 loss from frames vs rows "
                         f"rel {frames_rel} (limit 2^-10), slice vs fold rel "
                         f"{fold_slice_rel} (limit 1e-6)")
    loss_ms = {}
    for _ in range(2):
        for label in ("rows_fold", "rows_slice"):
            _, step, state = first[label]
            loss_ms.setdefault(label, []).append(cuda_ms(
                lambda: step(state, rows, 2), reps=3, iters=1))
    del first
    phase("fullenc_train", fusion_encode="full", pgram_cache=True,
          window_mode_superseded=cfg.window_mode, **out,
          step1_loss_rel_frames_vs_rows=frames_rel,
          frames_vs_rows_tol=2.0 ** -10,
          step1_loss_rel_slice_vs_fold=fold_slice_rel,
          slice_vs_fold_tol=1e-6, fold_step_ms=loss_ms["rows_fold"],
          slice_step_ms=loss_ms["rows_slice"])
    return out["launches_per_step"]


def fullenc_slice_phase():
    """The full-width fusion model with --fusion_encode full and
    --pgram_cache behind the HTTP server: 8 requests of 1..8 rows of float16
    phasegram rows (of uniform random frames) against the plain separator
    (the plain versions of K1, K2 and the STFT) at relative L2 1e-4; each
    batch launches K1-fwd once, K2-eval once a layer and the STFT kernel
    once, and no train-mode kernel."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.exp.export import (
        random_serving_inputs,
        serving_input_specs,
    )
    from maavss_tpu_torch.exp.serving import (
        BatchingExecutor,
        SeparationClient,
        SeparationServer,
    )
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer
    from maavss_tpu_torch.ops.phasegram import phasegram_cumsum

    batch, tol = 8, 1e-4
    cfg = RunConfig(batch_size=batch, fusion_encode="full", pgram_cache=True)
    serve, serve_ref, _ = _serve_pair(cfg, False)
    a_spec, v_spec = serving_input_specs(cfg, batch)
    if v_spec.dtype != np.float16:
        raise SystemExit(f"fullenc_slice: visual spec {v_spec}")
    rng = np.random.default_rng(9)
    t_total = cfg.num_frames + cfg.num_seq
    rows_list = [1, 8, 3, 5, 2, 8, 4, 7]
    requests = []
    for i, rows in enumerate(rows_list):
        audio, _ = random_serving_inputs(cfg, rows, seed=600 + i)
        frames = rng.uniform(0, 1, (rows, t_total, cfg.p_size, cfg.p_size))
        visual = phasegram_cumsum(torch.from_numpy(frames.astype(
            np.float32)).cuda()).to(torch.float16).cpu().numpy()
        requests.append((audio, visual))
    dev = [torch.from_numpy(x).cuda() for x in random_serving_inputs(cfg, batch)]
    serve(*dev)
    torch.cuda.synchronize()
    direct_ms = cuda_ms(lambda: serve(*dev), reps=3, iters=5)
    direct_plain_ms = cuda_ms(lambda: serve_ref(*dev), reps=3, iters=5)
    executor = BatchingExecutor(serve, batch, a_spec, v_spec, "cuda",
                                max_wait_ms=5.0)
    server = SeparationServer(executor, {"model": "fusion", "batch": batch,
                                         "fusion_encode": "full",
                                         "pgram_cache": True},
                              host="127.0.0.1", port=0).start()
    host, port = server.address
    client = SeparationClient(f"http://{host}:{port}")
    names, counters = _fusion_counters()
    names, counters = names + ("pgenc_eval",), counters + (pgenc_layer,)
    for c in counters:
        c.launches = 0
    responses, lat_ms = [], []
    try:
        for audio, visual in requests:
            t = time.perf_counter()
            responses.append(client.separate(audio, visual))
            lat_ms.append((time.perf_counter() - t) * 1e3)
        launches = dict(zip(names, (c.launches for c in counters)))
        stats = client.get_json("/stats")
    finally:
        client.close()
        server.stop()
    batches = stats["batches"]
    want = {n: 0 for n in names}
    want.update(lstm_fwd=batches, pgenc_eval=batches * FULLENC_LAYERS,
                stft=batches)
    if batches < 1 or launches != want:
        raise SystemExit(f"fullenc_slice launches {launches} != {want} for "
                         f"{batches} batches")
    worst = 0.0
    for (audio, visual), out in zip(requests, responses):
        rows = audio.shape[0]
        if out.shape != audio.shape or not np.all(np.isfinite(out)):
            raise SystemExit(f"bad fullenc_slice response {out.shape}")
        pad_a = np.zeros(a_spec.shape, np.float32)
        pad_v = np.zeros(v_spec.shape, np.float16)
        pad_a[:rows], pad_v[:rows] = audio, visual
        exp = serve_ref(torch.from_numpy(pad_a).cuda(),
                        torch.from_numpy(pad_v).cuda())[:rows].cpu().numpy()
        worst = max(worst, _rel_l2(out, exp))
    if worst > tol:
        raise SystemExit(f"fullenc_slice audio vs plain separator rel L2 "
                         f"{worst} > {tol}")
    lat = sorted(lat_ms)
    phase("fullenc_slice", requests=len(requests), rows=rows_list,
          batches=batches, visual=f"{list(v_spec.shape)} float16",
          rel_l2_vs_plain=worst, tol=tol, p50_ms=statistics.median(lat),
          p90_ms=lat[min(len(lat) - 1, int(0.9 * len(lat)))],
          direct_batch8_ms=direct_ms, direct_batch8_plain_ms=direct_plain_ms,
          launches=launches)
    return launches


def fullenc_golden_phase():
    """The small-geometry JAX fixture tests/fixtures/
    torch_port_fullenc_golden.npz through the kernels: the --fusion_encode
    full separator's audio on the fixture's float16 rows at relative L2
    1e-4, then 3 train steps (MAAVSS_FULLENC_LOSS fold, mode 2): losses at
    relative 1e-4 and the per-leaf sums of the final parameters and
    statistics within 1e-4 of each leaf's absolute sum, the BatchNorm-fed
    conv biases and their running means left out."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.convert import (
        flatten_tree,
        from_flax,
        random_flax_tree,
        to_flax,
        unflatten_tree,
    )
    from maavss_tpu_torch.train.infer import make_separator

    tol = 1e-4
    with np.load(FULLENC_GOLDEN) as z:
        meta = json.loads(str(z["meta"]))
        audio, rows, want = z["audio"], z["pgram"], z["audio_out"]
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    for path, total in meta["checksums"].items():
        if not np.isclose(float(flat[path].astype(np.float64).sum()), total,
                          rtol=1e-6, atol=1e-6):
            raise SystemExit(f"fullenc golden weights do not regenerate: "
                             f"{path}")
    tree = unflatten_tree(flat)
    cfg = RunConfig(**meta["cfg"])
    step, state = _fullenc_kernel_step(cfg, meta["fullenc_loss"])
    model = state.model
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    dev = {"audio": torch.from_numpy(audio).cuda(),
           "pgram": torch.from_numpy(rows).cuda()}
    names, counters = _fusion_counters()
    for c in counters:
        c.launches = 0
    got = make_separator(model, cfg)(dev)["audio_out"].cpu().numpy()
    err = _rel_l2(got, want)
    if got.shape != want.shape or not np.all(np.isfinite(got)) or err > tol:
        raise SystemExit(f"fullenc golden audio rel L2 {err} > {tol}")
    losses = []
    for _ in meta["losses"]:
        state, m = step(state, dev, meta["mode"])
        losses.append(float(m["loss"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, meta["losses"]))
    if rel > tol:
        raise SystemExit(f"fullenc golden losses {losses} vs JAX "
                         f"{meta['losses']}: rel {rel} > {tol}")
    params, stats = to_flax(model.state_dict())
    flat = flatten_tree({"params": params, "batch_stats": stats})
    worst = 0.0
    for path, (total, abs_total) in meta["sums"].items():
        d = abs(float(flat[path].astype(np.float64).sum()) - total)
        worst = max(worst, d / max(abs_total, 1e-12))
        if d > tol * abs_total + 1e-7:
            raise SystemExit(f"fullenc golden leaf {path}: sum off by {d}")
    launches = dict(zip(names, (c.launches for c in counters)))
    if not all(launches[n] for n in ("lstm_fwd", "lstm_bwd", "pgenc_train",
                                     "pgenc_bwd", "adam", "stft")):
        raise SystemExit(f"the fullenc golden run missed a kernel: "
                         f"{launches}")
    phase("fullenc_golden", cfg=meta["cfg"], audio_rel_l2_vs_jax=err,
          losses=losses, jax_losses=meta["losses"], loss_rel_diff=rel,
          worst_leaf_sum_rel=worst, leaves=len(meta["sums"]),
          left_out=len(meta["bn_fed"]), launches=launches, tol=tol)


def bench_phase():
    """tools/bench_torch.py's measure function in this process at batch 8,
    2 windows of 5 steps, its defaults otherwise (full encode, float16
    rows, bf16), with its profiled step, once more at
    MAAVSS_BENCH_DTYPE=float32, and once at MAAVSS_BENCH_MULTISTEP=5 (one
    CUDA-graph replay of 5 steps a window, its profiled dispatch): each
    JSON line as a phase. The value must be finite and the kernels it
    counts per optimizer step those of the full-encode step."""
    from tools import bench_torch

    want = _fullenc_want()
    want["stft_feat"] = want.pop("stft")
    for env in ({}, {"MAAVSS_BENCH_DTYPE": "float32"},
                {"MAAVSS_BENCH_MULTISTEP": "5"}):
        line = bench_torch.with_baseline(bench_torch.measure(
            8, steps=5, windows=2, device="cuda", env=env,
            profile="MAAVSS_BENCH_DTYPE" not in env))
        k = line["kernels"]
        if (not math.isfinite(line["value"]) or line["value"] <= 0
                or any(k[n] != v for n, v in want.items())
                or line["dtype"] != env.get("MAAVSS_BENCH_DTYPE",
                                            "bfloat16")
                or line["multistep"] != int(env.get(
                    "MAAVSS_BENCH_MULTISTEP", "1"))):
            raise SystemExit(f"bench: value {line['value']}, dtype "
                             f"{line['dtype']}, multistep "
                             f"{line['multistep']}, kernels per step {k}, "
                             f"want {want}")
        phase("bench", **line)


# ------------------------------------------------------------ --dtype bf16

# the bf16 gates (tests/test_torch_bf16.py states them against JAX): a
# bf16 result of the kernels is at most RATIO (forward values) or
# GRAD_RATIO (gradients) times as far from the plain versions' bf16 result
# as that is from the plain versions' fp32 one, no further from the fp32
# one than ACCURATE times, and at least DIFFERS times as far from the fp32
# one (it ran in bf16: an fp32 path reads 0 there and 1.0 on the ratio);
# losses within LOSS_RTOL of the plain bf16 losses; the bf16 LSTM leaves
# after Adam within one bf16 ulp for at least BF16_LEAVES_SHARE of their
# elements and within 2 lr + 2 ulp for all. GRAD_RATIO is the card's own:
# step-1 gradients (Adam's first moments) of the kernels read 0.04x
# (fusion) and 0.21x (frames) the plain bf16-vs-fp32 distance on an NVIDIA
# H100, where JAX's own VJPs take 2.0x on the CPU. The bf16 LSTM leaves'
# moments take LOW_GRAD_RATIO: both sides round them to bf16, and where
# the kernel's and the plain gradient differ in their last bits a rounding
# flips one ulp, which reads 0.59x on the frames step (NVIDIA H100); a
# gradient 1 % off in magnitude reads about 2x
BF16_RATIO, BF16_GRAD_RATIO, BF16_ACCURATE, BF16_DIFFERS = 0.5, 0.5, 1.5, 0.1
BF16_LOW_GRAD_RATIO = 1.0
# kernels against plain versions on the card, forward values: the kernels'
# fp32 sums in another order flip a bf16 rounding here and there, and the
# flips grow through the model's chain of bf16 roundings (serving on an
# NVIDIA H100: 0.50 of the fp32 distance for the fusion flagship, 0.16 for
# the frames flagship), so the served audio is held at most as far from the
# plain bf16 audio as that is from the fp32 audio, and as accurate
BF16_SERVE_RATIO = 1.0
BF16_LOSS_RTOL, BF16_LEAVES_SHARE = 5e-4, 0.99
BF16_GOLDEN = os.path.join(ROOT, "tests", "fixtures",
                           "torch_port_bf16_golden.npz")


def _bf16_ratio(what, got, want, want32, ratio):
    """The ratio gate on flattened tensors or arrays; returns the ratio."""
    import numpy as np

    def f64(a):
        a = a.detach().float().cpu().numpy() if hasattr(a, "detach") else a
        return np.asarray(a, np.float64).ravel()

    got, want, want32 = f64(got), f64(want), f64(want32)
    near, base = _rel_l2(got, want), _rel_l2(want, want32)
    if base == 0.0:
        if near != 0.0:
            raise SystemExit(f"{what}: {near} from an exact reference")
        return 0.0
    far = _rel_l2(got, want32)
    if near > ratio * base or far < BF16_DIFFERS * base or (
            ratio > BF16_RATIO and far > BF16_ACCURATE * base):
        raise SystemExit(f"{what}: {near} from the plain bf16 result and "
                         f"{far} from the fp32 one, which are {base} apart "
                         f"(ratio {ratio}, differs {BF16_DIFFERS})")
    return near / base


def _one_rounding(what, got, want, atol=0.0):
    """Raise unless `got` is within one bf16 rounding (relative 2^-7) plus
    `atol` of `want`; returns the largest difference."""
    err = (got.float() - want.float()).abs()
    if not bool((err <= atol + 2.0 ** -7 * want.float().abs()).all()):
        raise SystemExit(f"{what}: {err.max().item()} past one bf16 "
                         f"rounding")
    return err.max().item()


def _k5_bf16_check(where, y, gamma, beta, g_out, g_mu, g_var):
    """K5's four kernels on a bf16 y against their plain versions under
    k5_bf16_phase's gates; returns the errors by kernel and the kernels'
    results (mu, var, rstd, out, sel, (dgamma, dbeta, k), dy)."""
    import torch

    from maavss_tpu_torch.ops.cuda_epilogue import (
        epilogue_apply,
        epilogue_apply_plain,
        epilogue_bwd_dy,
        epilogue_bwd_dy_plain,
        epilogue_bwd_reduce,
        epilogue_bwd_reduce_plain,
        epilogue_stats,
        epilogue_stats_plain,
    )

    mu, var, rstd = epilogue_stats(y)
    for n, a, b in zip(("mu", "var", "rstd"), (mu, var, rstd),
                       epilogue_stats_plain(y)):
        _rel_check(f"K5 bf16 stats {n} {where}", a, b, 1e-5)
    out, sel = epilogue_apply(y, gamma, beta, mu, rstd)
    out_p, sel_p = epilogue_apply_plain(y, gamma, beta, mu, rstd)
    torch.cuda.synchronize()
    if out.dtype != torch.bfloat16 or not torch.equal(sel, sel_p):
        raise SystemExit(f"K5 bf16 apply: sel differs at {where}")
    errs = {"stats": 0.0,
            "apply": _one_rounding(f"K5 bf16 out {where}", out, out_p)}
    del out_p, sel_p
    red = epilogue_bwd_reduce(g_out, sel, gamma, beta, mu, rstd, g_mu, g_var)
    red_p = epilogue_bwd_reduce_plain(g_out, sel, gamma, beta, mu, rstd,
                                      g_mu, g_var)
    errs["bwd_reduce"] = max(
        _rel_check(f"K5 bf16 bwd reduce {n} {where}", a, b, 1e-4)
        for n, a, b in zip(("dgamma", "dbeta", "k"), red, red_p))
    dy = epilogue_bwd_dy(y, g_out, sel, gamma, beta, mu, rstd, red[2])
    dy_p = epilogue_bwd_dy_plain(y, g_out, sel, gamma, beta, mu, rstd,
                                 red[2])
    errs["bwd_dy"] = _one_rounding(f"K5 bf16 dy {where}", dy, dy_p,
                                   1e-3 * dy_p.float().abs().max().item())
    del dy_p
    _k5_reduce_bits(where, (g_out, sel, gamma, beta, mu, rstd, g_mu, g_var))
    k0 = torch.zeros_like(red[2])
    hit = epilogue_bwd_dy(y, g_out, sel, gamma, beta, mu, rstd, k0) != 0
    hit_p = epilogue_bwd_dy_plain(y, g_out, sel, gamma, beta, mu, rstd,
                                  k0) != 0
    if not torch.equal(hit, hit_p):
        raise SystemExit(f"K5 bf16 tie routing differs at {where}")
    return errs, (mu, var, rstd, out, sel, red, dy)


def _k5_calls(y, gamma, beta, g_out, g_mu, g_var, res):
    """{K5 kernel name: (kernel call, plain call)} on these inputs, and the
    bytes and operations of each kernel's bound ({name: bytes}, {name:
    operations}). `res` is the kernels' results on these inputs (mu, var,
    rstd, out, sel, (dgamma, dbeta, k), dy)."""
    from maavss_tpu_torch.ops.cuda_epilogue import (
        epilogue_apply,
        epilogue_apply_plain,
        epilogue_bwd_dy,
        epilogue_bwd_dy_plain,
        epilogue_bwd_reduce,
        epilogue_bwd_reduce_plain,
        epilogue_stats,
        epilogue_stats_plain,
    )

    mu, var, rstd, out, sel, red, dy = res
    calls = {
        "stats": (lambda: epilogue_stats(y),
                  lambda: epilogue_stats_plain(y)),
        "apply": (lambda: epilogue_apply(y, gamma, beta, mu, rstd),
                  lambda: epilogue_apply_plain(y, gamma, beta, mu, rstd)),
        "bwd_reduce": (
            lambda: epilogue_bwd_reduce(g_out, sel, gamma, beta, mu, rstd,
                                        g_mu, g_var),
            lambda: epilogue_bwd_reduce_plain(g_out, sel, gamma, beta, mu,
                                              rstd, g_mu, g_var)),
        "bwd_dy": (
            lambda: epilogue_bwd_dy(y, g_out, sel, gamma, beta, mu, rstd,
                                    red[2]),
            lambda: epilogue_bwd_dy_plain(y, g_out, sel, gamma, beta, mu,
                                          rstd, red[2])),
    }
    n_el, c = y.numel(), y.shape[1]
    moved = {"stats": nbytes(y, mu, var, rstd),
             "apply": nbytes(y, out, sel) + 4 * 4 * c,
             "bwd_reduce": nbytes(g_out, sel) + 12 * 4 * c,
             "bwd_dy": nbytes(y, g_out, sel, dy) + 8 * 4 * c}
    ops = {"stats": 3 * n_el, "apply": 9 * n_el // 4,
           "bwd_reduce": 8 * n_el // 4, "bwd_dy": 10 * n_el}
    return calls, moved, ops


def _k5_time(rep, y, gamma, beta, g_out, g_mu, g_var, res):
    """Add to `rep` (by kernel name) each K5 kernel's and plain version's
    times on these inputs (CUDA events; the device and host split), the
    bytes and operations of its bound, and for stats torch.var_mean's
    time (the biased per-channel statistics in one PyTorch call). `res` is
    the kernels' results on these inputs."""
    import torch

    calls, moved, ops = _k5_calls(y, gamma, beta, g_out, g_mu, g_var, res)
    for n, (kernel, plain) in calls.items():
        dev_ms, host_ms = split_ms(kernel)
        r = rep[n]
        r["ms"] += cuda_ms(kernel)
        r["plain_ms"] += cuda_ms(plain)
        r["device_ms"] += dev_ms
        r["host_ms"] += host_ms
        r["bytes"] += moved[n]
        r["flops"] += ops[n]
    rep["stats"]["library_ms"] += cuda_ms(lambda: torch.var_mean(
        y, dim=(0, 2, 3, 4), correction=0))


def _k5_rep():
    """An empty K5 record: the sums `_k5_time` adds to, by kernel."""
    rep = {n: dict(err=0.0, ms=0.0, plain_ms=0.0, bytes=0, flops=0,
                   device_ms=0.0, host_ms=0.0)
           for n in ("stats", "apply", "bwd_reduce", "bwd_dy")}
    rep["stats"]["library_ms"] = 0.0
    return rep


def _k5_finish(rep):
    """`rep` with each kernel's bound from its summed bytes and operations,
    and library_ms None where there is no library call."""
    for r in rep.values():
        r["bound"] = bound_ms(r["bytes"], r["flops"])
        r.setdefault("library_ms", None)
    return rep


def k5_bf16_phase():
    """K5's four kernels on a bf16 y [B, C, T, H, W] (out, sel, g and dy in
    bf16, every sum and BN expression in fp32) against their plain versions
    at K5_SHAPES, gaussian and tied data (y rounded to 0.25: bf16 holds the
    grid exactly, and about a third of the windows tie), and stats, apply
    and bwd dy on a y one element into its storage (2-byte aligned: one
    value a load). Gates: mu, var, rstd, dgamma, dbeta and k as the fp32
    phase's (fp32 sums); sel exact; the tie routing exact (bwd dy with k = 0
    is nonzero only where the gradient is routed: the same elements);
    out and dy within one bf16 rounding (one ulp, relative 2^-7; dy also
    1e-3 of its largest entry). Times on the gaussian data; bounds in bf16 bytes."""
    import torch

    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(16)
    names = ("stats", "apply", "bwd_reduce", "bwd_dy")
    rep = _k5_rep()

    for stage, shape in enumerate(K5_SHAPES):
        for ties in (False, True):
            y, gamma, beta, g_out, g_mu, g_var = _k5_inputs(shape, g, False)
            if ties:
                y = torch.round(y * 4.0) / 4.0
            y, g_out = y.to(bf16), g_out.to(bf16)
            where = f"stage {stage} {'ties' if ties else 'gaussian'}"
            errs, res = _k5_bf16_check(where, y, gamma, beta, g_out, g_mu,
                                       g_var)
            for n in names:
                rep[n]["err"] = max(rep[n]["err"], errs[n])
            y4 = y.float().view(shape[:3] + (shape[3] // 2, 2,
                                             shape[4] // 2, 2))
            m = y4.amax(dim=(4, 6), keepdim=True)
            tied = ((y4 == m).sum(dim=(4, 6)) > 1).float().mean().item()
            phase("k5_bf16_check", stage=stage, shape=list(shape), ties=ties,
                  tied_window_share=tied,
                  **{f"max_abs_err_{n}": errs[n] for n in names})
            if not ties:
                yo = _at_offset(y)
                if yo.data_ptr() % 4 == 0:
                    raise SystemExit("K5 bf16 unaligned check: y aligned")
                _k5_bf16_check(f"{where} y at an odd offset", yo, gamma,
                               beta, g_out, g_mu, g_var)
                phase("k5_bf16_unaligned", where=where,
                      y_offset_bytes=yo.data_ptr() % 16)
            if ties:
                continue
            _k5_time(rep, y, gamma, beta, g_out, g_mu, g_var, res)
    edges = _k5_edges(bf16, _one_rounding)
    for n, err in edges.items():
        rep[n]["err"] = max(rep[n]["err"], err)
    _k5_finish(rep)
    phase("k5_epilogue_bf16", shapes=[list(s) for s in K5_SHAPES],
          **{n: {k: v for k, v in r.items() if k not in ("bytes", "flops")}
             for n, r in rep.items()},
          earlier_design_device_ms={n: v[1] for n, v in
                                    K5_EARLIER_DEVICE_MS.items()})
    return rep


def _plain_k2(fn):
    """`fn` run with K2-eval's plain version in place of its kernel (the
    serving path; the train path's K2 is held by k2_train)."""
    from maavss_tpu_torch.models import layers
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer_plain

    def run(*args):
        kernel = layers.pgenc_layer
        layers.pgenc_layer = lambda *a: pgenc_layer_plain(*a)
        try:
            return fn(*args)
        finally:
            layers.pgenc_layer = kernel
    return run


def _bf16_moments(state, model, skip, low):
    """Adam's first moment, upcast to fp32, by name, of every leaf not in
    `skip` that is bf16 in `model` (`low`, the LSTM's) or fp32 (not
    `low`)."""
    import torch

    return {n: m.float() for (n, p), m in zip(model.named_parameters(),
                                              state.tx.m)
            if (p.dtype == torch.bfloat16) == low and n not in skip}


def _bf16_train_vs_plain(what, cfg, frames_model, want, steps=3):
    """`steps` bf16 steps of the flagship of `cfg` (mode 2) with every
    kernel against the plain versions in bf16 (the LSTM scan, the plain Adam
    formula, K5's and K4's plain versions; K2's kernels on both sides, held
    by k2_train; the STFT kernel's features on both sides) from one
    state_dict, and one step of the plain versions in fp32 from it. Exact
    launch counts per kernel step (`want`); losses within BF16_LOSS_RTOL of
    the plain bf16 losses; after step 1 Adam's first moment (0.1 x the
    gradient) of the fp32 leaves under BF16_GRAD_RATIO (the conv biases
    that feed a train-mode BatchNorm left out) and apart that of the bf16
    LSTM leaves under BF16_LOW_GRAD_RATIO (their bf16 moments upcast: the
    one place their gradient's magnitude shows, since Adam's first step
    moves a bf16 leaf by its sign); the bf16 LSTM leaves within one ulp
    (BF16_LEAVES_SHARE) and
    2 lr + 2 ulp of the plain ones."""
    import torch

    from maavss_tpu_torch.data.synthetic import (
        synthetic_av_batch,
        with_pgram_rows,
    )
    from maavss_tpu_torch.train import setup
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step

    model, state, step, ref, ref_state, ref_step = _train_pair(
        cfg, frames_model, k2_plain=False, kernel_features=True)
    build = setup.build_frames_model if frames_model else setup.build_fusion
    make = make_frames_step if frames_model else make_fusion_step
    cfg32 = _plain_cfg(cfg, frames_model, False).replace(dtype="float32")
    ref32 = build(cfg32, cfg.batch_size, device="cuda")
    ref32.load_state_dict(model.state_dict())
    ref32.lstm.backend = "scan"
    state32 = create_train_state(ref32, cfg32, "cuda")
    step32 = _plain_k4(make(ref32, cfg32, device="cuda"), True)
    if frames_model:
        step32 = _plain_k5(step32)
    names, counters = _frames_counters() if frames_model \
        else _fusion_counters()
    want = {n: want.get(n, 0) for n in names}
    frame_size = cfg.framesize if frames_model else None
    batches = [synthetic_av_batch(cfg, cfg.batch_size, seed=cfg.seed + i,
                                  frame_size=frame_size)
               for i in range(steps)]
    if cfg.pgram_cache and not frames_model:
        batches = [with_pgram_rows(b, "cuda") for b in batches]
    skip = set() if frames_model else set(model.bn_fed_biases())
    losses, ref_losses = [], []
    for i, batch in enumerate(batches):
        for c in counters:
            c.launches = 0
        state, m = step(state, batch, 2)
        torch.cuda.synchronize()
        launches = dict(zip(names, (c.launches for c in counters)))
        if launches != want:
            raise SystemExit(f"{what} step {i + 1}: launches {launches} != "
                             f"{want}")
        ref_state, rm = ref_step(ref_state, batch, 2)
        losses.append(float(m["loss"]))
        ref_losses.append(float(rm["loss"]))
        if i == 0:
            state32, _ = step32(state32, batch, 2)
            grad_ratio = []
            for low in (False, True):
                moms = [_bf16_moments(s, model, skip, low) for s in (
                    state, ref_state, state32)]
                grad_ratio.append(_bf16_ratio(
                    f"{what} step-1 gradients of the "
                    f"{'bf16' if low else 'fp32'} leaves",
                    *(torch.cat([d[n].flatten() for n in sorted(moms[0])])
                      for d in moms),
                    BF16_LOW_GRAD_RATIO if low else BF16_GRAD_RATIO))
            lr = cfg.learning_rate
            share = 1.0
            sd, sd_ref = model.state_dict(), ref.state_dict()
            for n in ("lstm.fwd.w_i", "lstm.fwd.w_h", "lstm.bwd.w_i",
                      "lstm.bwd.w_h"):
                a, b = sd[n].float(), sd_ref[n].float()
                if sd[n].dtype != torch.bfloat16:
                    raise SystemExit(f"{what}: {n} is {sd[n].dtype}")
                ulp = torch.exp2(torch.floor(torch.log2(
                    b.abs().clamp(min=2.0 ** -126))) - 7)
                d = (a - b).abs()
                share = min(share, (d <= ulp).float().mean().item())
                if share < BF16_LEAVES_SHARE or bool(
                        (d > 2 * lr + 2 * ulp).any()):
                    raise SystemExit(f"{what}: {n} after Adam: {share} of "
                                     f"it within one bf16 ulp")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    if max(rel) > BF16_LOSS_RTOL or not all(map(math.isfinite, losses)):
        raise SystemExit(f"{what} losses {losses} vs plain {ref_losses}: "
                         f"rel {rel} > {BF16_LOSS_RTOL}")
    del ref, ref_state, ref32, state32
    return dict(batch=cfg.batch_size, steps=steps, losses=losses,
                plain_losses=ref_losses, loss_rel_diff=max(rel),
                step1_grad_ratio=grad_ratio[0],
                step1_grad_ratio_bf16_leaves=grad_ratio[1],
                lstm_leaves_within_one_ulp=share,
                launches_per_step=want), (model, state, step, batches[0])


def bf16_train_phase():
    """--dtype bfloat16 at full width: the fusion flagship with
    --fusion_encode full --pgram_cache (bench.py's regime, batch 8) and the
    frames flagship (framesize 256, batch 8, window mode), 3 steps each
    with every kernel against the plain versions under the bf16 gates
    (`_bf16_train_vs_plain`); one step of each family with --mask_head
    (bf16 a_fc1, then the standalone mask product in fp32: once forward and
    once in conjugate mode a step in full encode, once each a window in the
    frames step; the fused head never). Each family's bf16 step is timed in
    turns with its fp32 step (kernels, same width and seed), and the mask
    product at the full-encode head's shape."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.ops.cuda_complex import mask_mul, mask_mul_plain
    from maavss_tpu_torch.train.setup import (
        build_frames_state,
        build_fusion_state,
    )
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step

    ns = RunConfig().num_seq
    fusion_cfg = RunConfig(batch_size=8, noise_scalar=0.0, learning_rate=1e-4,
                           fusion_encode="full", pgram_cache=True,
                           dtype="bfloat16")
    fullenc = dict(lstm_fwd=1, lstm_bwd=1, pgenc_train=FULLENC_LAYERS,
                   pgenc_bwd=FULLENC_LAYERS, adam=1, stft=1)
    fusion, (model, state, step, batch) = _bf16_train_vs_plain(
        "bf16_train fusion", fusion_cfg, False, fullenc)
    cfg32 = fusion_cfg.replace(dtype="float32")
    m32, s32 = build_fusion_state(cfg32, 8, "cuda",
                                  torch.Generator().manual_seed(cfg32.seed))
    step32 = make_fusion_step(m32, cfg32, device="cuda")
    times = {"bf16": [], "fp32": []}
    for _ in range(2):
        times["bf16"].append(cuda_ms(lambda: step(state, batch, 2),
                                     reps=3, iters=3))
        times["fp32"].append(cuda_ms(lambda: step32(s32, batch, 2),
                                     reps=3, iters=3))
    fusion["step_ms"], fusion["fp32_step_ms"] = times["bf16"], times["fp32"]
    del model, state, step, m32, s32, step32
    mask, (model, state, _, batch) = _bf16_train_vs_plain(
        "bf16_train fusion --mask_head", fusion_cfg.replace(mask_head=True),
        False, dict(fullenc, mask_mul=2), steps=1)
    # the standalone mask product at the full-encode head's shape: the
    # B * num_seq windows of the clip's STFT, read in place, and the mask
    g = torch.Generator(device="cuda").manual_seed(12)
    hop, width = fusion_cfg.hops_per_frame, fusion_cfg.hops_per_frame \
        * fusion_cfg.num_frames
    clip = torch.randn(8, 2, hop * (fusion_cfg.num_frames + ns), 128,
                       device="cuda", generator=g)
    a = torch.stack([clip[:, :, hop * j:hop * j + width] for j in range(ns)],
                    dim=1).reshape(8 * ns, 2, width, 128)
    b = torch.randn(a.shape, device="cuda", generator=g)
    err = _rel_check("bf16_train mask_mul", mask_mul(a, b),
                     mask_mul_plain(a, b), 1e-6)
    dev_ms, host_ms = split_ms(lambda: mask_mul(a, b))
    mask_rep = dict(err=err, ms=cuda_ms(lambda: mask_mul(a, b)),
                    plain_ms=cuda_ms(lambda: mask_mul_plain(a, b)),
                    device_ms=dev_ms, host_ms=host_ms,
                    bound=bound_ms(3 * a.numel() * 4, 3 * a.numel()),
                    library_ms=None)
    del model, state
    os.environ.pop("MAAVSS_S2D_MIN_HW", None)  # the default, 128
    frames_cfg = RunConfig(batch_size=8, noise_scalar=0.0,
                           learning_rate=1e-4, dtype="bfloat16")
    k5 = {n: 2 * ns for n in ("epilogue_stats", "epilogue_apply",
                              "epilogue_bwd_reduce", "epilogue_bwd_dy")}
    frames_want = dict(lstm_fwd=ns, lstm_bwd=ns, adam=1, stft=1, **k5)
    frames, (model, state, step, batch) = _bf16_train_vs_plain(
        "bf16_train frames", frames_cfg, True, frames_want)
    cfg32 = frames_cfg.replace(dtype="float32")
    m32, s32 = build_frames_state(cfg32, 8, device="cuda",
                                  generator=torch.Generator().manual_seed(
                                      cfg32.seed))
    step32 = make_frames_step(m32, cfg32, device="cuda")
    times = {"bf16": [], "fp32": []}
    for _ in range(2):
        times["bf16"].append(cuda_ms(lambda: step(state, batch, 2),
                                     reps=2, iters=1))
        times["fp32"].append(cuda_ms(lambda: step32(s32, batch, 2),
                                     reps=2, iters=1))
    frames["step_ms"], frames["fp32_step_ms"] = times["bf16"], times["fp32"]
    frames["clips_per_s"] = 8 / (min(times["bf16"]) / 1e3)
    frames["fp32_clips_per_s"] = 8 / (min(times["fp32"]) / 1e3)
    del model, state, step, m32, s32, step32
    frames_mask, _ = _bf16_train_vs_plain(
        "bf16_train frames --mask_head", frames_cfg.replace(mask_head=True),
        True, dict(frames_want, mask_mul=2 * ns), steps=1)
    phase("bf16_train", fusion=fusion, fusion_mask_head=mask, frames=frames,
          frames_mask_head=frames_mask, mask_mul=mask_rep)
    launches = {n: frames["launches_per_step"][n] * frames["steps"]
                for n in ("epilogue_stats", "epilogue_apply",
                          "epilogue_bwd_reduce", "epilogue_bwd_dy")}
    launches["mask_mul"] = (mask["launches_per_step"]["mask_mul"]
                            + frames_mask["launches_per_step"]["mask_mul"])
    return launches, mask_rep


def bf16_slice_phase():
    """HTTP serving in bf16 at full width: the fusion flagship with
    --fusion_encode full --pgram_cache (float16 rows) and the frames
    flagship (uint8 frames), 4 requests of 1..8 rows each, against the
    plain bf16 serving function (the plain versions of K1, K2-eval and K4;
    the STFT kernel's features on both sides) under BF16_SERVE_RATIO against
    the plain fp32 serving function; each batch launches K1-fwd once (fusion)
    or once a window (frames), K2-eval once a layer (fusion) and the STFT
    kernel once. The replies keep their wire dtype, float32."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.exp.export import (
        make_serving_fn,
        random_serving_inputs,
        serving_info,
        serving_input_specs,
    )
    from maavss_tpu_torch.exp.serving import (
        BatchingExecutor,
        SeparationClient,
        SeparationServer,
    )
    from maavss_tpu_torch.ops.cuda_pgenc import pgenc_layer
    from maavss_tpu_torch.ops.phasegram import phasegram_cumsum
    from maavss_tpu_torch.train.setup import build_frames_model, build_fusion

    batch = 8
    out = {}
    for family in ("fusion", "frames"):
        frames_model = family == "frames"
        cfg = RunConfig(batch_size=batch, dtype="bfloat16")
        if not frames_model:
            cfg = cfg.replace(fusion_encode="full", pgram_cache=True)
        build = build_frames_model if frames_model else build_fusion
        model = build(cfg, batch, device="cuda",
                      generator=torch.Generator().manual_seed(cfg.seed))
        refs = {}
        for dtype in ("bfloat16", "float32"):
            rcfg = cfg.replace(dtype=dtype)
            ref = build(rcfg, batch, device="cuda")
            ref.load_state_dict(model.state_dict())
            ref.lstm.backend = "scan"
            refs[dtype] = _plain_k2(_plain_k4(make_serving_fn(
                ref, rcfg, frames_model), True))
        serve = make_serving_fn(model, cfg, frames_model)
        a_spec, v_spec = serving_input_specs(cfg, batch, frames_model)
        rng = np.random.default_rng(19)
        t_total = cfg.num_frames + cfg.num_seq
        rows_list = [1, 8, 3, 6]
        requests = []
        for i, rows in enumerate(rows_list):
            audio, visual = random_serving_inputs(cfg, rows, frames_model,
                                                  seed=700 + i)
            if not frames_model:
                frames = rng.uniform(0, 1, (rows, t_total, cfg.p_size,
                                            cfg.p_size)).astype(np.float32)
                visual = phasegram_cumsum(torch.from_numpy(
                    frames).cuda()).to(torch.float16).cpu().numpy()
            requests.append((audio, visual))
        executor = BatchingExecutor(serve, batch, a_spec, v_spec, "cuda",
                                    max_wait_ms=5.0)
        info = {"model": family, **serving_info(cfg, batch, frames_model)}
        server = SeparationServer(executor, info, host="127.0.0.1",
                                  port=0).start()
        host, port = server.address
        client = SeparationClient(f"http://{host}:{port}")
        names, counters = _frames_counters() if frames_model \
            else _fusion_counters()
        names, counters = names + ("pgenc_eval",), counters + (pgenc_layer,)
        for c in counters:
            c.launches = 0
        try:
            health = client.get_json("/healthz")
            responses = [client.separate(a, v) for a, v in requests]
            launches = dict(zip(names, (c.launches for c in counters)))
            stats = client.get_json("/stats")
        finally:
            client.close()
            server.stop()
        if health.get("compute_dtype") != "bfloat16":
            raise SystemExit(f"bf16_slice {family}: /healthz {health}")
        batches = stats["batches"]
        want = {n: 0 for n in names}
        want.update(stft=batches,
                    lstm_fwd=batches * (cfg.num_seq if frames_model else 1))
        if not frames_model:
            want["pgenc_eval"] = batches * FULLENC_LAYERS
        if batches < 1 or launches != want:
            raise SystemExit(f"bf16_slice {family} launches {launches} != "
                             f"{want}")
        worst = 0.0
        for (audio, visual), got in zip(requests, responses):
            rows = audio.shape[0]
            if got.shape != audio.shape or got.dtype != np.float32 \
                    or not np.all(np.isfinite(got)):
                raise SystemExit(f"bad bf16_slice {family} response")
            pad_a = np.zeros(a_spec.shape, a_spec.dtype)
            pad_v = np.zeros(v_spec.shape, v_spec.dtype)
            pad_a[:rows], pad_v[:rows] = audio, visual
            dev = (torch.from_numpy(pad_a).cuda(),
                   torch.from_numpy(pad_v).cuda())
            want_b, want_f = (refs[d](*dev)[:rows].cpu().numpy()
                              for d in ("bfloat16", "float32"))
            worst = max(worst, _bf16_ratio(f"bf16_slice {family}", got,
                                           want_b, want_f, BF16_SERVE_RATIO))
        out[family] = dict(requests=len(requests), rows=rows_list,
                           batches=batches, visual=str(v_spec.dtype),
                           worst_ratio=worst, launches=launches)
        del model, refs, serve
    phase("bf16_slice", **out)
    return out


def bf16_golden_phase():
    """The small-geometry JAX fixture tests/fixtures/
    torch_port_bf16_golden.npz (bf16; --fusion_encode full on float16 rows,
    the phasegram encoder as ConvStack, the JAX package's CPU path) through
    the card's kernels (K1, K3, the STFT kernel; cuDNN and cuBLAS in bf16):
    the separator's audio under BF16_RATIO against the fixture's JAX bf16
    and fp32 audio, then 3 train steps with losses within BF16_LOSS_RTOL of
    JAX's bf16 losses (tests/test_torch_bf16.py holds the CPU path to the
    same gates)."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.convert import (
        from_flax,
        random_flax_tree,
        unflatten_tree,
    )
    from maavss_tpu_torch.train.infer import make_separator
    from maavss_tpu_torch.train.setup import build_fusion_state
    from maavss_tpu_torch.train.steps import make_fusion_step

    with np.load(BF16_GOLDEN) as z:
        meta = json.loads(str(z["meta"]))
        arrays = {k: z[k] for k in z.files if k != "meta"}
    flat = random_flax_tree({k: tuple(v) for k, v in meta["shapes"].items()},
                            meta["seed"])
    for k in flat:  # the LSTM's leaves are bf16 values
        if k.endswith(("w_i", "w_h")):
            flat[k] = torch.from_numpy(flat[k]).to(
                torch.bfloat16).float().numpy()
    for path, total in meta["checksums"].items():
        if not np.isclose(float(flat[path].astype(np.float64).sum()), total,
                          rtol=1e-6, atol=1e-6):
            raise SystemExit(f"bf16 golden weights do not regenerate: {path}")
    tree = unflatten_tree(flat)
    cfg = RunConfig(**meta["cfg"])
    model, state = build_fusion_state(cfg, cfg.batch_size, "cuda")
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    dev = {"audio": torch.from_numpy(arrays["audio"]).cuda(),
           "pgram": torch.from_numpy(arrays["pgram"]).cuda()}
    names, counters = _fusion_counters()
    for c in counters:
        c.launches = 0
    got = make_separator(model, cfg)(dev)["audio_out"].cpu().numpy()
    ratio = _bf16_ratio("bf16 golden audio", got, arrays["audio_out"],
                        arrays["audio_out_f32"], BF16_RATIO)
    step = make_fusion_step(model, cfg, device="cuda")
    losses = []
    for _ in meta["losses_bfloat16"]:
        state, m = step(state, dev, meta["mode"])
        losses.append(float(m["loss"]))
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses, meta["losses_bfloat16"]))
    if rel > BF16_LOSS_RTOL or not all(map(math.isfinite, losses)):
        raise SystemExit(f"bf16 golden losses {losses} vs JAX "
                         f"{meta['losses_bfloat16']}: rel {rel}")
    launches = dict(zip(names, (c.launches for c in counters)))
    if not all(launches[n] for n in ("lstm_fwd", "lstm_bwd", "adam",
                                     "stft")):
        raise SystemExit(f"the bf16 golden run missed a kernel: {launches}")
    phase("bf16_golden", cfg=meta["cfg"], audio_ratio=ratio, losses=losses,
          jax_losses=meta["losses_bfloat16"],
          jax_fp32_losses=meta["losses_float32"], loss_rel_diff=rel,
          launches=launches, ratio=BF16_RATIO, loss_rtol=BF16_LOSS_RTOL)


# ------------------------------------------------------------ CUDA graphs

GRAPH_K = 3  # optimizer steps a dispatch in the graphs phase
GRAPH_DISPATCHES = 3
# the cases run a second time with cuDNN's default algorithms (the
# product's setting), held at the train gates; the fusion ones timed in
# turns and profiled
GRAPH_DEFAULT = ("fullenc_b8", "fullenc_b8_bf16", "fullenc_b256_bf16",
                 "frames_b8")
# Adam's update of one element in one step is at most about this many lr
# over the phase's first 3 K steps (b1 0.9, b2 0.999: Cauchy-Schwarz on
# m / sqrt(v) with the bias corrections gives 1.12 at step 9)
ADAM_STEP_BOUND = 1.25


def _graph_cases():
    """(label, frames model, cfg) of the graphs phase: the default RunConfig
    (noise_scalar 0.1, lr 1e-5) at full width."""
    from maavss_tpu_torch.config import RunConfig

    full = dict(fusion_encode="full", pgram_cache=True)
    bf16 = dict(dtype="bfloat16")
    return (
        ("fullenc_b8", False, RunConfig(batch_size=8, **full)),
        ("fullenc_b8_bf16", False, RunConfig(batch_size=8, **full, **bf16)),
        ("fullenc_b256_bf16", False,
         RunConfig(batch_size=256, **full, **bf16)),
        ("scan_b8", False, RunConfig(batch_size=8)),
        ("scan_b8_bf16", False, RunConfig(batch_size=8, **bf16)),
        ("frames_b8", True, RunConfig(batch_size=8)),
        ("frames_b8_bf16", True, RunConfig(batch_size=8, **bf16)),
        ("mask_head_b8", False, RunConfig(batch_size=8, mask_head=True,
                                          **full)),
        ("polar_b8", False, RunConfig(batch_size=8, use_polar=True, **full)),
        ("schedule_b8", False, RunConfig(
            batch_size=8, noise_schedule="linear:0.1:0.0", **full)),
    )


def _graph_state_diff(state, ref_state):
    """Names of the leaves where two train states differ in any bit (value
    equality: -0.0 equals 0.0): parameters, buffers (BatchNorm's running
    statistics and counts), Adam's m, v and device count, and the host
    counts."""
    import torch

    bad = []
    model, ref = state.model, ref_state.model
    for (n, a), (_, b) in zip(model.named_parameters(),
                              ref.named_parameters()):
        if not torch.equal(a, b):
            bad.append(n)
    for (n, a), (_, b) in zip(model.named_buffers(), ref.named_buffers()):
        if not torch.equal(a, b):
            bad.append(n)
    names = [n for n, _ in model.named_parameters()]
    for col, a_list, b_list in (("m", state.tx.m, ref_state.tx.m),
                                ("v", state.tx.v, ref_state.tx.v)):
        bad += [f"adam.{col}.{n}" for n, a, b in zip(names, a_list, b_list)
                if (a is None) != (b is None)
                or (a is not None and not torch.equal(a, b))]
    if not torch.equal(state.tx.count_tensor, ref_state.tx.count_tensor):
        bad.append("adam.count (device)")
    if (state.tx.count, state.step) != (ref_state.tx.count, ref_state.step):
        bad.append("host counts")
    return bad


def _graph_train_gates(label, d, state, ref_state, got, ref_metrics, lr):
    """The train gates for a dispatch of cuDNN's default algorithms: each
    step's loss within 1e-4 relative of the eager twin's, and every
    parameter within Adam's elementwise bound of its twin's (both moved
    at most ADAM_STEP_BOUND lr a step from one start). Returns (loss rel,
    worst parameter distance in units of that bound)."""
    import torch

    want = torch.stack([m["loss"] for m in ref_metrics])
    rel = ((got["loss"] - want).abs() / want.abs()).max().item()
    bound = 2 * ADAM_STEP_BOUND * lr * state.step
    worst = max((a - b).abs().max().item() for a, b in zip(
        state.model.parameters(), ref_state.model.parameters())) / bound
    if rel > 1e-4 or worst > 1.0:
        raise SystemExit(f"graphs {label} (cuDNN's default algorithms) "
                         f"dispatch {d + 1}: losses {got['loss'].tolist()} "
                         f"vs {want.tolist()} (rel {rel}, gate 1e-4), "
                         f"parameters {worst} of Adam's bound")
    return rel, worst


def _graph_case(label, frames_model, cfg, exact: bool, k: int = GRAPH_K,
                dispatches: int = GRAPH_DISPATCHES, timed=None,
                profiled: bool = True, build=None, make=None):
    """One case of the graphs phase (see graphs_phase) of `dispatches`
    dispatches of `k` steps; `exact`: with cuDNN's deterministic
    algorithms, bit for bit, else cuDNN's default ones, at the train gates.
    `timed` (default: the fusion cases with the default algorithms): then
    timed, eager steps against dispatches in turns, with peak memory, and
    with `profiled` profiled. `build` (cfg, batch, device, generator) ->
    (model, state) and `make` (a step factory of train/steps.py) replace
    the family's. Returns its record and the graphed dispatches' launches
    by counter name."""
    import torch

    from maavss_tpu_torch.data.synthetic import (
        synthetic_av_batch,
        with_pgram_rows,
    )
    from maavss_tpu_torch.ops.counters import kernel_counters
    from maavss_tpu_torch.train import setup
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step

    if timed is None:
        timed = not exact and not frames_model
    torch.backends.cudnn.deterministic = exact
    if frames_model:
        build = build or setup.build_frames_state
        make = make or make_frames_step
    else:
        build = build or setup.build_fusion_state
        make = make or make_fusion_step
    model, state = build(cfg, cfg.batch_size, device="cuda",
                         generator=torch.Generator().manual_seed(cfg.seed))
    ref, ref_state = build(cfg, cfg.batch_size, device="cuda",
                           generator=torch.Generator().manual_seed(
                               cfg.seed + 1))
    ref.load_state_dict(model.state_dict())
    kstep = make(model, cfg, device="cuda", k_steps=k)
    step = make(ref, cfg, device="cuda", k_steps=1)
    gen = torch.Generator(device="cuda").manual_seed(7)
    ref_gen = torch.Generator(device="cuda").manual_seed(7)
    frame_size = cfg.framesize if frames_model else None
    batches = [synthetic_av_batch(cfg, cfg.batch_size, seed=i,
                                  frame_size=frame_size)
               for i in range(k * dispatches)]
    if cfg.pgram_cache:
        batches = [with_pgram_rows(b, "cuda") for b in batches]
    dispatches = [{key: torch.from_numpy(v).cuda() for key, v in
                   setup.stack_batches(batches[d * k:(d + 1) * k]).items()}
                  for d in range(dispatches)]
    del batches
    noise_fn = setup.resolve_noise_schedule(cfg)
    counters = kernel_counters()

    def counts():
        return {n: getattr(o, a) for n, (o, a) in counters.items()}

    def zero():
        for o, a in counters.values():
            setattr(o, a, 0)

    per_step, totals, noises, gates, bit_equal = None, {}, [], [], True
    for d, dispatch in enumerate(dispatches):
        noise = None if noise_fn is None else noise_fn(state.step)
        noises.append(noise)
        ref_metrics = []
        for j in range(k):
            zero()
            ref_state, m = step(ref_state, {key: v[j] for key, v in
                                            dispatch.items()}, 2, ref_gen,
                                noise=noise)
            torch.cuda.synchronize()
            if per_step is None:
                per_step = counts()
            elif counts() != per_step:
                raise SystemExit(f"graphs {label}: eager step launches "
                                 f"{counts()} != {per_step}")
            ref_metrics.append(m)
        zero()
        state, got = kstep(state, dispatch, 2, gen, noise=noise)
        torch.cuda.synchronize()
        launched = counts()
        if launched != {n: k * c for n, c in per_step.items()}:
            raise SystemExit(f"graphs {label} dispatch {d + 1}: launches "
                             f"{launched}, want {k} x {per_step}")
        for n, c in launched.items():
            totals[n] = totals.get(n, 0) + c
        bad = [key for key in ref_metrics[0] if not torch.equal(
            got[key], torch.stack([m[key] for m in ref_metrics]))]
        bad += _graph_state_diff(state, ref_state)
        bit_equal = bit_equal and not bad
        if not exact:
            gates.append(_graph_train_gates(label, d, state, ref_state, got,
                                            ref_metrics, cfg.learning_rate))
        elif bad:
            raise SystemExit(
                f"graphs {label} dispatch {d + 1} (steps {d * k + 1}-"
                f"{(d + 1) * k}{', a capture' if d == 0 else ', a replay'})"
                f" differs from {k} eager steps in: {bad[:12]} "
                f"({len(bad)} in all); losses {got['loss'].tolist()} vs "
                f"{[float(m['loss']) for m in ref_metrics]}")
    if kstep.captures != 1:
        raise SystemExit(f"graphs {label}: {kstep.captures} captures over "
                         f"{len(dispatches)} dispatches, want 1")
    if noise_fn is not None and len(set(noises)) < 2:
        raise SystemExit(f"graphs {label}: noise values {noises} do not "
                         f"change")
    out = dict(case=label, model="frames" if frames_model else "fusion",
               batch=cfg.batch_size, dtype=cfg.dtype,
               fusion_encode=None if frames_model else cfg.fusion_encode,
               window_mode=cfg.window_mode, mask_head=cfg.mask_head,
               use_polar=cfg.use_polar, noise=noises if noise_fn else
               cfg.noise_scalar, k=k, dispatches=len(dispatches),
               frames_encode=cfg.frames_encode if frames_model else None,
               microbatch=cfg.microbatch,
               captures=kstep.captures, cudnn_deterministic=exact,
               bit_equal=bit_equal,
               launches_per_step={n: c for n, c in per_step.items() if c})
    if not exact:
        out.update(loss_rel_diff=max(g[0] for g in gates),
                   params_of_adam_bound=max(g[1] for g in gates))
    if timed:
        last = dispatches[-1]

        def eager():
            for j in range(k):
                step(ref_state, {key: v[j] for key, v in last.items()}, 2,
                     ref_gen)

        def graphed():
            kstep(state, last, 2, gen)

        times, peaks = {}, {}
        for _ in range(2):
            for name, fn in (("eager", eager), ("graphed", graphed)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                fn()
                torch.cuda.synchronize()
                times.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3 / (2 * k))
        # peaks with both models resident; a replay allocates nothing, so
        # the graph's private pool shows in the reserved bytes alone
        for name, fn in (("eager", eager), ("graphed", graphed)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peaks[name] = dict(allocated=torch.cuda.max_memory_allocated(),
                               reserved=torch.cuda.max_memory_reserved())
        out.update(
            step_ms=times, peak_memory_bytes=peaks,
            clips_per_s={n: cfg.batch_size / (min(t) / 1e3)
                         for n, t in times.items()})
        if profiled:
            for name, fn in (("eager", eager), ("graphed", graphed)):
                profile_phase(f"graphs_profile_{label}_{name}", fn, calls=1)
    torch.backends.cudnn.deterministic = False
    return out, totals


def _cudnn_wgrad_alone(calls: int = 8):
    """The library call that keeps a step's bits from repeating, alone:
    cuDNN's fp32 convolution weight gradient (aten.convolution_backward) at
    the fusion STFT encoder's first conv of the batch-8 full-encode step
    (x [8, 2, 88, 128], w [8, 2, 5, 5], stride 2, pad 2), `calls` eager
    calls and `calls` replays of one captured call, with cuDNN's default
    algorithms and with its deterministic ones. The deterministic ones must
    give one result, eager and replayed alike."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(8, 2, 88, 128, device="cuda", generator=g)
    w = torch.randn(8, 2, 5, 5, device="cuda", generator=g)
    dy = torch.randn(8, 8, 44, 64, device="cuda", generator=g)

    def wgrad():
        return torch.ops.aten.convolution_backward(
            dy, x, w, None, [2, 2], [2, 2], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]

    out = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        first = wgrad()
        eager = sum(not torch.equal(wgrad(), first)
                    for _ in range(calls - 1))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            wgrad()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = wgrad()
        replayed = 0
        for _ in range(calls):
            graph.replay()
            torch.cuda.synchronize()
            replayed += not torch.equal(captured, first)
        out["deterministic" if det else "default"] = dict(
            eager_calls_differing=eager, replays_differing=replayed,
            calls=calls)
    torch.backends.cudnn.deterministic = False
    if (out["deterministic"]["eager_calls_differing"]
            or out["deterministic"]["replays_differing"]):
        raise SystemExit(f"cuDNN's deterministic fp32 wgrad differs: {out}")
    return out


def graphs_phase():
    """--steps_per_dispatch on the card (train/cuda_graph.py). Each case of
    `_graph_cases` (the full-encode fusion step on float16 rows at batch 8
    in fp32 and bf16 and at batch 256 in bf16, the scan window step and
    the frames step at batch 8 in fp32 and bf16, one --mask_head and one
    --use_polar full-encode step, and the full-encode step under
    --noise_schedule) builds a model from its seed and a twin from its
    state_dict, takes one noise generator seed, mode 2 and K = 3, and runs
    three K-step dispatches (the first runs its K steps eagerly and
    captures, the next two replay) against 3 K eager steps of the twin,
    with cuDNN's deterministic algorithms: each dispatch must equal its K
    eager steps bit for bit (the [K] metrics, every parameter, BatchNorm's
    running statistics, Adam's m, v and count); its kernel launches must be
    K times the eager step's, and the three dispatches make one capture.
    Under --noise_schedule each dispatch takes the schedule's value at its
    global step (the three differ) and never re-captures.
    cuDNN's default fp32 conv weight gradient differs from call to call,
    eagerly as under capture (`_cudnn_wgrad_alone` shows it alone), so the
    cases of GRAPH_DEFAULT run again with cuDNN's default algorithms (the
    product's setting) at the train gates, and the fusion ones are timed
    there, eager K steps and one dispatch in turns (per-step wall ms; peak
    memory allocated and reserved, the graph's private pool in the
    latter), with one of each profiled. Returns each kernel's launches
    over the graphed dispatches by the bf16 and fp32 cases."""
    wgrad = _cudnn_wgrad_alone()
    phase("graphs_cudnn_wgrad", op="aten.convolution_backward (cuDNN, "
          "fp32 weight gradient)", x=[8, 2, 88, 128], w=[8, 2, 5, 5],
          stride=2, padding=2, **wgrad)
    cases, by_dtype = [], {"float32": {}, "bfloat16": {}}
    for exact in (True, False):
        for label, frames_model, cfg in _graph_cases():
            if not exact and label not in GRAPH_DEFAULT:
                continue
            out, totals = _graph_case(label, frames_model, cfg, exact)
            for n, c in totals.items():
                by_dtype[cfg.dtype][n] = by_dtype[cfg.dtype].get(n, 0) + c
            phase("graphs_case", **out)
            cases.append(label if exact else f"{label}_default")
    phase("graphs", cases=cases, k=GRAPH_K, dispatches=GRAPH_DISPATCHES,
          launches=by_dtype)
    return by_dtype


# --frames_encode full, --frames_halo and --microbatch (frames_full,
# fusion_microbatch, frames_tuned)
FRAMES_FULL = dict(frames_encode="full", frames_halo=1, microbatch=2)
# the JAX package's tuned frames configuration (its bench's frames regime at
# BATCH=256 MICROBATCH=2 FRAMES_ENCODE=full, in bf16)
TUNED = dict(batch_size=256, frames_encode="full", microbatch=2,
             dtype="bfloat16")
TUNED_K = 2  # optimizer steps a graphed dispatch in frames_tuned
# the batch rows each slice of the plain K5 chain takes at the tuned and
# the wide shapes (the plain chain's fp32 temporaries of the whole tensor
# would not fit beside the kernels' results)
K5_SLICE_ROWS = 16
# stage 0 of the fp32 full-encode trunk at batch 256 and --microbatch 1:
# 2.95e9 values, past 2^31
K5_WIDE_SHAPE = (256, 16, 11, 256, 256)
K5_NAMES = ("epilogue_stats", "epilogue_apply", "epilogue_bwd_reduce",
            "epilogue_bwd_dy")


def _frames_full_want(mb):
    """Launches of one full-encode frames step at --microbatch mb: each K5
    kernel 2 mb (stages 0 and 1 of each chunk's one trunk pass), K1-fwd and
    K1-bwd mb (the heads once a chunk), K3 and the STFT once."""
    return dict(lstm_fwd=mb, lstm_bwd=mb, adam=1, stft=1,
                **{n: 2 * mb for n in K5_NAMES})


def _duplicated_chunks(cfg):
    """JAX's duplicated-chunk identity (tests/test_frames_fullseq.py:89-96)
    at full width, kernels on both sides: a batch of two equal halves gives
    at --microbatch 2 the step-1 loss of --microbatch 1 within 1e-5
    relative (each chunk's BatchNorm sees the whole batch's statistics) and
    the parameters within `_step1_close`'s frames gates (parameters only:
    the running statistics take two updates against one by design)."""
    import numpy as np
    import torch

    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.train.setup import build_frames_state
    from maavss_tpu_torch.train.steps import make_frames_step

    half = synthetic_av_batch(cfg, cfg.batch_size // 2, seed=cfg.seed + 9,
                              frame_size=cfg.framesize)
    batch = {k: np.concatenate([v, v]) for k, v in half.items()}
    runs, alt = {}, None
    for mb in (1, 2):
        c = cfg.replace(microbatch=mb)
        model, state = build_frames_state(
            c, c.batch_size, device="cuda",
            generator=torch.Generator().manual_seed(c.seed))
        if mb == 1:
            alt = _reordered_step1_grads(c, model, batch, True)
        grads = _grab_step1_grads(state, model)
        state, m = make_frames_step(model, c, device="cuda")(state, batch, 2)
        runs[mb] = (model, grads, float(m["loss"]))
    rel = abs(runs[2][2] - runs[1][2]) / abs(runs[1][2])
    if rel > 1e-5:
        raise SystemExit(f"frames_full duplicated chunks: losses {runs[2][2]}"
                         f" (mb 2) vs {runs[1][2]} (mb 1), rel {rel}")
    worst = _step1_close("frames_full duplicated chunks", runs[2][0],
                         runs[1][0], runs[2][1], runs[1][1],
                         cfg.learning_rate, 1e-4, 2e-3, alt,
                         params_only=True)
    return dict(loss_mb2=runs[2][2], loss_mb1=runs[1][2], loss_rel_diff=rel,
                **worst)


def _launches(out):
    """Each kernel's launches over a `_train_vs_plain` run."""
    return {n: c * out["steps"] for n, c in out["launches_per_step"].items()}


def frames_full_phase():
    """--frames_encode full --frames_halo 1 --microbatch 2 on the full-width
    frames flagship (framesize 256, batch 8, mode 2, noise_scalar 0): 3
    train steps with every kernel against the plain versions from one
    state_dict, in fp32 under the frames train gates (`_train_vs_plain`,
    lr 1e-3) and in bf16 under the bf16 gates (`_bf16_train_vs_plain`, lr
    1e-4); exact launch counts per step (`_frames_full_want`); the
    duplicated-chunk identity (`_duplicated_chunks`); then one HTTP request
    of 8 rows to a full-encode frames daemon, held against the plain
    full-encode separator batch at relative L2 1e-4 (frames_full_slice).
    Returns the launches by kernel of the fp32 and bf16 steps and of the
    served batch."""
    from maavss_tpu_torch.config import RunConfig

    os.environ.pop("MAAVSS_S2D_MIN_HW", None)  # the default, 128
    cfg = RunConfig(batch_size=8, noise_scalar=0.0, learning_rate=1e-3,
                    **FRAMES_FULL)
    want = _frames_full_want(cfg.microbatch)
    fp32 = _train_vs_plain("frames_full fp32", cfg, True, want)
    bf16, _ = _bf16_train_vs_plain(
        "frames_full bf16", cfg.replace(dtype="bfloat16",
                                        learning_rate=1e-4), True, want)
    dup = _duplicated_chunks(cfg)
    phase("frames_full", **FRAMES_FULL, fp32=fp32, bf16=bf16,
          duplicated_chunks=dup)
    served = frames_slice_phase("frames_full_slice", rows_list=(8,),
                                frames_encode="full")
    return _launches(fp32), _launches(bf16), served


def _pre_activations(linear):
    """A list that every later forward of `linear` appends its output to
    (the pre-activation of the LeakyReLU that follows it)."""
    outs = []
    linear.register_forward_hook(
        lambda mod, args, out: outs.append(out.detach()))
    return outs


def _fp64_encoders_step1_grads(cfg, ref, batch, kernel_features):
    """The plain versions' step-1 gradients once more, from `ref`'s
    state_dict, with both encoders (the phasegram encoder, the stack K2
    replaces, and the STFT encoder: conv, train-mode BatchNorm, activation)
    computed in fp64 and rounded once to fp32 at their outputs and their
    parameters' gradients: a more exact fp32 step. How far these stand from
    the plain versions' is how far a rounding-sized change of the latents
    moves the step's gradients. Returns the gradients and v_fc1's outputs
    (`_pre_activations`)."""
    import torch

    from maavss_tpu_torch.models import layers

    alt, alt_state, grads, step = _plain_twin(cfg, ref, False,
                                              kernel_features=kernel_features)
    outs = _pre_activations(alt.v_fc1)

    def fp64(enc):
        def forward(x):
            x = x.double()
            for spec, (conv_name, bn) in zip(enc.specs, enc.names):
                conv = getattr(enc, conv_name)
                if spec.transpose:
                    raise SystemExit("fp64 encoders: a transposed conv")
                bias = None if conv.bias is None else conv.bias.double()
                x = conv._conv_forward(x, conv.weight.double(), bias)
                if bn is not None:
                    p = getattr(enc, bn).BatchNorm_0
                    mean = x.mean(dim=(0, 2, 3))
                    var = torch.clamp((x * x).mean(dim=(0, 2, 3))
                                      - mean * mean, min=0.0)
                    mul = p.weight.double() * torch.rsqrt(var + 1e-5)
                    x = ((x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
                         + p.bias.double().view(1, -1, 1, 1))
                x = layers.activate(x, spec.act, torch.float64)
            return x.float()
        return forward

    for enc in (alt.phasegram_encoder, alt.stft_encoder):
        enc.forward = fp64(enc)  # BatchNorm's running statistics unused
    step(alt_state, batch, 2)
    torch.cuda.synchronize()
    return grads, outs


def _k2_witness(cfg, want):
    """The scan step of `cfg` (mode 2, on the STFT kernel's features on
    both sides), where the kernels against the plain versions fail the
    train gates on v_fc1's leaves (step-1 gradient rms 2.2e-9 for the
    bias), held by two witnesses that the gap is K2's rounding carried
    across a kink, and no kernel fault: (1) with K2 on both sides, every
    other kernel against its plain version under the train gates
    (`_train_vs_plain`, one step, exact launches); (2) the kernel step
    against the plain step under `_step1_close`, whose spread is that of
    the plain step with both encoders in fp64 (`_fp64_encoders_step1_grads`):
    each leaf at relative L2 1e-4, or its gradient within twice that
    spread and each element within Adam's step of the gradients'
    difference; the losses at 1e-4. Reported beside: the reversed-rows
    spread, and how many of v_fc1's outputs (the visual head's LeakyReLU
    input) change sign against the plain step's, in the kernel step and in
    the fp64 one."""
    import torch

    from maavss_tpu_torch.data.synthetic import synthetic_av_batch

    what = f"fusion_microbatch scan b{cfg.batch_size}"
    shared = _train_vs_plain(f"{what} K2 on both sides", cfg, False, want,
                             steps=1, k2_plain=False, kernel_features=True)
    model, state, step, ref, ref_state, ref_step = _train_pair(
        cfg, False, True, kernel_features=True)
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=cfg.seed)
    grads, ref_grads = (_grab_step1_grads(st, m)
                        for st, m in ((state, model), (ref_state, ref)))
    exact, exact_outs = _fp64_encoders_step1_grads(cfg, ref, batch, True)
    rows = _reordered_step1_grads(cfg, ref, batch, False, True, True)
    outs, ref_outs = _pre_activations(model.v_fc1), _pre_activations(
        ref.v_fc1)
    _, m = step(state, batch, 2)
    _, rm = ref_step(ref_state, batch, 2)
    torch.cuda.synchronize()
    loss, ref_loss = float(m["loss"]), float(rm["loss"])
    if abs(loss - ref_loss) > 1e-4 * abs(ref_loss):
        raise SystemExit(f"{what}: loss {loss} vs plain {ref_loss}")

    def flips(got):
        return sum(int(((a > 0) != (b > 0)).sum().item())
                   for a, b in zip(got, ref_outs))

    kinks = dict(kernels=flips(outs), fp64_encoders=flips(exact_outs),
                 of=sum(o.numel() for o in ref_outs))
    phase("fusion_microbatch_witness", batch=cfg.batch_size,
          v_fc1_sign_flips=kinks)
    worst = _step1_close(f"{what} (spread: fp64 encoders)", model, ref,
                         grads, ref_grads, cfg.learning_rate, 1e-4, None,
                         exact)

    def rel_l2(a, b):
        return (torch.linalg.vector_norm(a - b)
                / torch.linalg.vector_norm(b)).item()

    for leaf in worst["step1_passed_by_gradient"]:
        leaf["reversed_rows_spread"] = rel_l2(rows[leaf["leaf"]],
                                              ref_grads[leaf["leaf"]])
    return dict(batch=cfg.batch_size, loss=loss, plain_loss=ref_loss,
                k2_on_both_sides={k: v for k, v in shared.items()
                                  if k.startswith("step1")},
                v_fc1_sign_flips=kinks, vs_plain=worst)


def fusion_microbatch_phase():
    """--microbatch 2 on the full-width fusion flagship (mode 2, lr 1e-3,
    noise 0): 3 steps of --fusion_encode full --pgram_cache at batch 8 (the
    bench's regime; both sides on the STFT kernel's features, as
    fullenc_train) and one scan window step at batch 16 (chunks of 8 rows,
    the train phase's batch), each with every kernel against the plain
    versions from one state_dict under the train gates
    (`_train_vs_plain`); exact launch counts per step: K1 and K2 mb times
    the step's at --microbatch 1, K3 and the STFT once. A scan step of
    4-row chunks fails those gates with or without --microbatch, by
    conditioning, not by a kernel (tools/fusion_step1_probe_torch.py
    --batch 4: v_fc1.bias, whose step-1 gradient has an rms of 2.2e-9,
    under Adam's eps, moves 3.8e-4 relative with K2 in place of ConvStack
    and 0.45 for a 1e-7 relative change of the visual input; PERF.md
    §7): the scan step at batch 8 is held by `_k2_witness`."""
    from maavss_tpu_torch.config import RunConfig

    mb = 2
    per_chunk = ("lstm_fwd", "lstm_bwd", "pgenc_train", "pgenc_bwd")
    cfg = RunConfig(batch_size=8, noise_scalar=0.0, learning_rate=1e-3,
                    fusion_encode="full", pgram_cache=True, microbatch=mb)
    full = _train_vs_plain(
        "fusion_microbatch full", cfg, False,
        {n: c * mb if n in per_chunk else c
         for n, c in _fullenc_want().items()}, kernel_features=True)
    ns = cfg.num_seq
    scan_want = dict(lstm_fwd=ns * mb, lstm_bwd=ns * mb,
                     pgenc_train=10 * ns * mb, pgenc_bwd=10 * ns * mb,
                     adam=1, stft=1)
    scan_cfg = cfg.replace(fusion_encode="window", pgram_cache=False)
    scan = _train_vs_plain("fusion_microbatch scan",
                           scan_cfg.replace(batch_size=16), False, scan_want,
                           steps=1)
    witness = _k2_witness(scan_cfg, scan_want)
    phase("fusion_microbatch", microbatch=mb, full=full, scan=scan,
          scan_b8=witness)
    return {n: _launches(full)[n] + _launches(scan)[n]
            for n in full["launches_per_step"]}


def _k5_sliced(where, y, gamma, beta, g_out, g_mu, g_var, timed):
    """K5's four kernels on the whole of y against their plain versions:
    stats and bwd reduce (sums over the batch) on the whole, apply and bwd
    dy (per element, given the kernels' per-channel results) on slices of
    K5_SLICE_ROWS batch rows, under k5_epilogue's gates (fp32) or
    k5_epilogue_bf16's (bf16). With `timed`, a record as `_k5_time`'s,
    the plain apply's and bwd dy's ms summed over the slices. Returns the
    record (or None) and the errors by kernel."""
    import torch

    from maavss_tpu_torch.ops.cuda_epilogue import (
        epilogue_apply,
        epilogue_apply_plain,
        epilogue_bwd_dy,
        epilogue_bwd_dy_plain,
        epilogue_bwd_reduce,
        epilogue_bwd_reduce_plain,
        epilogue_stats,
        epilogue_stats_plain,
    )

    bf16 = y.dtype == torch.bfloat16
    mu, var, rstd = epilogue_stats(y)
    for n, a, b in zip(("mu", "var", "rstd"), (mu, var, rstd),
                       epilogue_stats_plain(y)):
        _rel_check(f"{where} stats {n}", a, b, 1e-5)
    out, sel = epilogue_apply(y, gamma, beta, mu, rstd)
    red = epilogue_bwd_reduce(g_out, sel, gamma, beta, mu, rstd, g_mu, g_var)
    errs = {"stats": 0.0, "apply": 0.0, "bwd_dy": 0.0, "bwd_reduce": max(
        _rel_check(f"{where} bwd reduce {n}", a, b, 1e-4)
        for n, a, b in zip(("dgamma", "dbeta", "k"), red,
                           epilogue_bwd_reduce_plain(g_out, sel, gamma, beta,
                                                     mu, rstd, g_mu, g_var)))}
    dy = epilogue_bwd_dy(y, g_out, sel, gamma, beta, mu, rstd, red[2])
    rows = range(0, y.shape[0], K5_SLICE_ROWS)
    plain = {"apply": 0.0, "bwd_dy": 0.0}
    for r in rows:
        part = slice(r, r + K5_SLICE_ROWS)
        ys, gs, ss = y[part], g_out[part], sel[part]

        def apply_plain():
            return epilogue_apply_plain(ys, gamma, beta, mu, rstd)

        def dy_plain():
            return epilogue_bwd_dy_plain(ys, gs, ss, gamma, beta, mu, rstd,
                                         red[2])

        out_p, sel_p = apply_plain()
        if not torch.equal(sel[part], sel_p):
            raise SystemExit(f"{where} apply: sel differs in rows {r}+")
        dy_p = dy_plain()
        at = f"{where} rows {r}+"
        if bf16:
            errs["apply"] = max(errs["apply"], _one_rounding(
                f"{at} out", out[part], out_p))
            errs["bwd_dy"] = max(errs["bwd_dy"], _one_rounding(
                f"{at} dy", dy[part], dy_p,
                1e-3 * dy_p.float().abs().max().item()))
        else:
            errs["apply"] = max(errs["apply"], _rel_check(
                f"{at} out", out[part], out_p, 1e-5))
            errs["bwd_dy"] = max(errs["bwd_dy"], check_close(
                f"{at} dy", dy[part], dy_p, 1e-4, 1e-4, scale_atol=True))
        del out_p, sel_p, dy_p
        if timed:
            plain["apply"] += cuda_ms(apply_plain, reps=1, iters=3)
            plain["bwd_dy"] += cuda_ms(dy_plain, reps=1, iters=3)
    if not timed:
        return None, errs
    rep = _k5_rep()
    calls, moved, ops = _k5_calls(y, gamma, beta, g_out, g_mu, g_var,
                                  (mu, var, rstd, out, sel, red, dy))
    for n in ("stats", "bwd_reduce"):  # sums over the batch: whole
        plain[n] = cuda_ms(calls[n][1], reps=3, iters=3)
    for n, (call, _) in calls.items():
        r = rep[n]
        r["ms"] = cuda_ms(call, reps=3, iters=5)
        r["device_ms"], r["host_ms"] = split_ms(call, reps=3, iters=5)
        r["plain_ms"], r["bytes"], r["flops"] = plain[n], moved[n], ops[n]
        r["err"] = errs[n]
    rep["stats"]["library_ms"] = cuda_ms(lambda: torch.var_mean(
        y, dim=(0, 2, 3, 4), correction=0), reps=3, iters=5)
    return _k5_finish(rep), errs


def _k1_at(b, t_len, dtype, g):
    """K1-fwd and K1-bwd (both directions, H 256) against their plain
    versions at (b, t_len) in `dtype`, under k1_lstm's and k1_bwd's gates,
    timed with their plain versions and cuDNN's nn.LSTM forward and
    backward in the same dtype. The bound takes the operations at the rate
    of their operands' type: in bf16 the tensor cores' (`bound`; the fp32
    rate's beside, `bound_fp32_rate`). Returns the (forward, backward)
    records."""
    import torch

    from maavss_tpu_torch.ops.cuda_lstm import (
        lstm_recurrence,
        lstm_recurrence_bwd,
        lstm_recurrence_bwd_plain,
        lstm_recurrence_plain,
    )

    h, rev, fp32 = 256, [False, True], dtype == torch.float32
    tol = 1e-5 if fp32 else 2.0 ** -7
    xws, whs, dys = _k1_inputs(b, t_len, dtype, g, h)
    where = f"K1 B={b} T={t_len} {dtype}"

    def fwd():
        return lstm_recurrence(xws, whs, rev, backend="kernel")

    def fwd_plain():
        return [lstm_recurrence_plain(x, w, r)
                for x, w, r in zip(xws, whs, rev)]

    got = fwd()
    err_f = 0.0
    for outs, refs in zip(got, fwd_plain()):
        for a, w in zip(outs, refs):
            err_f = max(err_f, check_close(f"{where} fwd", a, w, 1e-5, tol))
    yss, css, actss = ([o[i] for o in got] for i in range(3))

    def bwd():
        return lstm_recurrence_bwd(actss, whs, yss, css, dys, rev,
                                   backend="kernel")

    def bwd_plain():
        return [lstm_recurrence_bwd_plain(*a) for a in
                zip(actss, whs, yss, css, dys, rev)]

    grads = bwd()
    err_b = 0.0
    for (dxw, dwh), (dxw_r, dwh_r) in zip(grads, bwd_plain()):
        err_b = max(err_b, check_close(f"{where} dxw", dxw, dxw_r, tol, tol,
                                       scale_atol=not fp32),
                    check_close(f"{where} dW_h", dwh, dwh_r,
                                1e-4 if fp32 else tol,
                                1e-4 if fp32 else tol, scale_atol=True))
    recs = []
    for err, kernel, plain, n_bytes, flops, lib in (
            (err_f, fwd, fwd_plain,
             2 * (nbytes(xws[0], whs[0]) + nbytes(got[0][0], got[0][1])),
             2 * t_len * 2 * b * h * 4 * h, cudnn_lstm_ms),
            (err_b, bwd, bwd_plain,
             2 * (nbytes(xws[0], whs[0], yss[0], css[0], dys[0])
                  + nbytes(*grads[0])),
             2 * t_len * 2 * 2 * b * h * 4 * h,
             lambda x, w: cudnn_lstm_bwd_ms(x, w, dys))):
        dev_ms, host_ms = split_ms(kernel)
        recs.append(dict(err=err, ms=cuda_ms(kernel),
                         plain_ms=cuda_ms(plain, reps=3, iters=5),
                         device_ms=dev_ms, host_ms=host_ms,
                         bound=bound_ms(n_bytes, flops, FP32_FLOP_PER_S
                                        if fp32 else BF16_TC_FLOP_PER_S),
                         bound_fp32_rate=bound_ms(n_bytes, flops),
                         library_ms=lib(xws, whs)))
    return recs


def _wide_k5_check():
    """K5 on fp32 y of K5_WIDE_SHAPE (2.95e9 values: every index past 2^31
    on the stats, apply, bwd reduce and bwd dy paths) against the plain
    versions sliced as `_k5_sliced`; the apply plan's scalar path is held
    at K5_EDGES in k5_epilogue."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(21)
    shape = K5_WIDE_SHAPE
    c = shape[1]
    y = torch.randn(shape, device="cuda", generator=g)
    g_out = torch.randn(shape[:3] + (shape[3] // 2, shape[4] // 2),
                        device="cuda", generator=g)
    gamma = 0.8 * torch.randn(c, device="cuda", generator=g)
    gamma[: c // 3] = -gamma[: c // 3].abs() - 0.1
    beta = 0.3 * torch.randn(c, device="cuda", generator=g)
    g_mu, g_var = (torch.randn(c, device="cuda", generator=g)
                   for _ in range(2))
    _, errs = _k5_sliced(f"K5 fp32 {list(shape)}", y, gamma, beta, g_out,
                         g_mu, g_var, timed=False)
    return dict(shape=list(shape), values=y.numel(),
                past_2_31=y.numel() > 2 ** 31,
                **{f"max_abs_err_{n}": e for n, e in errs.items()})


def frames_tuned_phase():
    """The tuned frames configuration (TUNED: batch 256, --frames_encode
    full, --microbatch 2, bf16) at full width. First its kernels at its
    shapes against their plain versions, timed (the `kernels` line's
    *_tuned entries): K5's four at stages 0 and 1 of a chunk's trunk, y
    [128, 16, 11, 256, 256] and [128, 32, 11, 128, 128] bf16
    (`_k5_sliced`), and K1-fwd and K1-bwd at the chunk's folded rows, B =
    128 x num_seq = 512, T = 16 latent channels, bf16 (`_k1_at`). Then
    `_graph_case` on the configuration: two dispatches of TUNED_K steps
    (the first runs eagerly and captures, the second replays) against
    2 TUNED_K eager steps of a twin from one state_dict, bit for bit under
    cuDNN's deterministic algorithms, launches TUNED_K times the eager
    step's; then eager steps and dispatches timed in turns (those
    algorithms), ms a step, clips/s, peak memory allocated and reserved
    with both models resident, launches a step. Last, `_wide_k5_check`.
    Returns the K5 and K1 records and the graphed launches by kernel."""
    import torch

    from maavss_tpu_torch.config import RunConfig

    os.environ.pop("MAAVSS_S2D_MIN_HW", None)  # the default, 128
    cfg = RunConfig(**TUNED)
    rows = cfg.batch_size // cfg.microbatch
    t_enc = cfg.num_frames + cfg.num_seq - 1
    g = torch.Generator(device="cuda").manual_seed(20)
    k5 = None
    for stage, (ch, hw) in enumerate(((16, 256), (32, 128))):
        shape = (rows, ch, t_enc, hw, hw)
        y, gamma, beta, g_out, g_mu, g_var = _k5_inputs(shape, g, False)
        y, g_out = y.to(torch.bfloat16), g_out.to(torch.bfloat16)
        rep, _ = _k5_sliced(f"K5 bf16 tuned stage {stage}", y, gamma, beta,
                            g_out, g_mu, g_var, timed=True)
        phase("frames_tuned_k5", stage=stage, shape=list(shape),
              **{n: {k: v for k, v in r.items() if k not in ("bytes",
                                                              "flops")}
                 for n, r in rep.items()})
        if k5 is None:
            k5 = rep
        else:  # the two stages' sums, as k5_epilogue's records
            for n, r in rep.items():
                for key in ("ms", "plain_ms", "device_ms", "host_ms",
                            "bytes", "flops"):
                    k5[n][key] += r[key]
                k5[n]["err"] = max(k5[n]["err"], r["err"])
                if r["library_ms"] is not None:
                    k5[n]["library_ms"] += r["library_ms"]
        del y, gamma, beta, g_out, g_mu, g_var, rep
    _k5_finish(k5)  # the bounds of the two stages' summed work
    b_rows = rows * cfg.num_seq
    k1 = _k1_at(b_rows, 16, torch.bfloat16, g)
    phase("frames_tuned_k1", B=b_rows, T=16, H=256, dtype="bfloat16",
          fwd=k1[0], bwd=k1[1])
    torch.cuda.empty_cache()
    graph, totals = _graph_case("frames_tuned_b256_bf16", True, cfg,
                                exact=True, k=TUNED_K, dispatches=2,
                                timed=True, profiled=False)
    torch.cuda.empty_cache()
    wide = _wide_k5_check()
    phase("frames_tuned", **TUNED, graph=graph, k5_wide=wide)
    torch.cuda.empty_cache()
    return k5, k1, totals


# ------------------------------------------------------------ the trainer

TRAINER_WALL = ("ts", "clips_per_sec_per_chip")  # host clock: not compared
TRAINER_LOSSES = ("loss", "a_loss", "v_loss")
TRAINER_RECORD = dict(batch_size=256, fusion_encode="full", pgram_cache=True,
                      dtype="bfloat16", lr_schedule="warmup_cosine",
                      epochs=1, steps_per_epoch=16, val_steps=0)
TRAINER_RECORD_K = 4  # --steps_per_dispatch of the number of record's run
# the trainer's rate: windows of graphed steps on a warmed stream
TRAINER_WINDOWS, TRAINER_WINDOW_STEPS = 3, 32


def _launch_counts():
    from maavss_tpu_torch.ops.counters import kernel_counters

    return {n: getattr(o, a) for n, (o, a) in kernel_counters().items()}


class _Launches:
    """A step or eval function that records each call's kernel launches
    (the wrappers' counters' growth) in `calls`, and adds them to
    `totals`."""

    def __init__(self, fn, totals):
        self.fn, self.totals, self.calls = fn, totals, []

    def __call__(self, *args, **kwargs):
        before = _launch_counts()
        out = self.fn(*args, **kwargs)
        grown = {n: c - before[n] for n, c in _launch_counts().items()
                 if c != before[n]}
        self.calls.append(grown)
        for n, c in grown.items():
            self.totals[n] = self.totals.get(n, 0) + c
        return out


def _plain_fn(fn, k5=False):
    """A plain step or eval as the Trainer calls it (keyword noise): `fn`
    under _plain_k4 (and _plain_k5)."""
    plain = _plain_k4(fn)
    if k5:
        plain = _plain_k5(plain)

    def run(*args, **kwargs):
        return plain(*args, *kwargs.values())
    return run


def _records(cfg, name):
    path = os.path.join(cfg.log_dir, name, "metrics.jsonl")
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in TRAINER_WALL} for line in f]


def _records_close(what, got, want, rtol, keys=TRAINER_LOSSES, wide=()):
    """Each record of `got` against `want` (same steps, kinds and modes):
    `keys` at relative `rtol`, the keys of `wide` at their own (key ->
    rtol); returns the worst relative difference."""
    if len(got) != len(want):
        raise SystemExit(f"{what}: {len(got)} records vs {len(want)}")
    worst = 0.0
    for a, b in zip(got, want):
        for k in ("step", "mode", "epoch"):
            if a.get(k) != b.get(k):
                raise SystemExit(f"{what}: record {a} vs plain {b}")
        for k in list(keys) + ["val_loss"] + list(wide):
            if k not in b:
                continue
            if not math.isfinite(a[k]):
                raise SystemExit(f"{what}: {k} {a[k]} at step {a['step']}")
            rel = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            tol = dict(wide).get(k, rtol)
            if rel > tol:
                raise SystemExit(f"{what}: {k} {a[k]} vs plain {b[k]} at "
                                 f"step {a['step']}: rel {rel} > {tol}")
            worst = max(worst, rel)
    return worst


def _check_calls(what, calls, want):
    for i, got in enumerate(calls):
        if got != want:
            raise SystemExit(f"{what} call {i + 1}: launches {got} != {want}")


def _trainer_store(root, cfg, frame_size, n_videos, seconds):
    from maavss_tpu_torch.data.synthetic import build_synthetic_store

    out = os.path.join(root, f"store-{frame_size}")
    build_synthetic_store(out, cfg, n_videos=n_videos, seconds=seconds,
                          frame_size=frame_size)
    return out


def _trainer_dataset(cfg, root, clip_len):
    from maavss_tpu_torch.data.dataset import AVDataset, split_train_val
    from maavss_tpu_torch.train.setup import load_pgram_store, load_stores

    ds = AVDataset(cfg, *load_stores(cfg), clip_len,
                   cache_dir=os.path.join(root, "clipcache"),
                   pgrams=load_pgram_store(cfg))
    return ds, split_train_val(len(ds), cfg.split, cfg.seed)


def _fit(cfg, ds, split, step, state, name, eval_fn=None, **kwargs):
    """One Trainer run from the store's streams; returns the Trainer."""
    import torch

    from maavss_tpu_torch.train.setup import make_stream
    from maavss_tpu_torch.train.trainer import Trainer

    tr, va = split
    trainer = Trainer(cfg, step, state, run_name=name, eval_fn=eval_fn,
                      **kwargs)
    trainer.fit(make_stream(cfg, ds, tr, cfg.seed,
                            stack=cfg.steps_per_dispatch),
                make_stream(cfg, ds, va, cfg.seed + 1))
    torch.cuda.synchronize()
    return trainer


def _adam_step_bound(t: int, b1: float, b2: float) -> float:
    """The most, in units of lr, that Adam's bias-corrected step t moves an
    element (eps -> 0), over every gradient history: m_hat / sqrt(v_hat) is
    a weighted sum of g_1..g_t over the root of another, at most
    sqrt(sum_i w_i^2 / u_i) by Cauchy-Schwarz (1 at t = 1, 1.0013 at 2)."""
    w = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    u = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return math.sqrt(sum(a * a / c for a, c in zip(w, u)))


def _synced_leaves(what, model, ref, names, tx, step, ref_step):
    """A kernel step and a plain step (each a Trainer's step function) for
    leaves that two implementations legitimately move apart by Adam's
    elementwise bound each way: a BatchNorm-fed conv bias (true gradient
    0) or a BatchNorm shift ahead of another train-mode BatchNorm (a
    near-total cancellation), where rounding noise reaches Adam's eps.
    After plain step t those leaves must lie within twice
    `_adam_step_bound(t)` lr (`tx`'s rate and betas; 1e-6 of the value and
    of lr for rounding) of the kernel step's, and then take the kernel
    step's values, so the difference never compounds and every other leaf
    is held at its own gate. Returns the two steps and a one-element list
    of the largest difference seen."""
    import torch

    lr = tx.lr  # a constant rate
    kernel_vals, worst = [], [0.0]

    def kernel_step(*args, **kwargs):
        out = step(*args, **kwargs)
        params = dict(model.named_parameters())
        kernel_vals.append({n: params[n].detach().clone() for n in names})
        return out

    def plain_step(*args, **kwargs):
        out = ref_step(*args, **kwargs)
        t = len(ref_step.calls)
        bound = 2 * lr * _adam_step_bound(t, tx.b1, tx.b2) * 1.0001
        params = dict(ref.named_parameters())
        with torch.no_grad():
            for n, want in kernel_vals[t - 1].items():
                d = (params[n] - want).abs()
                worst[0] = max(worst[0], d.max().item())
                excess = (d - bound - 1e-6 * (want.abs() + lr)).max().item()
                if excess > 0:
                    raise SystemExit(f"{what}: {n} {d.max().item()} from the "
                                     f"kernels' at step {t}, past Adam's "
                                     f"bound {bound} by {excess}")
                params[n].copy_(want)
        return out
    return kernel_step, plain_step, worst


def _trainer_fusion(root, totals):
    """The fusion flagship (the default RunConfig: window mode, scan) through
    the Trainer, 2 epochs x 4 steps at batch 8, val_steps 2, 'cycle' every
    epoch, with every kernel against the plain versions from one state
    (each its own Trainer, one store, one noise seed): per-step losses and
    val losses within 1e-4 relative; the records, the epoch checkpoints
    and the launches of every step and eval batch exactly. The conv biases
    that feed a train-mode BatchNorm (true gradient 0: K2's exact 0 against
    the plain side's rounding noise, which Adam turns into +-lr) are held
    within Adam's bound each step and then synchronised to the kernels'
    (`_synced_leaves`), as the CPU tests re-sync what float noise drives
    (ROADMAP §3); the kernel side's K2 biases, whose gradient is exactly 0,
    must end where they began with Adam's m and v still 0. Modes 0 and 1
    zero one encoder, whose gradients are then float noise (ROADMAP §3),
    and 'cycle' reaches mode 2 only in a third epoch: parameters are held
    in mode 2 by the train phase, not here."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.train import setup, trainer as trainer_mod
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_fusion_eval, make_fusion_step

    cfg = RunConfig(batch_size=8, epochs=2, steps_per_epoch=4, val_steps=2,
                    mode_freq=1, cb_freq=1, log_dir=os.path.join(root, "runs"))
    store = _trainer_store(root, cfg, cfg.p_size, 12, 4.0)
    cfg = cfg.replace(data_path=store)
    ds, split = _trainer_dataset(cfg, root, cfg.num_frames + cfg.num_seq)
    model, state = setup.build_fusion_state(
        cfg, cfg.batch_size, "cuda", torch.Generator().manual_seed(cfg.seed))
    plain_cfg = _plain_cfg(cfg, False)
    ref = setup.build_fusion(plain_cfg, cfg.batch_size, "cuda",
                             torch.Generator().manual_seed(cfg.seed + 1))
    ref.load_state_dict(model.state_dict())
    ref.lstm.backend = "scan"
    ref_state = create_train_state(ref, plain_cfg, "cuda")
    step = _Launches(make_fusion_step(model, cfg), totals)
    ev = _Launches(make_fusion_eval(model, cfg), totals)
    plain_totals = {}
    ref_step = _Launches(_plain_fn(make_fusion_step(ref, plain_cfg)),
                         plain_totals)
    # the conv biases that feed a train-mode BatchNorm: true gradient 0,
    # rounding noise on the plain side that Adam turns into +-lr a step;
    # the eval's running statistics then carry the difference (1.1e-4 of a
    # val loss at lr 1e-5, NVIDIA H100)
    fed = list(model.bn_fed_biases())
    kernel_step, plain_step, fed_diff = _synced_leaves(
        "trainer fusion", model, ref, fed, state.tx, step, ref_step)
    # K2's (the phasegram encoder's) return exactly 0: Adam from m = v = 0
    # never moves them
    k2_fed = [n for n in fed if n.startswith("phasegram_encoder.")]
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    k2_start = {n: params[n].detach().clone() for n in k2_fed}
    ref_ev = _Launches(_plain_fn(make_fusion_eval(ref, plain_cfg)),
                       plain_totals)
    saves = []
    real_save = trainer_mod.save_checkpoint

    def save(cp_dir, name, st, epoch=0, loss=0.0):
        saves.append((name, int(epoch), int(st.step)))
        return real_save(cp_dir, name, st, epoch, loss)

    trainer_mod.save_checkpoint = save
    try:
        t0 = time.perf_counter()
        _fit(cfg.replace(cp_dir=os.path.join(root, "cp")), ds, split,
             kernel_step, state, "fusion", ev)
        fit_s = time.perf_counter() - t0
        _fit(cfg.replace(cp_dir=os.path.join(root, "cp-plain")), ds, split,
             plain_step, ref_state, "fusion_plain", ref_ev)
    finally:
        trainer_mod.save_checkpoint = real_save
    if any(plain_totals.values()):
        raise SystemExit(f"the plain trainer launched kernels: "
                         f"{plain_totals}")
    for n in k2_fed:
        i = names.index(n)
        if not (torch.equal(params[n], k2_start[n])
                and not state.tx.m[i].any() and not state.tx.v[i].any()):
            raise SystemExit(f"trainer fusion: K2's BN-fed bias {n} moved "
                             f"(its gradient is exactly 0)")
    got, want = _records(cfg, "fusion"), _records(cfg, "fusion_plain")
    worst = _records_close("trainer fusion", got, want, 1e-4)
    steps = [r for r in got if "loss" in r]
    vals = [r for r in got if "val_loss" in r]
    if ([r["step"] for r in steps] != list(range(1, 9))
            or [r["mode"] for r in steps] != [0] * 4 + [1] * 4
            or [r["epoch"] for r in vals] != [0, 1]):
        raise SystemExit(f"trainer fusion records: {got}")
    if saves != [("fusion", 0, 4), ("fusion", 1, 8), ("fusion_plain", 0, 4),
                 ("fusion_plain", 1, 8)]:
        raise SystemExit(f"trainer fusion checkpoints: {saves}")
    saved = torch.load(os.path.join(root, "cp", "fusion.ckpt.pt"),
                       weights_only=True)
    if (saved["epoch"], saved["step"], saved["opt"]["count"]) != (1, 8, 8):
        raise SystemExit("trainer fusion: the last checkpoint holds epoch "
                         f"{saved['epoch']} step {saved['step']}")
    ns, layers = cfg.num_seq, len(model.phasegram_encoder.specs)
    want_step = {"lstm_fwd": ns, "lstm_bwd": ns, "pgenc_train": ns * layers,
                 "pgenc_bwd": ns * layers, "adam": 1, "stft_feat": 1}
    want_eval = {"lstm_fwd": ns, "pgenc_eval": ns * layers, "stft_feat": 1}
    _check_calls("trainer fusion step", step.calls, want_step)
    _check_calls("trainer fusion eval", ev.calls, want_eval)
    phase("trainer_fusion", batch=cfg.batch_size, epochs=cfg.epochs,
          steps_per_epoch=cfg.steps_per_epoch, val_steps=cfg.val_steps,
          mode_schedule="cycle", lr=cfg.learning_rate,
          noise_scalar=cfg.noise_scalar, clips=len(ds),
          losses=[r["loss"] for r in steps],
          plain_losses=[r["loss"] for r in want if "loss" in r],
          val_losses=[r["val_loss"] for r in vals],
          worst_rel_vs_plain=worst, tol=1e-4, checkpoints=saves[:2],
          bn_fed_biases=len(fed), bn_fed_max_abs_diff=fed_diff[0],
          k2_bn_fed_biases_unmoved=len(k2_fed), launches_per_step=want_step,
          launches_per_val_batch=want_eval, fit_s=fit_s)
    return cfg, ds, split


def _snapshot(state):
    """Copies of every tensor a load restores: the state_dict, m, v and the
    device count."""
    return ({k: v.detach().clone() for k, v in
             state.model.state_dict().items()},
            [t.clone() for t in state.tx.m], [t.clone() for t in state.tx.v],
            state.tx.count_tensor.clone())


def _equal_to_checkpoint(what, state, saved):
    """Every parameter, buffer, m, v and the device count of `state` equal
    the checkpoint's bit for bit."""
    import torch

    names = [n for n, _ in state.model.named_parameters()]
    pairs = [(k, v, saved["model"][k])
             for k, v in state.model.state_dict().items()]
    pairs += [(f"m {n}", t, saved["opt"]["m"][n])
              for n, t in zip(names, state.tx.m)]
    pairs += [(f"v {n}", t, saved["opt"]["v"][n])
              for n, t in zip(names, state.tx.v)]
    for k, a, b in pairs:
        if not torch.equal(a.cpu(), b):
            raise SystemExit(f"{what}: {k} differs from the checkpoint")
    count = saved["opt"]["count"]
    if (state.tx.count != count or float(state.tx.count_tensor) != count
            or state.step != saved["step"]):
        raise SystemExit(f"{what}: count {state.tx.count} / "
                         f"{float(state.tx.count_tensor)}, step "
                         f"{state.step} vs {count}, {saved['step']}")


def _resume_sequence(cfg, ds, split, root, tag, totals, check=False):
    """The signal-and-resume sequence at --steps_per_dispatch 2: a run that
    a SIGTERM (sent from a media_fn at global step 6, during epoch 1)
    stops with a checkpoint; every restored tensor perturbed; then -c
    --cp_load_opt into the same state, step (its graphs captured) and
    generator, to the end. With `check`: after the load every tensor
    equals the checkpoint bit for bit, and the first dispatch after it (a
    graph replay) equals two eager steps of a fresh state loaded from the
    same checkpoint, bit for bit. Returns both runs' records."""
    import signal

    import torch

    from maavss_tpu_torch.exp.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )
    from maavss_tpu_torch.train import setup
    from maavss_tpu_torch.train.steps import make_fusion_eval, make_fusion_step

    cfg = cfg.replace(steps_per_dispatch=2, cp_dir=os.path.join(root, tag),
                      log_dir=os.path.join(root, f"runs-{tag}"))
    model, state = setup.build_fusion_state(
        cfg, cfg.batch_size, "cuda", torch.Generator().manual_seed(cfg.seed))
    kstep = make_fusion_step(model, cfg)
    ev = make_fusion_eval(model, cfg)
    gen = torch.Generator(device="cuda")

    def media(st, batch, generator, global_step):
        if global_step == 6:
            os.kill(os.getpid(), signal.SIGTERM)

    first = _fit(cfg, ds, split, _Launches(kstep, totals), state, "seq", ev,
                 media_fn=media, generator=gen)
    if first._preempted != signal.SIGTERM or state.step != 6:
        raise SystemExit(f"resume {tag}: the SIGTERM run stopped at step "
                         f"{state.step}")
    saved_path = latest_checkpoint(cfg.cp_dir)
    saved = torch.load(saved_path, weights_only=True)
    with torch.no_grad():
        for t in list(state.model.state_dict().values()) + state.tx.m \
                + state.tx.v:
            if t.is_floating_point():
                t.add_(0.5)
    state.tx.count = 99
    state.step = 99
    out = {}
    recorder = _Launches(kstep, totals)

    def first_dispatch(st, batch, mode, generator, noise=None):
        if not out:
            out["batch"] = {k: v.copy() for k, v in batch.items()}
            out["mode"] = mode
        res = recorder(st, batch, mode, generator, noise=noise)
        if "metrics" not in out:
            out["metrics"] = {k: v.clone() for k, v in res[1].items()}
            out["after"] = _snapshot(st)
        return res

    from maavss_tpu_torch.train.trainer import Trainer

    rcfg = cfg.replace(c=True, cp_load_opt=True)
    resumed = Trainer(rcfg, first_dispatch, state, run_name="seq_resumed",
                      eval_fn=ev, generator=gen)
    if check:
        _equal_to_checkpoint("resume into a captured state", state, saved)
    if resumed.epoch != 1 or resumed.mode != 0:
        raise SystemExit(f"resume {tag}: epoch {resumed.epoch} mode "
                         f"{resumed.mode}, want 1 and 0 (JAX's quirks)")
    captures = kstep.captures
    tr, va = split
    resumed.fit(setup.make_stream(rcfg, ds, tr, rcfg.seed, stack=2),
                setup.make_stream(rcfg, ds, va, rcfg.seed + 1))
    torch.cuda.synchronize()
    if kstep.captures != captures:
        raise SystemExit(f"resume {tag}: the resumed run captured again")
    if check:
        # a fresh state loaded from the same checkpoint, two eager steps
        _, twin = setup.build_fusion_state(
            cfg, cfg.batch_size, "cuda",
            torch.Generator().manual_seed(cfg.seed + 1))
        load_checkpoint(cfg.cp_dir, twin, auto=False, path=saved_path,
                        load_opt=True)
        _equal_to_checkpoint("resume into a fresh state", twin, saved)
        eager = make_fusion_step(twin.model, cfg, k_steps=1)
        tgen = torch.Generator(device="cuda").manual_seed(cfg.seed)
        metrics = []
        for j in range(2):
            twin, m = eager(twin, {k: v[j] for k, v in out["batch"].items()},
                            out["mode"], tgen)
            metrics.append(m)
        torch.cuda.synchronize()
        for k, v in out["metrics"].items():
            if not torch.equal(v, torch.stack([m[k] for m in metrics])):
                raise SystemExit(f"resume: the first replay's {k} "
                                 f"{v.tolist()} vs eager "
                                 f"{[float(m[k]) for m in metrics]}")
        sd, mm, vv, count = out["after"]
        after = _snapshot(twin)
        for k, a in sd.items():
            if not torch.equal(a, after[0][k]):
                raise SystemExit(f"resume: {k} after the first replay "
                                 f"differs from the eager steps'")
        for a, b in zip(mm + vv + [count], after[1] + after[2] + [after[3]]):
            if not torch.equal(a, b):
                raise SystemExit("resume: Adam's state after the first "
                                 "replay differs from the eager steps'")
    return _records(cfg, "seq") + _records(rcfg, "seq_resumed")


def _trainer_resume(cfg, ds, split, root, totals):
    """The resume checks of `_resume_sequence`, under cuDNN's deterministic
    algorithms, and the same sequence run twice: equal records."""
    import torch

    torch.backends.cudnn.deterministic = True
    try:
        runs = [_resume_sequence(cfg, ds, split, root, f"seq{i}", totals,
                                 check=i == 0) for i in range(2)]
    finally:
        torch.backends.cudnn.deterministic = False
    if runs[0] != runs[1]:
        raise SystemExit("resume: two runs of the signal-and-resume "
                         "sequence wrote different records")
    steps = [r["step"] for r in runs[0] if "loss" in r]
    if steps != list(range(1, 7)) + list(range(7, 11)) or not any(
            r.get("preempted") for r in runs[0]):
        raise SystemExit(f"resume records: steps {steps}")
    phase("trainer_resume", steps_per_dispatch=2, sigterm_at_step=6,
          resumed_at_epoch=1, records=len(runs[0]), step_records=steps,
          restored_bit_for_bit=True, first_replay_equals_eager=True,
          two_sequences_equal=True)


def _trainer_record(root, totals):
    """The number of record's configuration (TRAINER_RECORD, batch 256)
    through the Trainer, from the store's phasegram rows, which
    tools/save_phasegrams_torch.py builds on the card first (held against
    phasegram_cumsum of the frames within float16's rounding). Under
    cuDNN's deterministic algorithms an eager run (K = 1) and a graphed
    run (K = TRAINER_RECORD_K) from one state write the same records bit
    for bit, with one capture while the rate changes every step. Then,
    with cuDNN's default algorithms, on a stream whose prefetch thread is
    already running, TRAINER_WINDOWS windows of TRAINER_WINDOW_STEPS
    graphed steps (every dispatch a replay), each a Trainer's fit closed by
    a synchronize, give the trainer's clips/s on the host's clock (median
    and spread) and the host's batch time (PhaseTimer); one more epoch the
    card's idle share over its 4 dispatches (exp/profiling.trace via
    profile_phase), and tools/bench_torch.py measures the same
    configuration."""
    import numpy as np
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.dataset import Subset, batches
    from maavss_tpu_torch.data.frame_shards import FrameShardStore
    from maavss_tpu_torch.exp.profiling import PhaseTimer
    from maavss_tpu_torch.ops.phasegram import phasegram_cumsum
    from maavss_tpu_torch.train import setup
    from maavss_tpu_torch.train.steps import make_fusion_step
    from tools import bench_torch, save_phasegrams_torch

    cfg = RunConfig(**TRAINER_RECORD, log_dir=os.path.join(root, "runs"),
                    cp_dir=os.path.join(root, "cp-record"), no_save=True)
    # the fusion trainer's store, its frames at p_size
    cfg = cfg.replace(data_path=os.path.join(root, f"store-{cfg.p_size}"))
    t0 = time.perf_counter()
    out = save_phasegrams_torch.build_pgram_store(cfg.data_path, cfg.p_size)
    rows_s = time.perf_counter() - t0
    frames = FrameShardStore(os.path.join(cfg.data_path, "frames"))
    rows = FrameShardStore(out)
    rows_err = 0.0
    for v in range(len(frames)):
        idx = np.arange(frames.num_frames(v))
        fr = torch.from_numpy(frames.read(v, idx)).cuda().float() / 255.0
        want = phasegram_cumsum(fr[None])[0].cpu()
        got = torch.from_numpy(rows.read(v, idx).astype(np.float32))
        rows_err = max(rows_err, (got - want).abs().max().item())
    if rows_err > 2.0 ** -12:  # values in [-1/2, 1/2]: half a float16 ulp
        raise SystemExit(f"phasegram rows off by {rows_err}")
    ds, split = _trainer_dataset(cfg, root, cfg.num_frames + cfg.num_seq)

    def state_pair():
        return setup.build_fusion_state(
            cfg, cfg.batch_size, "cuda",
            torch.Generator().manual_seed(cfg.seed))

    torch.backends.cudnn.deterministic = True
    try:
        rates = {}
        runs = {}
        for k in (1, TRAINER_RECORD_K):
            kcfg = cfg.replace(steps_per_dispatch=k)
            model, state = state_pair()
            step = make_fusion_step(model, kcfg)
            seen = rates.setdefault(k, [])

            def rated(st, batch, mode, generator, noise=None, _s=step,
                      _seen=seen):
                res = _s(st, batch, mode, generator, noise=noise)
                _seen.append((st.step, st.tx.bc[2].item()))
                return res

            trainer = _fit(kcfg, ds, split, _Launches(rated, totals), state,
                           f"record_k{k}", mode_schedule="fixed")
            runs[k] = (_records(kcfg, f"record_k{k}"), step, model, state,
                       trainer.generator)
    finally:
        torch.backends.cudnn.deterministic = False
    eager, graphed = runs[1][0], runs[TRAINER_RECORD_K][0]
    kstep = runs[TRAINER_RECORD_K][1]
    if eager != graphed or len(graphed) != cfg.steps_per_epoch:
        raise SystemExit("record: the graphed run's records differ from the "
                         "eager run's")
    by_step = dict(rates[1])
    if (kstep.captures != 1 or any(by_step[n] != r for n, r in
                                   rates[TRAINER_RECORD_K])
            or len(set(by_step.values())) != len(by_step)):
        raise SystemExit(f"record: captures {kstep.captures}, rates eager "
                         f"{rates[1]} graphed {rates[TRAINER_RECORD_K]}")
    del runs[1]
    torch.cuda.empty_cache()
    _, kstep, model, state, gen = runs[TRAINER_RECORD_K]
    kcfg = cfg.replace(steps_per_dispatch=TRAINER_RECORD_K)
    timer = PhaseTimer()
    tr, va = split

    def timed(it):
        while True:
            with timer.phase("batch_wait"):
                b = next(it)
            yield b

    from maavss_tpu_torch.train.trainer import Trainer

    stream = setup.make_stream(kcfg, ds, tr, kcfg.seed,
                               stack=TRAINER_RECORD_K)
    next(stream)  # the prefetch thread running before the first window
    stream = timed(stream)
    wcfg = kcfg.replace(steps_per_epoch=TRAINER_WINDOW_STEPS)
    window_rates = []
    for w in range(TRAINER_WINDOWS):
        steady = Trainer(wcfg, _Launches(kstep, totals), state,
                         run_name=f"record_steady{w}", mode_schedule="fixed",
                         generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steady.fit(stream)
        torch.cuda.synchronize()
        window_rates.append(wcfg.batch_size * wcfg.steps_per_epoch
                            / (time.perf_counter() - t0))
    clips_per_s = statistics.median(window_rates)
    produce = PhaseTimer()
    src = batches(Subset(ds, tr), kcfg.batch_size, seed=kcfg.seed)
    for _ in range(8):
        with produce.phase("batch_build"):
            group = [next(src) for _ in range(TRAINER_RECORD_K)]
        with produce.phase("stack"):
            setup.stack_batches(group)
    profiled = Trainer(kcfg, _Launches(kstep, totals), state,
                       run_name="record_profiled", mode_schedule="fixed",
                       generator=gen)
    it = setup.make_stream(kcfg, ds, tr, kcfg.seed + 2,
                           stack=TRAINER_RECORD_K)
    next(it)  # the stream's prefetch thread running before the window
    profile_phase("trainer_record_profile", lambda: profiled.fit(it),
                  calls=1)
    if kstep.captures != 1:
        raise SystemExit("record: the steady runs captured again")
    del model, state, kstep, runs, steady, profiled, gen
    torch.cuda.empty_cache()
    bench = bench_torch.measure(
        cfg.batch_size, steps=4 * TRAINER_RECORD_K, windows=3,
        env={"MAAVSS_BENCH_MULTISTEP": str(TRAINER_RECORD_K)})
    host = {**timer.summary(), **produce.summary()}
    phase("trainer_record", **TRAINER_RECORD,
          steps_per_dispatch=TRAINER_RECORD_K, clips=len(ds),
          pgram_rows_s=rows_s, pgram_rows_max_abs_err=rows_err,
          graphed_equals_eager=True, captures=1,
          rates=[r for _, r in rates[1]],
          trainer_clips_per_s=clips_per_s,
          trainer_clips_per_s_windows=window_rates,
          trainer_spread=(max(window_rates) - min(window_rates)) / clips_per_s,
          trainer_window_steps=TRAINER_WINDOW_STEPS,
          bench_clips_per_s=bench["value"], bench_spread=bench.get("spread"),
          host_s_per_dispatch_wait=host["time_batch_wait"],
          host_s_per_batch_build=host["time_batch_build"]
          / TRAINER_RECORD_K,
          host_s_per_dispatch_stack=host["time_stack"],
          graphed_step_ms_trainer=1e3 * kcfg.batch_size / clips_per_s)


def _trainer_frames(root, totals):
    """The frames family through the Trainer (tools/fit_torch.py --model
    frames: clips of num_frames + num_seq frames, the frame size read from
    the store, latent width 16, no eval), framesize 256, batch 8, 1 epoch x
    2 steps, 'random01' (mode 2 first, as JAX starts it), every kernel
    against the plain versions from one state: the records' losses and
    norms at 1e-4 relative, the visual encoder's gradient norms at 2e-3
    (frames_train's encoder gate: near-total cancellations at full width),
    the launches of every step exactly, and after the run every leaf as
    frames_train holds it (`_frames_params_close`: the encoder's at 2e-3,
    the rest at 1e-4). The encoder's BatchNorm shifts ahead of the next
    stage's train-mode BatchNorm have near-zero gradients that Adam turns
    into +-lr either way (one read 2.25e-3 relative L2 after 2 steps at
    lr 1e-5, NVIDIA H100): those are held within Adam's bound each step
    and synchronised (`_synced_leaves`), as the fusion phase holds its
    BatchNorm-fed conv biases."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.train import setup
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_frames_step

    os.environ.pop("MAAVSS_S2D_MIN_HW", None)  # the default, 128
    cfg = RunConfig(batch_size=8, epochs=1, steps_per_epoch=2, val_steps=0,
                    cb_freq=1, log_dir=os.path.join(root, "runs"),
                    cp_dir=os.path.join(root, "cp-frames"))
    store = _trainer_store(root, cfg, 256, 3, 2.0)
    cfg = cfg.replace(data_path=store)
    ds, split = _trainer_dataset(
        cfg, root, cfg.num_frames + cfg.num_seq + 2 * cfg.frames_halo)
    frame_size = ds[0]["frames"].shape[-1]
    model, state = setup.build_frames_state(
        cfg, cfg.batch_size, frame_size,
        generator=torch.Generator().manual_seed(cfg.seed))
    plain_cfg = _plain_cfg(cfg, True)
    ref = setup.build_frames_model(plain_cfg, cfg.batch_size, frame_size,
                                   generator=torch.Generator().manual_seed(
                                       cfg.seed + 1))
    ref.load_state_dict(model.state_dict())
    ref.lstm.backend = "scan"
    ref_state = create_train_state(ref, plain_cfg, "cuda")
    step = _Launches(make_frames_step(model, cfg), totals)
    plain_totals = {}
    ref_step = _Launches(_plain_fn(make_frames_step(ref, plain_cfg), k5=True),
                         plain_totals)
    # stages 0-3's shifts each feed the next stage's conv and BatchNorm
    shifts = [f"visual_encoder.TorchBatchNorm_{i}.BatchNorm_0.bias"
              for i in range(len(model.visual_encoder.stages) - 1)]
    kernel_step, plain_step, shift_diff = _synced_leaves(
        "trainer frames", model, ref, shifts, state.tx, step, ref_step)
    _fit(cfg, ds, split, kernel_step, state, "frames",
         mode_schedule="random01")
    _fit(cfg.replace(cp_dir=os.path.join(root, "cp-frames-plain")), ds,
         split, plain_step, ref_state, "frames_plain",
         mode_schedule="random01")
    if any(plain_totals.values()):
        raise SystemExit(f"the plain frames trainer launched kernels: "
                         f"{plain_totals}")
    leaves = _frames_params_close(model, ref, 1e-4, 2e-3,
                                  what="trainer frames: after the run")
    got, want = _records(cfg, "frames"), _records(cfg, "frames_plain")
    enc = ("grad_norm", "grad_norm/visual_encoder")
    norms = [k for k in want[0] if k.startswith(("grad_norm", "param_norm"))
             and k not in enc]
    worst = _records_close("trainer frames", got, want, 1e-4,
                           keys=TRAINER_LOSSES + tuple(norms),
                           wide={k: 2e-3 for k in enc})
    ns = cfg.num_seq
    want_step = {"lstm_fwd": ns, "lstm_bwd": ns, "adam": 1, "stft_feat": 1,
                 **{f"epilogue_{n}": 2 * ns for n in
                    ("stats", "apply", "bwd_reduce", "bwd_dy")}}
    _check_calls("trainer frames step", step.calls, want_step)
    phase("trainer_frames", batch=cfg.batch_size, framesize=frame_size,
          latent=16, steps=cfg.steps_per_epoch, mode_schedule="random01",
          modes=[r["mode"] for r in got], losses=[r["loss"] for r in got],
          plain_losses=[r["loss"] for r in want], worst_rel_vs_plain=worst,
          leaves_worst_rel_l2_encoder=leaves[0],
          leaves_worst_rel_l2_rest=leaves[1], bn_shifts=len(shifts),
          bn_shift_max_abs_diff=shift_diff[0], launches_per_step=want_step)


def trainer_phase():
    """The trainer (train/trainer.py) on the main paths, in a temporary
    directory: `_trainer_fusion`, `_trainer_resume`, `_trainer_record` and
    `_trainer_frames`. Returns the kernels' launches in its runs with the
    kernels (the plain runs launch none), by counter name."""
    totals = {}
    with tempfile.TemporaryDirectory(prefix="maavss_trainer_") as root:
        t0 = time.perf_counter()
        cfg, ds, split = _trainer_fusion(root, totals)
        _trainer_resume(cfg, ds, split, root, totals)
        _trainer_record(root, totals)
        _trainer_frames(root, totals)
        phase("trainer", launches=totals, s=time.perf_counter() - t0)
    return totals


# the evaluation plane (eval_plane)
EVAL_DB_TOL, EVAL_AUDIO_RTOL = 1e-3, 1e-4
EVAL_OPTIONS = (dict(rnn_cell="gru"), dict(rnn_cell="none"),
                dict(attn_diff=True), dict(compress_audio=True))
QC_STEPS, QC_EVAL_EVERY = 100, 50
QC_ARGS = ["--data_path", "synthetic:8", "-b", "32", "-lr", "1e-3"]


class _Recorded:
    """`maavss_tpu_torch.train.infer.make_separator` replaced, while in use,
    by one whose separators record each call's outputs (si_sdr and
    audio_out, on the host) in `calls`, and the host clock's start and
    seconds of each call, the card synchronised before and after, in
    `starts` and `seconds`; `last` is the last call's separator and
    arguments, and `ms()` its time by CUDA events over repeated calls."""

    def __init__(self):
        self.calls, self.starts, self.seconds = [], [], []

    def __enter__(self):
        import torch

        from maavss_tpu_torch.train import infer

        self.kept = make = infer.make_separator

        def recording(*args, **kwargs):
            separate = make(*args, **kwargs)

            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = separate(*a, **k)
                torch.cuda.synchronize()
                self.starts.append(t0)
                self.seconds.append(time.perf_counter() - t0)
                self.last = (separate, a, k)
                self.calls.append({key: out[key].detach().float().cpu()
                                   for key in ("si_sdr", "audio_out")})
                return out
            return run

        infer.make_separator = recording
        return self

    def __exit__(self, *exc):
        from maavss_tpu_torch.train import infer

        infer.make_separator = self.kept

    def ms(self, wrap=None):
        """The last call's separator timed on its arguments, under `wrap`
        (`_plain_env` for a plain run's)."""
        separate, a, k = self.last
        fn = wrap(separate) if wrap else separate
        return cuda_ms(lambda: fn(*a, **k), reps=3, iters=3)


def _plain_env(fn):
    """`fn` under _plain_k4 and with MAAVSS_LSTM=scan (the LSTM's plain
    recurrence in the models an entry point builds itself)."""
    plain = _plain_k4(fn)

    def run(*args):
        kept = os.environ.get("MAAVSS_LSTM")
        os.environ["MAAVSS_LSTM"] = "scan"
        try:
            return plain(*args)
        finally:
            if kept is None:
                os.environ.pop("MAAVSS_LSTM")
            else:
                os.environ["MAAVSS_LSTM"] = kept
    return run


def _grown(before):
    """The kernel launches since `before` (a `_launch_counts()`), by name,
    those that grew."""
    return {n: c - before[n] for n, c in _launch_counts().items()
            if c != before[n]}


def _separations_close(what, got, want):
    """Per call, every clip's SI-SDR within EVAL_DB_TOL dB and audio_out
    within EVAL_AUDIO_RTOL relative L2; returns the worst of each."""
    if len(got) != len(want) or not got:
        raise SystemExit(f"{what}: {len(got)} separator calls against "
                         f"{len(want)}")
    db, rel = 0.0, 0.0
    for g, w in zip(got, want):
        if not bool(g["si_sdr"].isfinite().all()):
            raise SystemExit(f"{what}: SI-SDR {g['si_sdr'].tolist()}")
        db = max(db, (g["si_sdr"] - w["si_sdr"]).abs().max().item())
        rel = max(rel, _rel_l2(g["audio_out"], w["audio_out"]))
    if db > EVAL_DB_TOL or rel > EVAL_AUDIO_RTOL:
        raise SystemExit(f"{what}: SI-SDR {db} dB apart (gate "
                         f"{EVAL_DB_TOL}), audio_out {rel} rel L2 (gate "
                         f"{EVAL_AUDIO_RTOL})")
    return db, rel


def _eval_checkpoint(cfg, frames_model, frame_size, name):
    """A checkpoint of the flagship of `cfg`, seeded, its BatchNorm running
    statistics seeded random (every BatchNorm matters), written with
    exp/checkpoint.save_checkpoint; returns cfg reading it."""
    import torch

    from maavss_tpu_torch.exp.checkpoint import save_checkpoint
    from maavss_tpu_torch.train import setup

    gen = torch.Generator().manual_seed(cfg.seed)
    if frames_model:
        model, state = setup.build_frames_state(cfg, cfg.batch_size,
                                                frame_size, device="cuda",
                                                generator=gen)
    else:
        model, state = setup.build_fusion_state(cfg, cfg.batch_size, "cuda",
                                                gen)
    g = torch.Generator().manual_seed(cfg.seed + 5)
    with torch.no_grad():
        for n, buf in model.named_buffers():
            if n.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.2)
            elif n.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    path = save_checkpoint(cfg.cp_dir, name, state)
    del model, state
    return cfg.replace(checkpoint=path)


def _eval_tool(what, cfg, kind, want):
    """tools/evaluate_torch.py's evaluate with every kernel and with the
    plain versions (ConvStack, the LSTM scan, K4's), from one checkpoint:
    the separators' outputs close (`_separations_close`), the kernel run's
    launches exactly `want`, the plain run's none, the JSON lines alike,
    and the example wavs read back: two pairs, the output the first two
    clips' audio_out through 16-bit PCM."""
    import numpy as np
    import torch

    from maavss_tpu_torch.data.wavio import read_wav
    from tools.evaluate_torch import evaluate

    plain_cfg = cfg.replace(pgenc_kernel="xla", log_dir=cfg.log_dir + "_plain")
    with _Recorded() as got:
        before = _launch_counts()
        t0 = time.perf_counter()
        summary = evaluate(cfg, kind, "cuda")
        seconds = time.perf_counter() - t0
        launches = _grown(before)
    with _Recorded() as want_calls:
        before = _launch_counts()
        plain = _plain_env(evaluate)(plain_cfg, kind, "cuda")
        if _grown(before):
            raise SystemExit(f"{what}: the plain run launched "
                             f"{_grown(before)}")
    if launches != want:
        raise SystemExit(f"{what}: launches {launches} != {want}")
    db, rel = _separations_close(what, got.calls, want_calls.calls)
    if summary["n_clips"] != plain["n_clips"] or abs(
            summary["si_sdr_mean"] - plain["si_sdr_mean"]) > EVAL_DB_TOL:
        raise SystemExit(f"{what}: {summary} against plain {plain}")
    for b in range(2):
        out, sr = read_wav(os.path.join(summary["wav_dir"],
                                        f"example_{b + 1}_output.wav"))
        ref, sr2 = read_wav(os.path.join(summary["wav_dir"],
                                         f"example_{b + 1}_ground_truth.wav"))
        sent = np.clip(got.calls[0]["audio_out"][b].numpy(), -1.0, 1.0)
        if (sr, sr2) != (cfg.samplerate,) * 2 or out.shape != (
                1, sent.shape[-1]) or ref.shape != out.shape or np.abs(
                out[0] - sent).max() > 2.0 / 32767:
            raise SystemExit(f"{what}: example {b + 1} wavs {out.shape}, "
                             f"{ref.shape} at {sr}, {sr2} Hz")
    torch.cuda.synchronize()
    return dict(batch=cfg.batch_size, batches=len(got.calls),
                batch_ms=got.ms(), plain_batch_ms=want_calls.ms(_plain_env),
                si_sdr_mean=summary["si_sdr_mean"],
                plain_si_sdr_mean=plain["si_sdr_mean"],
                n_clips=summary["n_clips"], si_sdr_max_diff_db=db,
                audio_out_rel_l2=rel, launches=launches, wall_s=seconds,
                first_calls_ms=[1e3 * t for t in got.seconds])


def _separate_tool(what, cfg, wav, frames_dir, want_per_batch, out_dir):
    """tools/separate_torch.py's separate_file on `wav` with every kernel
    and with the plain versions, from one checkpoint: the written wavs
    within EVAL_AUDIO_RTOL relative L2, the kernel run's launches
    `want_per_batch` times its batches."""
    from maavss_tpu_torch.data.wavio import read_wav
    from tools.separate_torch import separate_file

    outs, runs = {}, {}
    for label, fn, c, wrap in (
            ("kernels", separate_file, cfg, None),
            ("plain", _plain_env(separate_file),
             cfg.replace(pgenc_kernel="xla"), _plain_env)):
        path = os.path.join(out_dir, f"{label}.wav")
        with _Recorded() as rec:
            before = _launch_counts()
            t0 = time.perf_counter()
            summary = fn(c, wav, path, frames_dir, wav, "cuda", False)
            runs[label] = dict(summary, wall_s=time.perf_counter() - t0,
                               separator_s=sum(rec.seconds),
                               batches=len(rec.calls),
                               launches=_grown(before),
                               batch_ms=rec.ms(wrap))
        outs[label], _ = read_wav(path)
    k, p = runs["kernels"], runs["plain"]
    want = {n: c * k["batches"] for n, c in want_per_batch.items()}
    if k["launches"] != want or p["launches"]:
        raise SystemExit(f"{what}: launches {k['launches']} (want {want}), "
                         f"plain {p['launches']}")
    rel = _rel_l2(outs["kernels"], outs["plain"])
    if rel > EVAL_AUDIO_RTOL or abs(k["si_sdr"] - p["si_sdr"]) > EVAL_DB_TOL:
        raise SystemExit(f"{what}: wavs {rel} rel L2 apart, SI-SDR "
                         f"{k['si_sdr']} against {p['si_sdr']}")
    seconds_of_audio = k["n_samples"] / k["sr"]
    return dict(tiles=k["tiles"], batches=k["batches"],
                seconds_of_audio=seconds_of_audio, wav_rel_l2=rel,
                si_sdr=k["si_sdr"], plain_si_sdr=p["si_sdr"],
                launches=k["launches"], wall_s=k["wall_s"],
                plain_wall_s=p["wall_s"], separator_s=k["separator_s"],
                batch_ms=k["batch_ms"], plain_batch_ms=p["batch_ms"],
                s_per_s_audio=k["batch_ms"] * k["batches"] / 1e3
                / seconds_of_audio,
                plain_s_per_s_audio=p["batch_ms"] * p["batches"] / 1e3
                / seconds_of_audio)


def _option_pair(cfg, frames_model):
    """(model, ref, plain cfg): the flagship of `cfg` with every kernel and
    its plain twin from the same state_dict (`_train_pair`'s plain
    versions)."""
    import copy

    import torch

    from maavss_tpu_torch.train import setup

    plain_cfg = _plain_cfg(cfg, frames_model)
    gen = torch.Generator().manual_seed(cfg.seed)
    if frames_model:
        model = setup.build_frames_model(cfg, cfg.batch_size, device="cuda",
                                         generator=gen)
        ref = copy.deepcopy(model)
    else:
        model = setup.build_fusion(cfg, cfg.batch_size, "cuda", gen)
        ref = setup.build_fusion(plain_cfg, cfg.batch_size, "cuda",
                                 torch.Generator().manual_seed(cfg.seed + 1))
    ref.load_state_dict(model.state_dict())
    ref.lstm.backend = "scan"
    return model, ref, plain_cfg


def _option_case(what, cfg, frames_model, pair, steps=2):
    """`steps` train steps (mode 2) of the flagship of `cfg` with every
    kernel against the plain versions, from one state_dict (`pair`, synced
    again and given fresh optimizer states): losses within 1e-4 relative;
    then one separator batch of each from one state_dict: every clip's
    SI-SDR within EVAL_DB_TOL dB, audio_out within EVAL_AUDIO_RTOL. The
    launches of each kernel step and of the batch, by name; the plain
    side launches none. Returns the record, the kernel step, its state and
    a batch (for timing)."""
    import torch

    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.train.infer import make_separator
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step

    model, ref, plain_cfg = pair
    plain_cfg = plain_cfg.replace(**{k: getattr(cfg, k) for k in (
        "rnn_cell", "attn_diff", "compress_audio")})
    ref.load_state_dict(model.state_dict())
    make = make_frames_step if frames_model else make_fusion_step
    state = create_train_state(model, cfg, "cuda")
    ref_state = create_train_state(ref, plain_cfg, "cuda")
    step = make(model, cfg, device="cuda")
    ref_step = _plain_k4(make(ref, plain_cfg, device="cuda"))
    if frames_model:
        ref_step = _plain_k5(ref_step)
    frame_size = cfg.framesize if frames_model else None
    batches = [synthetic_av_batch(cfg, cfg.batch_size, seed=cfg.seed + i,
                                  frame_size=frame_size)
               for i in range(steps + 1)]
    losses, ref_losses, step_launches = [], [], None
    for batch in batches[:steps]:
        before = _launch_counts()
        state, m = step(state, batch, 2)
        torch.cuda.synchronize()
        launched = _grown(before)
        if step_launches not in (None, launched):
            raise SystemExit(f"{what}: step launches {launched} != "
                             f"{step_launches}")
        step_launches = launched
        before = _launch_counts()
        ref_state, rm = ref_step(ref_state, batch, 2)
        if _grown(before):
            raise SystemExit(f"{what}: the plain step launched "
                             f"{_grown(before)}")
        losses.append(float(m["loss"]))
        ref_losses.append(float(rm["loss"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    if rel > 1e-4 or not all(map(math.isfinite, losses)):
        raise SystemExit(f"{what}: losses {losses} against plain "
                         f"{ref_losses} (rel {rel} > 1e-4)")
    ref.load_state_dict(model.state_dict())
    sep_batch = {k: torch.from_numpy(v).cuda()
                 for k, v in batches[steps].items()}
    before = _launch_counts()
    got = make_separator(model, cfg, frames_model)(sep_batch)
    torch.cuda.synchronize()
    sep_launches = _grown(before)
    before = _launch_counts()
    want = _plain_k4(make_separator(ref, plain_cfg, frames_model))(sep_batch)
    if _grown(before):
        raise SystemExit(f"{what}: the plain separator launched "
                         f"{_grown(before)}")
    db, audio_rel = _separations_close(
        what, *([{k: out[k].float().cpu() for k in ("si_sdr", "audio_out")}]
                for out in (got, want)))
    return dict(losses=losses, plain_losses=ref_losses, loss_rel_diff=rel,
                si_sdr=got["si_sdr"].tolist(), si_sdr_max_diff_db=db,
                audio_out_rel_l2=audio_rel, launches_per_step=step_launches,
                launches_per_batch=sep_launches), (step, state, batches[0])


def _want_step(cfg, frames_model):
    """Each kernel's launches in a window-mode train step of the flagship
    of `cfg` (K1 none under --rnn_cell gru|none)."""
    ns = cfg.num_seq
    k1 = ns if cfg.rnn_cell == "lstm" else 0
    want = dict(lstm_fwd=k1, lstm_bwd=k1, adam=1, stft_feat=1)
    if frames_model:
        want.update({f"epilogue_{n}": 2 * ns for n in (
            "stats", "apply", "bwd_reduce", "bwd_dy")})
    else:
        want.update(pgenc_train=10 * ns, pgenc_bwd=10 * ns)
    return {n: c for n, c in want.items() if c}


def _want_batch(cfg, frames_model):
    """Each kernel's launches in a window-mode separator batch."""
    ns = cfg.num_seq
    want = dict(lstm_fwd=ns if cfg.rnn_cell == "lstm" else 0, stft_feat=1,
                pgenc_eval=0 if frames_model else 10 * ns)
    return {n: c for n, c in want.items() if c}


def _option_cases(totals):
    """--rnn_cell gru, --rnn_cell none, --attn_diff and --compress_audio on
    both flagships at full width, fp32, batch 8, noise 0 (`_option_case`);
    the fusion step with the LSTM, the GRU and the mixer timed in turns;
    one bf16 --rnn_cell gru step under the bf16 gates (full encode, rows)
    and one K = 2 graphed --rnn_cell gru dispatch against 2 eager steps bit
    for bit under cuDNN's deterministic algorithms (the graphs phase's
    case, twice)."""
    from maavss_tpu_torch.config import RunConfig

    os.environ.pop("MAAVSS_S2D_MIN_HW", None)  # the default, 128
    cases, timed = {}, {}

    def run(label, cfg, frames_model, pair):
        rec, kernel_step = _option_case(f"eval_plane {label}", cfg,
                                        frames_model, pair)
        for what, want in (("launches_per_step",
                            _want_step(cfg, frames_model)),
                           ("launches_per_batch",
                            _want_batch(cfg, frames_model))):
            if rec[what] != want:
                raise SystemExit(f"eval_plane {label}: {what} {rec[what]} "
                                 f"!= {want}")
        for n, c in rec["launches_per_step"].items():
            totals[n] = totals.get(n, 0) + 2 * c
        for n, c in rec["launches_per_batch"].items():
            totals[n] = totals.get(n, 0) + c
        cases[label] = rec
        return kernel_step

    for frames_model in (False, True):
        family = "frames" if frames_model else "fusion"
        pairs = {}
        for option in EVAL_OPTIONS:
            cfg = RunConfig(batch_size=8, noise_scalar=0.0, **option)
            if cfg.rnn_cell not in pairs:  # one pair at a time resident
                pairs = {cfg.rnn_cell: _option_pair(cfg, frames_model)}
            (key, value), = option.items()
            label = f"{family}_{key}" + (f"_{value}" if key == "rnn_cell"
                                         else "")
            kernel_step = run(label, cfg, frames_model, pairs[cfg.rnn_cell])
            if not frames_model and key == "rnn_cell":
                timed[value] = kernel_step
        del pairs
    cfg = RunConfig(batch_size=8, noise_scalar=0.0)
    timed["lstm"] = run("fusion_rnn_cell_lstm", cfg, False,
                        _option_pair(cfg, False))
    step_ms = {}
    for cell in ("lstm", "gru", "none", "none", "gru", "lstm"):
        fn, st, b = timed[cell]
        step_ms.setdefault(cell, []).append(
            cuda_ms(lambda: fn(st, b, 2), reps=3, iters=1))
    cases["fusion_step_ms"] = step_ms
    del timed
    bf16_cfg = RunConfig(batch_size=8, noise_scalar=0.0, learning_rate=1e-4,
                         dtype="bfloat16", rnn_cell="gru",
                         fusion_encode="full", pgram_cache=True)
    bf16, _ = _bf16_train_vs_plain(
        "eval_plane gru bf16", bf16_cfg, False,
        dict(pgenc_train=10, pgenc_bwd=10, adam=1, stft=1), steps=1)
    for n, c in (("pgenc_train", 10), ("pgenc_bwd", 10), ("adam", 1),
                 ("stft_feat", 1)):
        totals[n] = totals.get(n, 0) + c
    cases["fusion_gru_bf16"] = bf16
    graph, graph_totals = _graph_case(
        "gru_b8", False, RunConfig(batch_size=8, rnn_cell="gru",
                                   fusion_encode="full", pgram_cache=True),
        exact=True, k=2, dispatches=2, timed=False)
    for n, c in graph_totals.items():
        totals[n] = totals.get(n, 0) + c
    cases["fusion_gru_graphed"] = graph
    return cases


def _quality_curve_run(root):
    """tools/quality_curve_torch.py on the anchor's recipe (the fusion
    flagship, --data_path synthetic:8 -b 32, lr 1e-3) for QC_STEPS steps at
    --eval_every QC_EVAL_EVERY, the committed anchor enforced (the tool
    exits on a drift or another batch hash; nothing relabelled): its
    records, the train steps/s (the loop's wall time less its evals) and
    the eval seconds, the launches of its run."""
    import json as _json

    from maavss_tpu_torch.config import model_args
    from maavss_tpu_torch.train import steps as port_steps
    from tools import quality_curve_torch as qc

    out = os.path.join(root, "quality_curve.jsonl")
    starts = []
    make = port_steps.make_fusion_step

    def timed_step_maker(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(*a, **k):
            starts.append(time.perf_counter())
            return step(*a, **k)
        return run

    port_steps.make_fusion_step = timed_step_maker
    try:
        with _Recorded() as rec:
            before = _launch_counts()
            summary = qc.quality_curve(model_args(QC_ARGS), "fusion",
                                       QC_STEPS, QC_EVAL_EVERY, 2, out,
                                       device="cuda")
            launches = _grown(before)
    finally:
        port_steps.make_fusion_step = make
    with open(out) as f:
        records = [_json.loads(line) for line in f]
    if [r["step"] for r in records] != [0, 50, 100, 100] or any(
            r.get("anchor_drift") for r in records):
        raise SystemExit(f"quality curve records {records}")
    if len(rec.seconds) != 2 * len(records) or len(starts) != QC_STEPS:
        raise SystemExit(f"quality curve: {len(rec.seconds)} separator "
                         f"calls, {len(starts)} steps")
    # the loop: the first step's start to the final record's first eval
    # batch, less the evals inside it (2 batches a record, each timed
    # between two synchronisations)
    train_s = rec.starts[-2] - starts[0] - sum(rec.seconds[2:-2])
    return dict(records=records, steps=QC_STEPS, eval_every=QC_EVAL_EVERY,
                train_steps_per_s=QC_STEPS / train_s,
                eval_s=rec.seconds, summary=summary, launches=launches)


def eval_plane_phase():
    """The evaluation plane and the model options a checkpoint can carry,
    at full width, in a temporary working directory (its synthetic stores,
    checkpoints, wavs and records); every kernel against its plain version
    from one checkpoint or state_dict:

    - evaluate (tools/evaluate_torch.py): the fusion flagship (the default
      RunConfig) at batch 8 over 2 validation batches, and the frames
      flagship (framesize 256) at batch 4 over 1, each from a checkpoint
      with seeded random BatchNorm statistics (`_eval_tool`); ms per batch;
    - separate (tools/separate_torch.py): a 10 s two-channel wav (26 tiles,
      4 batches of 8, the last padded), audio only and with the 256 px
      frame store resized to p_size 64 (`_separate_tool`); seconds of
      separator per second of audio;
    - the options (`_option_cases`);
    - the quality curve (`_quality_curve_run`) with the committed anchor
      enforced on the card's generator.

    Returns the kernels' launches in the runs with the kernels."""
    import numpy as np

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import build_synthetic_store
    from maavss_tpu_torch.data.wavio import write_wav

    totals = {}

    def add(launches, times=1):
        for n, c in launches.items():
            totals[n] = totals.get(n, 0) + times * c

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="maavss_eval_") as root:
        os.chdir(root)
        try:
            t0 = time.perf_counter()
            # stores of their own: the quality curve's recipe builds
            # ./data/synthetic-p64 with 8 videos
            fusion = RunConfig(batch_size=8, val_steps=2, cp_dir="cp",
                               log_dir="runs_fusion",
                               data_path=os.path.join(root, "store64"))
            build_synthetic_store(fusion.data_path, fusion, n_videos=4,
                                  seconds=2.0, frame_size=fusion.p_size)
            fusion = _eval_checkpoint(fusion, False, None, "eval_fusion")
            frames_store = os.path.join(root, "store256")
            build_synthetic_store(frames_store, fusion, n_videos=2,
                                  seconds=2.0, frame_size=256)
            frames = RunConfig(batch_size=4, val_steps=1, cp_dir="cp",
                               log_dir="runs_frames", data_path=frames_store)
            frames = _eval_checkpoint(frames, True, 256, "eval_frames")
            ev = {"fusion": _eval_tool(
                "eval_plane evaluate fusion", fusion, "fusion",
                {n: 2 * c for n, c in _want_batch(fusion, False).items()}),
                "frames": _eval_tool("eval_plane evaluate frames", frames,
                                     "frames", _want_batch(frames, True))}
            add(ev["fusion"]["launches"])
            add(ev["frames"]["launches"])
            phase("eval_plane_evaluate", **ev)

            n = 10 * fusion.samplerate
            t = np.arange(n) / fusion.samplerate
            rng = np.random.default_rng(3)
            clean = 0.4 * np.sin(2 * np.pi * 330.0 * t)
            mix = np.stack([clean + 0.2 * rng.standard_normal(n),
                            clean - 0.2 * rng.standard_normal(n)])
            write_wav("mix.wav", mix.astype(np.float32), fusion.samplerate)
            sep = {}
            for label, fdir in (("audio_only", None), ("frame_store",
                                os.path.join(frames_store, "frames"))):
                sep[label] = _separate_tool(
                    f"eval_plane separate {label}", fusion, "mix.wav", fdir,
                    _want_batch(fusion, False), root)
                add(sep[label]["launches"])
            if sep["audio_only"]["tiles"] != 26:
                raise SystemExit(f"separate: {sep['audio_only']['tiles']} "
                                 f"tiles, want 26")
            phase("eval_plane_separate", **sep)

            options = _option_cases(totals)
            phase("eval_plane_options", **options)

            curve = _quality_curve_run(root)
            add(curve["launches"])
            phase("eval_plane_quality_curve", **curve)
            phase("eval_plane", launches=totals, s=time.perf_counter() - t0)
        finally:
            os.chdir(cwd)
    return totals


# the staged-training regimes (regimes) and --remat (remat)
REGIME_LR = 1e-3
REMAT_STEPS = 3


def _regime_cases():
    """(label, step factory, trainable prefixes, launches a step) of the
    regimes phase on the fusion flagship (scan windows, num_seq 4, the
    phasegram encoder's 10 layers)."""
    from maavss_tpu_torch.train import steps
    from maavss_tpu_torch.train.setup import FUSION_SUBNETS

    ns, layers = 4, FULLENC_LAYERS
    scan = dict(lstm_fwd=ns, lstm_bwd=ns, pgenc_train=ns * layers,
                pgenc_bwd=ns * layers, adam=1, stft=1)
    return (
        ("fusion", steps.make_fusion_step, None, scan),
        ("audio_ae", steps.make_audio_ae_step, None, dict(adam=1, stft=1)),
        ("visual_ae", steps.make_visual_ae_step, None,
         dict(pgenc_train=layers, pgenc_bwd=layers, adam=1)),
        ("staged_av", steps.make_fusion_step, FUSION_SUBNETS, scan),
        ("middle", steps.make_fusion_middle_step, None, scan),
    )


def _regime_eval(label, make_eval, want):
    """One eval batch of an autoencoder regime with every kernel against
    the plain versions from one state_dict: the loss within 1e-4
    relative, the launches exactly `want`, the plain side none; the two
    timed in turns."""
    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.ops.counters import kernel_counters

    cfg = RunConfig(batch_size=8, noise_scalar=0.0)
    model, state, _, ref, ref_state, _ = _train_pair(cfg, False)
    evaluate = make_eval(model, cfg, device="cuda")
    ref_eval = _plain_k4(make_eval(ref, cfg, device="cuda"))
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=5)
    counters = kernel_counters()

    def run(fn, st):
        for o, a in counters.values():
            setattr(o, a, 0)
        out = fn(st, batch, 2)
        torch.cuda.synchronize()
        return out, {n: getattr(o, a) for n, (o, a) in counters.items()
                     if getattr(o, a)}

    got, launches = run(evaluate, state)
    ref_out, ref_launches = run(ref_eval, ref_state)
    if launches != want or ref_launches:
        raise SystemExit(f"regimes {label}: launches {launches} (want "
                         f"{want}), plain {ref_launches}")
    rel = abs(float(got["loss"]) - float(ref_out["loss"])) / abs(
        float(ref_out["loss"]))
    if rel > 1e-4 or not math.isfinite(float(got["loss"])):
        raise SystemExit(f"regimes {label}: loss {float(got['loss'])} vs "
                         f"plain {float(ref_out['loss'])} (rel {rel})")
    times = {"kernels": [], "plain": []}
    for _ in range(2):
        times["kernels"].append(cuda_ms(lambda: evaluate(state, batch, 2),
                                        reps=3, iters=2))
        times["plain"].append(cuda_ms(lambda: ref_eval(ref_state, batch, 2),
                                      reps=3, iters=2))
    phase("regimes_eval", case=label, batch=cfg.batch_size,
          loss=float(got["loss"]), plain_loss=float(ref_out["loss"]),
          loss_rel_diff=rel, launches=launches, eval_ms=times["kernels"],
          plain_eval_ms=times["plain"])
    return launches


def _fusion_conv_check():
    """AVFusionModelConv at the fusion flagship's shapes (batch 8, seeded
    weights): K1 against the LSTM scan from one state_dict, the eval and
    train-mode forwards within 1e-4 relative L2 (the train forward also
    its running statistics), one backward of the outputs' squares: the
    BiLSTM's w_h gradients within 1e-4; K1-fwd once a forward, K1-bwd once
    a backward."""
    import torch

    from maavss_tpu_torch.models.fusion_conv import AVFusionModelConv
    from maavss_tpu_torch.ops.cuda_lstm import (
        lstm_recurrence,
        lstm_recurrence_bwd,
    )
    from maavss_tpu_torch.train.setup import init_flax_like

    stft, pgram = (8, 2, 64, 128), (8, 1, 8, 64 * 64)
    model = AVFusionModelConv(stft, pgram)
    init_flax_like(model, torch.Generator().manual_seed(0))
    ref = AVFusionModelConv(stft, pgram)
    ref.load_state_dict(model.state_dict())
    model.cuda()
    ref.cuda()
    ref.lstm.backend = "scan"
    g = torch.Generator(device="cuda").manual_seed(3)
    x_a = torch.randn(stft, device="cuda", generator=g)
    x_v = torch.randn(pgram, device="cuda", generator=g)

    def rel(a, b):
        return (torch.linalg.vector_norm(a - b)
                / torch.linalg.vector_norm(b).clamp(min=1e-12)).item()

    out, launches = {}, {}
    for train in (False, True):
        for m in (model, ref):
            m.train(train)
            m.zero_grad(set_to_none=True)
        lstm_recurrence.launches = lstm_recurrence_bwd.launches = 0
        got = model(x_a, x_v)
        want = ref(x_a, x_v)
        if train:
            sum(o.square().mean() for o in got).backward()
            sum(o.square().mean() for o in want).backward()
        torch.cuda.synchronize()
        mode = "train" if train else "eval"
        launches[mode] = dict(lstm_fwd=lstm_recurrence.launches,
                              lstm_bwd=lstm_recurrence_bwd.launches)
        out[mode] = max(rel(a.detach(), b.detach())
                        for a, b in zip(got, want))
        if train:
            out["w_h_grad"] = max(
                rel(getattr(model.lstm, d).w_h.grad,
                    getattr(ref.lstm, d).w_h.grad) for d in ("fwd", "bwd"))
            out["running_stats"] = max(
                rel(a, b) for (n, a), (_, b) in zip(
                    model.named_buffers(), ref.named_buffers())
                if n.endswith(("running_mean", "running_var")))
    want_launches = {"eval": dict(lstm_fwd=1, lstm_bwd=0),
                     "train": dict(lstm_fwd=1, lstm_bwd=1)}
    if launches != want_launches or max(out.values()) > 1e-4:
        raise SystemExit(f"regimes fusion_conv: rel L2 {out}, launches "
                         f"{launches} (want {want_launches})")
    phase("regimes_fusion_conv", stft=list(stft), pgram=list(pgram),
          params=sum(p.numel() for p in model.parameters()),
          rel_l2=out, launches=launches)
    return {k: launches["eval"][k] + launches["train"][k]
            for k in ("lstm_fwd", "lstm_bwd")}


def regimes_phase():
    """The staged-training regimes on the fusion flagship (the default
    RunConfig at batch 8, scan windows, noise 0, lr 1e-3, mode 2): the STFT
    autoencoder step (train_audio_net.py), the phasegram autoencoder step
    (train_visual_net.py), the staged AV step (train_av_net.py: only
    FUSION_SUBNETS trainable, K3 over their fp32 leaves alone) and the
    middle-frame step, and the fusion step beside them: 3 steps each with
    every kernel against the plain versions from one state_dict under the
    train phase's gates, exact launches a step, the frozen leaves unchanged
    bit for bit on both sides; kernel and plain steps timed in turns; the
    two autoencoder evals (`_regime_eval`); AVFusionModelConv
    (`_fusion_conv_check`); the staged step and the phasegram autoencoder
    as K = 3 graphed dispatches bit for bit against eager steps under
    cuDNN's deterministic algorithms. Returns each kernel's launches."""
    import functools

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.train import setup, steps

    t0 = time.perf_counter()
    cfg = RunConfig(batch_size=8, noise_scalar=0.0,
                    learning_rate=REGIME_LR)
    totals = {}

    def add(launches, times=1):
        for n, c in launches.items():
            totals[n] = totals.get(n, 0) + c * times

    cases = {}
    for label, make, trainable, want in _regime_cases():
        # the BN-fed conv biases' gradients are rounding noise that Adam
        # turns into +-lr: the STFT kernel's features against cuFFT's
        # (2e-7) can move them 2 lr apart (the audio AE trains nothing
        # else), so such a bias may pass by its gradient
        out = _train_vs_plain(f"regimes {label}", cfg, False, want,
                              make_step=make, trainable=trainable,
                              time_plain=True, fed_by_gradient=True)
        add(want, out["steps"])
        cases[label] = out["step_ms"]
        phase("regimes_case", case=label, **out)
    layers = FULLENC_LAYERS
    add(_regime_eval("audio_ae_eval", steps.make_audio_ae_eval,
                     dict(stft_feat=1)))
    add(_regime_eval("visual_ae_eval", steps.make_visual_ae_eval,
                     dict(pgenc_eval=layers)))
    add(_fusion_conv_check())
    staged = functools.partial(setup.build_fusion_state,
                               trainable=setup.FUSION_SUBNETS)
    graphs = []
    for label, build, make in (
            ("staged_av_b8", staged, steps.make_fusion_step),
            ("visual_ae_b8", None, steps.make_visual_ae_step)):
        out, launched = _graph_case(label, False, RunConfig(batch_size=8),
                                    True, build=build, make=make)
        add(launched)
        graphs.append(label)
        phase("regimes_graph", **out)
    phase("regimes", cases=list(cases), step_ms=cases, graphs=graphs,
          launches=totals, seconds=round(time.perf_counter() - t0, 1))
    return _by_counter(totals)


def _by_counter(totals):
    """Launches keyed by kernel_counters names (`stft` is `stft_feat`)."""
    out = {}
    for n, c in totals.items():
        key = "stft_feat" if n == "stft" else n
        out[key] = out.get(key, 0) + c
    return out


@contextlib.contextmanager
def _remat_policy(policy):
    """MAAVSS_REMAT_POLICY set to `policy` while the block builds its
    steps (a step factory reads it once), then restored."""
    old = os.environ.get("MAAVSS_REMAT_POLICY")
    os.environ["MAAVSS_REMAT_POLICY"] = policy
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MAAVSS_REMAT_POLICY")
        else:
            os.environ["MAAVSS_REMAT_POLICY"] = old


def _remat_bits(label, cfg, frames_model, doubled, policy="full"):
    """--remat under MAAVSS_REMAT_POLICY=`policy` against the plain step,
    both with every kernel, from one state_dict, REMAT_STEPS steps under
    cuDNN's deterministic algorithms: equal bit for bit (metrics,
    parameters, BatchNorm's running statistics, Adam's m, v and count);
    each step's launches are the plain step's with the kernels in
    `doubled` (the forward kernels inside a checkpointed region) twice;
    peak memory allocated in one step of each and their step times in
    turns."""
    import torch

    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.ops.counters import kernel_counters
    from maavss_tpu_torch.train import setup
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step

    torch.backends.cudnn.deterministic = True
    if frames_model:
        build, make = setup.build_frames_state, make_frames_step
    else:
        build, make = setup.build_fusion_state, make_fusion_step
    _, state = build(cfg, cfg.batch_size, device="cuda",
                     generator=torch.Generator().manual_seed(cfg.seed))
    rcfg = cfg.replace(remat=True)
    _, rstate = build(rcfg, cfg.batch_size, device="cuda",
                      generator=torch.Generator().manual_seed(cfg.seed + 1))
    rstate.model.load_state_dict(state.model.state_dict())
    step = make(state.model, cfg, device="cuda")
    with _remat_policy(policy):
        rstep = make(rstate.model, rcfg, device="cuda")
    frame_size = cfg.framesize if frames_model else None
    batches = [synthetic_av_batch(cfg, cfg.batch_size, seed=cfg.seed + i,
                                  frame_size=frame_size)
               for i in range(REMAT_STEPS)]
    counters = kernel_counters()

    def run(fn, st, batch):
        for o, a in counters.values():
            setattr(o, a, 0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st, m = fn(st, batch, 2)
        torch.cuda.synchronize()
        return st, m, {n: getattr(o, a) for n, (o, a) in counters.items()
                       if getattr(o, a)}, torch.cuda.max_memory_allocated()

    peaks = {"plain": 0, "remat": 0}
    launches = None
    for i, batch in enumerate(batches):
        state, m, plain_launches, peak = run(step, state, batch)
        peaks["plain"] = max(peaks["plain"], peak)
        rstate, rm, launches, rpeak = run(rstep, rstate, batch)
        peaks["remat"] = max(peaks["remat"], rpeak)
        want = {n: c * (2 if n in doubled else 1)
                for n, c in plain_launches.items()}
        if launches != want:
            raise SystemExit(f"remat {label} {policy} step {i + 1}: "
                             f"launches {launches}, want {want} (the plain "
                             f"step's with {sorted(doubled)} twice)")
        bad = [k for k in m if not torch.equal(m[k], rm[k])]
        bad += _graph_state_diff(rstate, state)
        if bad:
            raise SystemExit(f"remat {label} {policy} step {i + 1} differs "
                             f"from the plain step in {bad[:12]} "
                             f"({len(bad)} in all)")
    times = {"plain": [], "remat": []}
    for _ in range(2):
        times["plain"].append(cuda_ms(lambda: step(state, batches[0], 2),
                                      reps=3, iters=1))
        times["remat"].append(cuda_ms(lambda: rstep(rstate, batches[0], 2),
                                      reps=3, iters=1))
    torch.backends.cudnn.deterministic = False
    phase("remat_bits", case=label, batch=cfg.batch_size,
          steps=REMAT_STEPS, bit_equal=True, cudnn_deterministic=True,
          launches_per_step=launches, doubled=sorted(doubled),
          peak_allocated_bytes=peaks, step_ms=times, policy=policy)
    return {n: c * REMAT_STEPS for n, c in launches.items()}


def remat_phase():
    """--remat (train/steps.py:_train_apply, torch.utils.checkpoint around
    each window's forward): the fusion flagship's scan step (batch 8) and
    the frames flagship's window step (framesize 256, batch 8), each
    (a) with every kernel against the plain versions, both under --remat,
    from one state_dict, 3 steps under the train gates, exact launches
    (each forward kernel twice a window: K1-fwd and K2-train, or K1-fwd
    and K5's stats and apply; the backward kernels, K3 and the STFT once);
    (b) against the plain --remat-less step, both with every kernel, bit
    for bit under cuDNN's deterministic algorithms, running statistics
    included, with the peak memory and step time of both
    (`_remat_bits`), and the fusion case again under
    MAAVSS_REMAT_POLICY=dots (selective checkpointing); and graphed K = 3
    --remat fusion dispatches, one a policy, bit for bit against eager
    steps. Returns each kernel's launches."""
    from maavss_tpu_torch.config import RunConfig

    t0 = time.perf_counter()
    os.environ.pop("MAAVSS_S2D_MIN_HW", None)  # the default, 128
    totals = {}

    def add(launches, times=1):
        for n, c in launches.items():
            totals[n] = totals.get(n, 0) + c * times

    ns, layers = 4, FULLENC_LAYERS
    fusion = RunConfig(batch_size=8, noise_scalar=0.0,
                       learning_rate=REGIME_LR)
    frames = RunConfig(batch_size=8, noise_scalar=0.0,
                       learning_rate=REGIME_LR)
    want = dict(lstm_fwd=2 * ns, lstm_bwd=ns, pgenc_train=2 * ns * layers,
                pgenc_bwd=ns * layers, adam=1, stft=1)
    out = _train_vs_plain("remat fusion", fusion.replace(remat=True), False,
                          want)
    add(want, out["steps"])
    phase("remat_vs_plain", case="fusion_scan_b8", **out)
    want = dict(lstm_fwd=2 * ns, lstm_bwd=ns, adam=1, stft=1,
                epilogue_stats=4 * ns, epilogue_apply=4 * ns,
                epilogue_bwd_reduce=2 * ns, epilogue_bwd_dy=2 * ns)
    out = _train_vs_plain("remat frames", frames.replace(remat=True), True,
                          want)
    add(want, out["steps"])
    phase("remat_vs_plain", case="frames_window_b8", **out)
    for policy in ("full", "dots"):
        add(_remat_bits("fusion_scan_b8", fusion, False,
                        {"lstm_fwd", "pgenc_train"}, policy))
    add(_remat_bits("frames_window_b8", frames, True,
                    {"lstm_fwd", "epilogue_stats", "epilogue_apply"}))
    for policy in ("full", "dots"):
        with _remat_policy(policy):
            out, launched = _graph_case(
                f"remat_{policy}_scan_b8", False,
                RunConfig(batch_size=8, remat=True), True)
        add(launched)
        phase("remat_graph", policy=policy, **out)
    phase("remat", launches=totals,
          seconds=round(time.perf_counter() - t0, 1))
    return _by_counter(totals)


# the legacy raw-FFT family (legacy) and offline feature extraction
# (features): no hand-written kernel; cuDNN, cuBLAS and cuFFT calls
LEGACY_BATCH, LEGACY_LR = 4, 1e-2
LEGACY_STFT = ((4, 2, 48, 128), (4, 1, 6, 64, 64), 4)
DINO_GOLDEN = os.path.join(ROOT, "tests", "fixtures", "dino_golden.npz")
DINO_SEED = 20260819  # tests/fixtures/dino_golden.npz's weights


def _legacy_stft_check():
    """AVModelSTFT (train_autoencoder.py's model) at the JAX package's
    test geometry, batch 4: one train-mode forward and train_ae forward,
    then the backward of sum(out * cot) over the forward's outputs, on the
    card against the CPU from one state_dict. Outputs and running
    statistics within 1e-4 of their largest value; each gradient within
    1e-4 of its layer's largest plus twice the CPU fp32 gradient's
    rounding against a float64 CPU run (the BN-fed biases' gradients are
    rounding). Returns the largest errors (outputs and statistics in
    absolute terms) and the card's ms."""
    import copy

    import numpy as np
    import torch

    from maavss_tpu_torch.models.layers import TorchBatchNorm
    from maavss_tpu_torch.models.legacy import AVModelSTFT
    from maavss_tpu_torch.train.setup import init_flax_like

    dev = torch.device("cuda")
    stft, vid, alpha = LEGACY_STFT
    g = np.random.default_rng(0)
    xa = torch.from_numpy(g.standard_normal(stft).astype(np.float32))
    xv = torch.from_numpy(g.random(vid).astype(np.float32))
    ref = AVModelSTFT(stft, vid, alpha)
    init_flax_like(ref, torch.Generator().manual_seed(0))
    ref.train()
    ref64 = copy.deepcopy(ref).double()
    for mod in ref64.modules():
        if isinstance(mod, TorchBatchNorm):
            mod.dtype = torch.float64
    model = copy.deepcopy(ref).to(dev)
    cots = None

    def run(m, x_a, x_v):
        nonlocal cots
        outs = m(x_a, x_v)
        ae = m(x_a, x_v, train_ae=True)
        if cots is None:
            cots = [torch.from_numpy(g.standard_normal(o.shape).astype(
                np.float32)) for o in outs]
        sum((o * c.to(o)).sum() for o, c in zip(outs, cots)).backward()
        return [o.detach().cpu() for o in outs + ae]

    want = run(ref, xa, xv)
    run(ref64, xa.double(), xv.double())
    got = run(model, xa.to(dev), xv.to(dev))
    out_err = max(check_close(f"legacy AVModelSTFT output {i}", a, b, 1e-4,
                              0, scale_atol=True)
                  for i, (a, b) in enumerate(zip(got, want)))
    ref_buffers = dict(ref.named_buffers())
    stats_err = max(check_close(f"legacy AVModelSTFT {k}", b.cpu(),
                                ref_buffers[k], 1e-4, 0, scale_atol=True)
                    for k, b in model.named_buffers() if "running" in k)
    named, named64 = dict(ref.named_parameters()), dict(ref64.named_parameters())
    scale = {}
    for k, p in named.items():
        layer = k.rsplit(".", 1)[0]
        scale[layer] = max(scale.get(layer, 0.0), p.grad.abs().max().item())
    grad_err = 0.0
    for k, p in model.named_parameters():
        err = (p.grad.cpu() - named[k].grad).abs().max().item()
        rounding = (named[k].grad.double() - named64[k].grad).abs().max().item()
        allowed = 1e-4 * scale[k.rsplit(".", 1)[0]] + 2 * rounding
        if not err <= allowed:
            raise SystemExit(f"legacy AVModelSTFT d {k}: {err} over {allowed}")
        grad_err = max(grad_err, err / allowed)
    x_a, x_v = xa.to(dev), xv.to(dev)

    def fwd_bwd():
        outs = model(x_a, x_v)
        sum((o * c.to(o)).sum() for o, c in zip(outs, cots)).backward()

    return dict(out_err=out_err, stats_err=stats_err,
                grad_err_of_allowed=grad_err,
                fwd_bwd_ms=cuda_ms(fwd_bwd, reps=5, iters=2))


def _dense2_recorder(model, records):
    """A forward hook on `model.Dense_2` (v_out's layer, LeakyReLU after
    it) that appends, for each call, its pre-activation and, by a tensor
    hook, the loss's gradient with respect to it, both on the CPU."""
    def hook(mod, inp, out):
        rec = {"pre": out.detach().float().cpu()}
        out.register_hook(lambda g: rec.__setitem__("dpre", g.detach().cpu()))
        records.append(rec)

    return model.Dense_2.register_forward_hook(hook)


def _legacy_flips(card, cpu):
    """Card against CPU, step by step, at Dense_2's pre-activation p and
    the gradient g of the loss with respect to LeakyReLU's output (dpre
    over the slope, 1 where p > 0, else 0.3). On the units that no earlier
    step flipped: p and g within 1e-4 of their largest value elementwise.
    A flip is an entry whose p has another sign on the card: there only
    the slope differs, so the units' bias and weight rows move apart by
    0.7 lr g. Returns (flips a step, the largest |p| at a flip over the
    largest |p|, the largest p and g errors over their largest value,
    the mask of units flipped at some step)."""
    import torch

    from maavss_tpu_torch.models.legacy import LEAKY_SLOPE

    flipped = torch.zeros(card[0]["pre"].shape[1], dtype=torch.bool)
    counts, flip_p, p_err, g_err = [], 0.0, 0.0, 0.0
    for s, (c, r) in enumerate(zip(card, cpu)):
        keep = ~flipped
        pc, pr = c["pre"][:, keep], r["pre"][:, keep]
        gc = c["dpre"][:, keep] / torch.where(pc > 0, 1.0, LEAKY_SLOPE)
        gr = r["dpre"][:, keep] / torch.where(pr > 0, 1.0, LEAKY_SLOPE)
        p_err = max(p_err, _rel_max(f"legacy step {s} Dense_2 pre-activation",
                                    pc, pr, 1e-4))
        g_err = max(g_err, _rel_max(f"legacy step {s} d v_out", gc, gr, 1e-4))
        flip = (pc > 0) != (pr > 0)
        counts.append(int(flip.sum()))
        if counts[-1]:
            flip_p = max(flip_p, (pr.abs()[flip].max()
                                  / pr.abs().max()).item())
        flipped[keep.nonzero()[:, 0][flip.any(0)]] = True
    return counts, flip_p, p_err, g_err, flipped


def _rel_max(what, got, want, tol):
    """Raise unless max|got - want| <= tol * max|want|; return the ratio."""
    err = ((got.double() - want.double()).abs().max()
           / want.double().abs().max().clamp(min=1e-30)).item()
    if not err <= tol:
        raise SystemExit(f"{what}: max error {err} of the largest value "
                         f"over {tol}")
    return err


def _legacy_fft_check(audio):
    """ops/fft_legacy on the card against the CPU on the generator's
    audio [B, S]: `process_fft` rectangular and polar (real/imag and
    magnitude within 1e-5 of their largest value; phases as wrapped
    differences times the magnitude, within 1e-5 of the largest
    magnitude), and `inference_to_audio` of each back to audio within
    1e-5 of its largest value. The generator runs this FFT on the host;
    this is its card check. Returns the largest errors and the card's ms
    of one process_fft."""
    import math

    import torch

    from maavss_tpu_torch.ops.fft_legacy import inference_to_audio, process_fft

    dev = torch.device("cuda")
    x = torch.from_numpy(audio)
    x_dev = x.to(dev)
    err = {}
    for polar in (False, True):
        got = process_fft(x_dev, polar=polar).cpu()
        want = process_fft(x, polar=polar)
        if polar:
            err["mag"] = _rel_max("legacy fft magnitude", got[..., 0, :],
                                  want[..., 0, :], 1e-5)
            d = torch.remainder(got[..., 1, :] - want[..., 1, :] + math.pi,
                                2 * math.pi) - math.pi
            mag = want[..., 0, :]
            err["phase"] = ((d * mag).abs().max() / mag.max()).item()
            if not err["phase"] <= 1e-5:
                raise SystemExit(f"legacy fft phase x magnitude: "
                                 f"{err['phase']} of the largest magnitude")
        else:
            err["ri"] = _rel_max("legacy fft real/imag", got, want, 1e-5)
        back = inference_to_audio(got.to(dev), polar=polar).cpu()
        err[f"audio_{'polar' if polar else 'ri'}"] = _rel_max(
            "legacy inference_to_audio", back,
            inference_to_audio(want, polar=polar), 1e-5)
    err["process_fft_ms"] = cuda_ms(lambda: process_fft(x_dev), reps=5,
                                    iters=4)
    return err


def legacy_phase(frame_size: int = 256):
    """The legacy raw-FFT family at main.py's geometry: `DataGenerator`
    batches (batch 4, x_fft [4, 2, 2112], frames [4, 1, 8, 256, 256]) from
    a synthetic store built in a temporary directory, `AVSEModel` (~272 M
    parameters) and tools/train_legacy_torch.py's SGD step: 3 steps on the
    card against the CPU from one state_dict at lr 1e-2. Losses within
    1e-4 relative. Dense_2's pre-activations and the gradient at v_out
    step by step as `_legacy_flips` holds them, with the count of sign
    flips at LeakyReLU's kink. After the 3 steps every leaf within 1e-4 of
    its largest value elementwise, but for Dense_2's bias entries and
    weight rows of the flipped units, which are reported beside. Then
    the card's step ms and a profile of 3 steps; `_legacy_fft_check` on the
    generator's audio; and `_legacy_stft_check`."""
    import copy

    import torch

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.generator import DataGenerator
    from maavss_tpu_torch.data.synthetic import build_synthetic_store
    from maavss_tpu_torch.train.state import make_optimizer
    from tools.train_legacy_torch import build_legacy_model, make_legacy_step

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = RunConfig(batch_size=LEGACY_BATCH, learning_rate=LEGACY_LR)
    with tempfile.TemporaryDirectory(prefix="maavss_legacy_") as root:
        frames, audio = build_synthetic_store(root, cfg, n_videos=2,
                                              seconds=2.0,
                                              frame_size=frame_size)
        gen = DataGenerator(cfg, frames, audio, seed=cfg.seed).generator()
        batches = [next(gen) for _ in range(3)]
    x_fft, _, fr, clip_audio = batches[0]
    batches = [b[:3] for b in batches]
    n = cfg.hop * cfg.hops_per_frame * cfg.num_frames
    if x_fft.shape != (LEGACY_BATCH, 2, n // 2) or fr.shape != (
            LEGACY_BATCH, 1, cfg.num_frames, frame_size, frame_size):
        raise SystemExit(f"legacy: batch shapes {x_fft.shape} {fr.shape}")
    ref = build_legacy_model(x_fft.shape, fr.shape, cfg.seed, "cpu")
    model = copy.deepcopy(ref).to(dev)
    steps = [make_legacy_step(m, make_optimizer(
        list(m.named_parameters()), cfg.learning_rate, "sgd"), cfg.loss_coeff)
        for m in (model, ref)]
    records = ([], [])
    hooks = [_dense2_recorder(m, r) for m, r in zip((model, ref), records)]
    losses, loss_err = [], 0.0
    for b in batches:
        got = steps[0](*(torch.from_numpy(a).to(dev) for a in b))
        want = steps[1](*(torch.from_numpy(a) for a in b))
        for k, w in want.items():
            err = abs(got[k].item() - w.item()) / abs(w.item())
            if not err <= 1e-4:
                raise SystemExit(f"legacy step {len(losses)} {k}: "
                                 f"{got[k].item()} against {w.item()}")
            loss_err = max(loss_err, err)
        losses.append(got["loss"].item())
    for h in hooks:
        h.remove()
    flips, flip_p, pre_err, g_err, flipped = _legacy_flips(*records)
    del records
    ref_sd = ref.state_dict()
    leaf_err, flipped_err = 0.0, 0.0
    for k, v in model.state_dict().items():
        v, w = v.cpu(), ref_sd[k]
        if k.startswith("Dense_2."):
            flipped_err = max(flipped_err, ((v[flipped] - w[flipped]).abs(
                ).max() / w.abs().max()).item() if flipped.any() else 0.0)
            v, w = v[~flipped], w[~flipped]
        leaf_err = max(leaf_err, _rel_max(f"legacy leaf {k}", v, w, 1e-4))
    on_dev = [torch.from_numpy(a).to(dev) for a in batches[0]]
    step_ms = cuda_ms(lambda: steps[0](*on_dev), reps=5, iters=4)
    profile_phase("legacy_profile", lambda: steps[0](*on_dev))
    n_params = sum(p.numel() for p in model.parameters())
    del model, ref, steps, on_dev
    fft = _legacy_fft_check(clip_audio)
    stft = _legacy_stft_check()
    phase("legacy", batch=LEGACY_BATCH, x_fft=list(x_fft.shape),
          frames=list(fr.shape), params=n_params, losses=losses,
          loss_err=loss_err, dense2_flips_per_step=flips,
          dense2_flipped_units=int(flipped.sum()),
          flip_pre_of_largest=flip_p, dense2_pre_err=pre_err,
          v_out_grad_err=g_err, leaf_max_err_of_largest=leaf_err,
          flipped_units_err_of_largest=flipped_err, step_ms=step_ms,
          fft=fft, avmodel_stft=stft, s=time.perf_counter() - t0)


def _vit_flops(tokens: int, dim: int, depth: int, patch: int) -> float:
    """Multiply-adds x 2 of `get_last_selfattention` on one frame: the
    patch embedding, depth - 1 whole blocks (qkv, attention, proj, MLP:
    24 N D^2 + 4 N^2 D) and the last block's qkv and scores."""
    n, d = tokens, dim
    embed = 2 * (n - 1) * d * 3 * patch * patch
    return embed + (depth - 1) * (24 * n * d * d + 4 * n * n * d) \
        + 6 * n * d * d + 2 * n * n * d


def features_phase(n_frames: int = 64, size: int = 256,
                   store_frames: int = 32):
    """Offline feature extraction on the card. The ViT-S/8 of
    tests/fixtures/dino_golden.npz (seeded weights, the probe held) against
    the fixture (attention rtol 1e-4, features rtol 1e-3);
    `VideoAttention` over `n_frames` frames of `size`^2 in one call, its
    first two frames against the CPU port's (within 1e-4 of the maps'
    largest value), ms a frame beside the fp32 bound, and a profile of one
    call; `flow_magnitude` over the same number of frames of a moving
    blob, against the CPU (relative L2 1e-4), ms and a profile;
    tools/save_attn_videos_torch.py end to end on a store in a temporary
    directory (two grayscale videos of `store_frames` frames and one RGB
    video of `n_frames`), the shards read back against VideoAttention
    (within one uint8 unit); tools/flow_torch.py's `flow_frames` over the
    RGB video on the card against the CPU (relative L2 1e-4), and its
    ms."""
    import numpy as np
    import torch

    from maavss_tpu_torch.data.frame_shards import (
        FrameShardStore,
        write_frame_shard,
    )
    from maavss_tpu_torch.data.synthetic import moving_blob_frames
    from maavss_tpu_torch.ops import dino, flow, image
    from tools.flow_torch import flow_frames
    from tools.save_attn_videos_torch import save_attention

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    fix = np.load(DINO_GOLDEN)
    sd = dino.seeded_state_dict(DINO_SEED)
    probe = np.concatenate([v.numpy().ravel()[:16] for v in sd.values()])
    if not np.array_equal(probe, fix["weight_probe"]):
        raise SystemExit("features: the golden's seeded weights drifted")
    va = dino.VideoAttention(sd, device=dev)
    with torch.no_grad():
        x = torch.from_numpy(fix["x"]).to(dev)
        attn = va.model.get_last_selfattention(x).cpu().numpy()
        feats = va.model(x).cpu().numpy()
    np.testing.assert_allclose(attn, fix["attn"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(feats, fix["feats"], rtol=1e-3, atol=1e-4)
    golden_err = (float(np.abs(attn - fix["attn"]).max()),
                  float(np.abs(feats - fix["feats"]).max()))

    g = np.random.default_rng(1)
    clip = torch.from_numpy(g.standard_normal(
        (n_frames, 3, size, size)).astype(np.float32))
    on_dev = clip.to(dev)
    maps = va(on_dev)
    want = dino.VideoAttention(sd, device="cpu")(clip[:2])
    maps_err = check_close("features VideoAttention", maps[:2].cpu(), want,
                           1e-4, 0, scale_atol=True)
    vit_ms = cuda_ms(lambda: va(on_dev), reps=3, iters=1)
    profile_phase("features_vit_profile", lambda: va(on_dev), calls=1)
    tokens = (size // 8) ** 2 + 1
    flops = _vit_flops(tokens, 384, 12, 8)
    vit_bound = bound_ms(nbytes(clip) / n_frames, flops)

    blob = torch.from_numpy(moving_blob_frames(2, 1, n_frames, size)[0])
    mag = flow.flow_magnitude(blob.to(dev))
    mag_ref = flow.flow_magnitude(blob)
    flow_rel = _rel_l2(mag.cpu().numpy(), mag_ref.numpy())
    if not flow_rel <= 1e-4:
        raise SystemExit(f"features flow_magnitude: rel L2 {flow_rel}")
    on_dev_blob = blob.to(dev)
    flow_ms = cuda_ms(lambda: flow.flow_magnitude(on_dev_blob), reps=5,
                      iters=4)
    profile_phase("features_flow_profile",
                  lambda: flow.flow_magnitude(on_dev_blob))

    with tempfile.TemporaryDirectory(prefix="maavss_attn_") as root:
        rng = np.random.default_rng(3)
        shards = []
        for v in range(2):
            fr = (moving_blob_frames(v, 1, store_frames, size)[0] * 200
                  + rng.integers(0, 56, (store_frames, size, size)))
            shards.append(fr.astype(np.uint8))
            write_frame_shard(os.path.join(root, "frames"), f"vid{v}",
                              shards[-1], 30.0)
        # an RGB video of n_frames: the tools' [T, H, W, 3] branches
        fr = moving_blob_frames(2, 1, n_frames, size)[0][..., None] \
            * np.array([200, 120, 60]) \
            + rng.integers(0, 56, (n_frames, size, size, 3))
        shards.append(fr.astype(np.uint8))
        write_frame_shard(os.path.join(root, "frames"), "vid2", shards[-1],
                          30.0)
        weights = os.path.join(root, "dino.pth")
        torch.save({"teacher": sd}, weights)
        t_tool = time.perf_counter()
        out = save_attention(root, weights=weights, device=dev)
        tool_s = time.perf_counter() - t_tool
        store = FrameShardStore(out)
        tool_err = 0
        for v, fr in enumerate(shards):
            got = store.read(v, np.arange(len(fr)))
            x = torch.from_numpy(fr).to(dev).float() / 255.0
            x = x.permute(0, 3, 1, 2) if x.ndim == 4 \
                else x[:, None].expand(-1, 3, -1, -1)
            want = (np.clip(va(image.normalize_imagenet(x))[:, 0].cpu()
                            .numpy(), 0, 1) * 255).astype(np.uint8)
            tool_err = max(tool_err, int(np.abs(got.astype(int)
                                                 - want.astype(int)).max()))
            if got.shape != (len(fr), size, size) or tool_err > 1 \
                    or store.fps(v) != 30.0:
                raise SystemExit(f"features save_attn_videos_torch: video {v}"
                                 f" {got.shape}, error {tool_err}")

        def tool_flow(device):
            return flow_frames(root, video=2, num_frames=n_frames,
                               rng=np.random.default_rng(0), device=device)

        (v, tool_mag), (v_ref, tool_ref) = tool_flow(dev), tool_flow("cpu")
        tool_flow_rel = _rel_l2(tool_mag, tool_ref)
        if v != v_ref or tool_mag.shape != (n_frames, size, size) \
                or not tool_flow_rel <= 1e-4:
            raise SystemExit(f"features flow_torch.flow_frames: video {v}, "
                             f"{tool_mag.shape}, rel L2 {tool_flow_rel}")
        tool_flow_ms = cuda_ms(lambda: tool_flow(dev), reps=3, iters=1)
    phase("features", golden_err=golden_err, frames=n_frames, size=size,
          maps_err=maps_err, vit_ms_per_frame=vit_ms / n_frames,
          vit_bound_ms_per_frame=vit_bound[0], vit_bound_by=vit_bound[1],
          vit_gflop_per_frame=flops / 1e9, flow_rel_l2=flow_rel,
          flow_ms=flow_ms, tool_s=tool_s, tool_err=tool_err,
          tool_flow_rel_l2=tool_flow_rel, tool_flow_ms=tool_flow_ms,
          s=time.perf_counter() - t0)


def kernel_entry(name, source, replaces, launches, rep):
    return {"name": name, "route": "cuda",
            "source": f"maavss_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": rep["err"], "ms": rep["ms"],
            "device_ms": rep["device_ms"], "host_ms": rep["host_ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound"][0],
            "bound_by": rep["bound"][1], "library_ms": rep["library_ms"]}


def main() -> None:
    sys.path.insert(0, ROOT)
    smi = device_phase()
    build_phase()
    k1, k2 = lstm_phase(), pgenc_phase()
    k1b = lstm_bwd_phase()
    k1_gate_phase()
    k2t = pgenc_train_phase()
    k2_gate_phase()
    k3 = adam_phase()
    serve = slice_phase()
    golden_phase()
    train = train_phase()
    train_golden_phase()
    fullenc = fullenc_train_phase()
    fullenc_serve = fullenc_slice_phase()
    fullenc_golden_phase()
    bench_phase()
    k5 = k5_phase()
    frames = frames_train_phase()
    frames_serve = frames_slice_phase()
    frames_golden_phase()
    k4 = k4_phase()
    head = k4_head_phase()
    stft = k4_stft_phase()
    mask_train = mask_train_phase()
    mask_serve = mask_slice_phase()
    polar = polar_phase()
    k4_golden_phase()
    k5_bf16 = k5_bf16_phase()
    bf16_launches, mask_mul_rep = bf16_train_phase()
    bf16_slice_phase()
    bf16_golden_phase()
    route_launches, magphase_rep = stft_route_phase()
    graphs = graphs_phase()
    g32, g16 = graphs["float32"], graphs["bfloat16"]
    full32, full16, full_serve = frames_full_phase()
    fusion_mb = fusion_microbatch_phase()
    k5_tuned, k1_tuned, tuned = frames_tuned_phase()
    trainer = trainer_phase()
    evalp = eval_plane_phase()
    regimes = regimes_phase()
    remat = remat_phase()
    legacy_phase()
    features_phase()

    def graphed(name, dtypes=(g32, g16)):
        return sum(g.get(name, 0) for g in dtypes)

    def newer(name, runs=(full32, full16, full_serve, fusion_mb)):
        """Launches of `name` in the --frames_encode full and --microbatch
        phases."""
        return sum(r.get(name, 0) for r in runs)

    def fit(name):
        """Launches of `name` (its kernel_counters name) in the trainer,
        eval_plane, regimes and remat phases' runs."""
        return (trainer.get(name, 0) + evalp.get(name, 0)
                + regimes.get(name, 0) + remat.get(name, 0))

    if any(m in sys.modules for m in ("jax", "flax", "ml_dtypes",
                                      "maavss_tpu")):
        raise SystemExit("the port loaded jax or maavss_tpu")
    import torch

    print(json.dumps({"kernels": [
        kernel_entry("lstm_fwd", "lstm_fwd.cu",
                     "maavss_tpu/ops/pallas_lstm.py:80",
                     serve["lstm"] + fullenc_serve["lstm_fwd"]
                     + frames_serve["lstm_fwd"] + graphed("lstm_fwd")
                     + newer("lstm_fwd") + fit("lstm_fwd"), k1),
        kernel_entry("pgenc_eval", "pgenc_eval.cu",
                     "maavss_tpu/ops/pallas_pgenc.py:171",
                     serve["pgenc"] + fullenc_serve["pgenc_eval"]
                     + fit("pgenc_eval"), dict(k2, library_ms=None)),
        kernel_entry("lstm_bwd", "lstm_bwd.cu",
                     "maavss_tpu/ops/pallas_lstm.py:105",
                     train["lstm_bwd"] + fullenc["lstm_bwd"]
                     + graphed("lstm_bwd") + newer("lstm_bwd")
                     + fit("lstm_bwd"), k1b),
        kernel_entry("pgenc_train", "pgenc_train.cu",
                     "maavss_tpu/ops/pallas_pgenc.py:137",
                     train["pgenc_train"] + fullenc["pgenc_train"]
                     + graphed("pgenc_train") + newer("pgenc_train")
                     + fit("pgenc_train"),
                     dict(err=k2t["fwd_err"], ms=k2t["fwd_ms"],
                          plain_ms=k2t["fwd_plain_ms"], bound=k2t["fwd_bound"],
                          device_ms=k2t["fwd_device_ms"],
                          host_ms=k2t["fwd_host_ms"], library_ms=None)),
        kernel_entry("pgenc_bwd", "pgenc_train.cu",
                     "maavss_tpu/ops/pallas_pgenc.py:184",
                     train["pgenc_bwd"] + fullenc["pgenc_bwd"]
                     + graphed("pgenc_bwd") + newer("pgenc_bwd")
                     + fit("pgenc_bwd"),
                     dict(err=k2t["bwd_err"], ms=k2t["bwd_ms"],
                          plain_ms=k2t["bwd_plain_ms"], bound=k2t["bwd_bound"],
                          device_ms=k2t["bwd_device_ms"],
                          host_ms=k2t["bwd_host_ms"], library_ms=None)),
        kernel_entry("adam", "adam.cu", "maavss_tpu/ops/pallas_adam.py:49",
                     train["adam"] + fullenc["adam"] + graphed("adam")
                     + newer("adam") + fit("adam"), k3),
        *(kernel_entry(f"epilogue_{n}", "epilogue.cu",
                       f"maavss_tpu/ops/pallas_epilogue.py:{line}",
                       frames[f"epilogue_{n}"]
                       + graphed(f"epilogue_{n}", (g32,))
                       + full32[f"epilogue_{n}"] + fit(f"epilogue_{n}"),
                       k5[n])
          for n, line in (("stats", 141), ("apply", 159),
                          ("bwd_reduce", 183), ("bwd_dy", 206))),
        kernel_entry("mask_head", "mask_head.cu",
                     "maavss_tpu/ops/pallas_kernels.py:44",
                     mask_train["mask_head"] + mask_serve["mask_head"]
                     + graphed("mask_head", (g32,)),
                     head["fwd"]),
        kernel_entry("mask_head_bwd", "mask_head.cu",
                     "maavss_tpu/ops/pallas_kernels.py:44",
                     mask_train["mask_head_bwd"]
                     + graphed("mask_head_bwd", (g32,)), head["bwd"]),
        kernel_entry("stft_feat", "stft_feat.cu",
                     "maavss_tpu/ops/pallas_kernels.py:101",
                     serve["stft"] + train["stft"] + fullenc["stft"]
                     + fullenc_serve["stft"] + frames["stft"]
                     + frames_serve["stft"] + mask_train["stft"]
                     + mask_serve["stft"] + polar["stft"]
                     + graphed("stft_feat") + newer("stft")
                     + fit("stft_feat"), stft),
        kernel_entry("polar", "spectral.cu",
                     "maavss_tpu/ops/pallas_kernels.py:143",
                     polar["polar"] + fit("polar"), k4["polar"]),
        *(kernel_entry(f"epilogue_{n}_bf16", "epilogue.cu",
                       f"maavss_tpu/ops/pallas_epilogue.py:{line}",
                       bf16_launches[f"epilogue_{n}"]
                       + graphed(f"epilogue_{n}", (g16,))
                       + full16[f"epilogue_{n}"], k5_bf16[n])
          for n, line in (("stats", 141), ("apply", 159),
                          ("bwd_reduce", 183), ("bwd_dy", 206))),
        kernel_entry("mask_mul", "spectral.cu",
                     "maavss_tpu/ops/pallas_kernels.py:44",
                     bf16_launches["mask_mul"], mask_mul_rep),
        kernel_entry("magphase", "spectral.cu",
                     "maavss_tpu/ops/pallas_kernels.py:101",
                     route_launches["magphase"], magphase_rep),
        # the tuned frames configuration's shapes (frames_tuned)
        *(kernel_entry(f"epilogue_{n}_bf16_tuned", "epilogue.cu",
                       f"maavss_tpu/ops/pallas_epilogue.py:{line}",
                       tuned[f"epilogue_{n}"], k5_tuned[n])
          for n, line in (("stats", 141), ("apply", 159),
                          ("bwd_reduce", 183), ("bwd_dy", 206))),
        kernel_entry("lstm_fwd_bf16_tuned", "lstm_fwd.cu",
                     "maavss_tpu/ops/pallas_lstm.py:80", tuned["lstm_fwd"],
                     k1_tuned[0]),
        kernel_entry("lstm_bwd_bf16_tuned", "lstm_bwd.cu",
                     "maavss_tpu/ops/pallas_lstm.py:105", tuned["lstm_bwd"],
                     k1_tuned[1]),
    ]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
