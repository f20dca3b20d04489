"""Typed run configuration.

One dataclass replaces the reference's argparse registry (run_config.py:4-51)
while preserving every public flag name and default. Entry scripts call
`model_args()` exactly like the reference does; library code takes `RunConfig`
directly. Derived quantities (hop, audio_sample_len, num_fft_frames) are
computed once here instead of being injected into a mutable config at runtime
(reference: train.py:23-28).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence

from maavss_tpu_torch.utils.hop import calc_hop_size


@dataclasses.dataclass
class RunConfig:
    # -- optimization (run_config.py:6-13)
    batch_size: int = 4
    learning_rate: float = 1e-5
    loss_coeff: float = 0.001
    epochs: int = 10
    steps_per_epoch: int = 50
    val_steps: int = 8
    mode_freq: int = 1
    objective_zeros: bool = False
    lr_schedule: str = "constant"  # constant | cosine | warmup_cosine. The
    #   reference trains at a flat LR (train.py:55); the schedules are a
    #   quality lever it lacks. cosine decays to lr*lr_final_scale over
    #   epochs*steps_per_epoch; warmup_cosine prepends a linear ramp of
    #   warmup_steps from 0 to the peak LR.
    warmup_steps: int = 0
    lr_final_scale: float = 0.0  # cosine floor as a fraction of the peak LR
    data_path: str = "data/raw"

    # -- clip geometry (run_config.py:16-21)
    num_frames: int = 8
    num_seq: int = 4
    frame_hop: int = 2
    framerate: int = 30
    framesize: int = 256
    p_size: int = 64

    # -- visual options (run_config.py:23-25)
    autocontrast: bool = False
    attn_diff: bool = False
    compress_audio: bool = False

    # -- STFT frontend (run_config.py:27-33)
    fft_len: int = 256
    hops_per_frame: int = 8
    samplerate: int = 16000
    normalize_fft: bool = True
    normalize_output_fft: bool = False
    use_polar: bool = False
    noise_scalar: float = 0.1
    noise_schedule: Optional[str] = None  # anneal the additive-noise std
    #   over the run's total optimizer steps (a denoising-curriculum lever
    #   the reference lacks — its noise_scalar is flat, av_dataset.py:217).
    #   Spec: "linear:<start>:<end>" or "cosine:<start>:<end>"; None keeps
    #   the constant noise_scalar. When set, the train steps take the noise
    #   std as a TRACED scalar (one compile serves every step); the eval/
    #   separator mixtures stay at noise_scalar so quality numbers remain
    #   comparable across arms.

    # -- model sizes (run_config.py:35-36)
    fc_size: int = 4096
    latent_chan: int = 64

    # -- bookkeeping (run_config.py:38-48)
    cb_freq: int = 100
    max_clip_len: Optional[int] = None
    split: float = 0.8
    saved_model: Optional[str] = None
    checkpoint: Optional[str] = None
    cp_dir: str = "checkpoints/"
    cp_load_opt: bool = False
    c: bool = False  # auto-load latest checkpoint
    no_save: bool = False
    cp_freq: int = 0

    # -- new (TPU framework additions; absent in the reference)
    seed: int = 0
    mesh_data: int = -1  # -1 => all devices on the data axis
    mesh_model: int = 1
    dtype: str = "float32"  # compute dtype for model math ("bfloat16" on TPU)
    log_dir: str = "runs/"
    wandb: bool = False  # reference logs unconditionally; here opt-in
    native_loader: bool = False  # C++ batch assembly (native/dataloader.cc)
    window_mode: str = "scan"  # scan (reference semantics) | vectorized (fast)
    rnn_cell: str = "lstm"  # fusion recurrence: lstm (parity) | gru (faster)
    rnn_unroll: int = 1  # lax.scan unroll for the recurrence
    mask_head: bool = False  # audio head predicts a complex ratio mask
    #   applied to the noisy input via the fused Pallas kernel (requires
    #   rectangular features, i.e. use_polar=False)
    remat: bool = False  # rematerialize model forwards inside the windowed
    #   grad (jax.checkpoint): trades ~1/3 more FLOPs for activation memory,
    #   lifting the frames regime past its b128 HBM ceiling
    microbatch: int = 1  # M sequential batch chunks per optimizer step
    #   (grads averaged; frames AND fusion regimes) — caps peak HBM at one
    #   chunk's forward/backward; the measured fix for the frames b256 OOM
    #   that remat cannot reach (the first conv3d stage's single ~8.6 GB
    #   live intermediate). Per-chunk BatchNorm/phasegram-norm statistics
    #   are the documented deviation.
    frames_encode: str = "window"  # frames-regime visual trunk: window | full.
    #   'window' re-encodes each of the num_seq overlapping nf-frame windows
    #   (reference semantics, train_avse_frames.py:150-181); 'full' encodes
    #   the whole T_total-frame sequence ONCE and slices latent windows —
    #   nf*num_seq -> nf+num_seq-1 frame-convs (~2.9x FLOP cut at the
    #   defaults). Deviations documented at train/steps.py:make_full_loss;
    #   identical when num_seq == 1.
    frames_halo: int = 0  # --frames_encode full only: train each latent
    #   window with k REAL context frames on each side (dataset clips extend
    #   by 2k frames; windows slice at offset k). Makes every training window
    #   interior-like — the distribution the full-encode separator sees at
    #   eval, where windows almost always have real neighbors — targeting the
    #   measured -0.25 dB full-vs-window gap (BASELINE.md r3e/r3f; diagnosis:
    #   window-edge temporal context). Costs (nf+ns-1+2k)/(nf+ns-1) extra
    #   trunk input (~+18% at k=1, defaults). Eval clips stay UNPADDED so
    #   SI-SDR remains on the pinned anchor scale (tools/quality_curve.py).
    fusion_encode: str = "window"  # fusion-regime encoders: window | full.
    #   'window' (re-)encodes each of the num_seq overlapping windows
    #   (reference semantics, train.py:123-162 — scan and vectorized modes
    #   both); 'full' runs BOTH conv encoders ONCE over the whole
    #   (num_frames+num_seq-1)-frame span and slices latent windows before
    #   the LSTM+FC heads — the encoder input shrinks num_seq*num_frames ->
    #   num_frames+num_seq-1 (~2.9x at the defaults) on a step that is
    #   measured memory-bound at the HBM roofline (BASELINE.md round 4f).
    #   Deviations documented at train/steps.py (same class as
    #   frames_encode=full); identical when num_seq == 1.
    pgram_cache: bool = False  # fusion regimes read ingest-time phasegram
    #   cumsum rows (save_phasegrams.py -> <data_path>/pgrams-p<p_size>/)
    #   instead of computing fft2/angle/cumsum per step; rows ship float16
    #   (2x the bytes of the uint8 frames they replace — a compute-for-wire
    #   trade measured in BASELINE.md)
    fused_opt: bool = False  # flat-buffer fused optimizer (train/flat_opt.py):
    #   Adam moments in one contiguous buffer, update as a few full-width
    #   kernels. Measured SLOWER on v5e (BASELINE.md round 3b: XLA already
    #   fuses per-leaf chains; the flatten passes add HBM traffic) — kept as
    #   an honest negative result / for launch-bound hosts. Incompatible
    #   with staged trainable-prefix training and with --mesh_model > 1.
    opt_kernel: str = "auto"  # adam update execution: auto | xla | pallas.
    #   'pallas' (train/fused_adam.py) runs each leaf's moment updates AND
    #   the parameter add in ONE fused VMEM pass — the parameter-side HBM
    #   floor (BASELINE.md optimizer floor: 2.71 ms per-leaf optax vs
    #   1.26 ms speed-of-light). 'auto' resolves per backend to the measured
    #   winner (train/setup.py:_opt_kernel). Incompatible with staged
    #   trainable-prefix training, --fused_opt, and --mesh_model > 1.
    stft_fold: str = "auto"  # STFT-encoder (enc_a) execution:
    #   auto|xla|fold. 'fold' lane-folds the k(5,5) stack's minormost
    #   frequency axis (layers.FoldedConvStack5x5; exact math, same param
    #   tree) — the enc_a counterpart of pgenc fold. 'auto' = per-backend
    #   measured winner.
    pgenc_kernel: str = "auto"  # phasegram-encoder execution:
    #   auto|xla|pallas|fold. 'auto' resolves per backend to the measured
    #   winner: 'fold' on TPU (+10.7% end-to-end, BASELINE.md round 4c),
    #   'xla' elsewhere.
    #   'fold' runs every conv lane-folded (ops/pgenc_fold.py; exact math,
    #   same param tree): W-positions fold into channels so the stack's
    #   1..32-channel first half stops paying the TPU 128-lane padding tax.
    #   'pallas' fuses each conv(1,9)/s2 + BN + tanh layer into one Pallas
    #   program (ops/pallas_pgenc.py; identical param tree, checkpoints
    #   interchange). Measured DEAD END on TPU (BASELINE.md round 3d): the
    #   Mosaic compiler rejects every in-kernel stride-2 subsample
    #   formulation, so 'pallas' raises on TPU and remains available
    #   off-TPU for the interpret-mode parity tests.
    steps_per_dispatch: int = 1  # K > 1 stages K batches on device and runs
    #   K full optimizer steps inside ONE compiled program (lax.scan over the
    #   stacked batches) — dispatch amortization for host/relay-bound
    #   regimes. Per-step semantics (windows, curriculum mode, metrics per
    #   optimizer step) are preserved; requires steps_per_epoch % K == 0
    mode_schedule: Optional[str] = None  # override the regime's reference
    #   modality curriculum: cycle | random01 | fixed (None = the script's
    #   reference-parity default). 'fixed' trains in AV mode 2 — the
    #   distribution the separator evaluates in (random01/cycle feed
    #   zeroed-modality batches whose BatchNorm statistics poison eval)

    # ---- derived AV-alignment quantities ----
    @property
    def hop(self) -> int:
        return calc_hop_size(
            self.num_frames, self.hops_per_frame, self.framerate, self.samplerate
        )[0]

    @property
    def audio_sample_len(self) -> int:
        return calc_hop_size(
            self.num_frames, self.hops_per_frame, self.framerate, self.samplerate
        )[1]

    @property
    def num_fft_frames(self) -> int:
        return calc_hop_size(
            self.num_frames, self.hops_per_frame, self.framerate, self.samplerate
        )[2]

    @property
    def stft_bins(self) -> int:
        """Freq bins after end-trim: fft_len//2 (trim) or fft_len//2+1 (no trim).

        The reference always drops the last time frame and optionally the last
        freq bin (av_dataset.py:171-174); this property reports the trimmed case
        used by AV_Fusion_Model (train.py:66).
        """
        return self.fft_len // 2

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def _mode_schedule(v: str) -> str:
    """--mode_schedule validator: the three reference-era names, or the
    weighted form 'random:<pa>,<pv>,<pav>' (nonnegative weights over
    {audio-only, visual-only, AV}; normalized by the Trainer)."""
    if v in ("cycle", "random01", "fixed"):
        return v
    if v.startswith("random:"):
        parts = v[len("random:"):].split(",")
        try:
            ws = [float(x) for x in parts]
        except ValueError:
            ws = []
        if len(ws) != 3 or any(w < 0 for w in ws) or sum(ws) <= 0:
            raise argparse.ArgumentTypeError(
                f"bad --mode_schedule {v!r}: want random:<pa>,<pv>,<pav> "
                "with nonnegative weights summing > 0")
        return v
    raise argparse.ArgumentTypeError(
        f"bad --mode_schedule {v!r}: cycle | random01 | fixed | "
        "random:<pa>,<pv>,<pav>")


def _str2bool(v) -> bool:
    # the reference uses `type=bool`, for which any non-empty string is True;
    # we accept explicit true/false spellings as well, treating other
    # non-empty strings as True for flag-level parity.
    if isinstance(v, bool):
        return v
    if v.lower() in ("no", "false", "f", "0", ""):
        return False
    return True


def build_parser(parser: Optional[argparse.ArgumentParser] = None) -> argparse.ArgumentParser:
    """Argparse registry preserving every reference flag (run_config.py:4-51)."""
    p = parser or argparse.ArgumentParser()
    p.add_argument("-b", "--batch_size", type=int, default=4, metavar="N")
    p.add_argument("-lr", "--learning_rate", type=float, default=1e-5)
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=("constant", "cosine", "warmup_cosine"),
                   help="LR schedule (constant = reference parity; cosine "
                        "decays over epochs*steps_per_epoch)")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup steps (warmup_cosine)")
    p.add_argument("--lr_final_scale", type=float, default=0.0,
                   help="cosine floor as a fraction of the peak LR")
    p.add_argument("-lc", "--loss_coeff", type=float, default=0.001)
    p.add_argument("-e", "--epochs", type=int, default=10, help="epochs")
    p.add_argument("-s", "--steps_per_epoch", type=int, default=50,
                   help="steps/epoch, validation at epoch end")
    p.add_argument("-v", "--val_steps", type=int, default=8, help="validation steps/epoch")
    p.add_argument("--mode_freq", type=int, default=1,
                   help="frequency (epochs) to switch between training modes")
    p.add_argument("--objective_zeros", type=_str2bool, default=False,
                   help="train model with zeros for inactive modes")
    p.add_argument("--data_path", type=str, default="data/raw", help="path to dataset")

    p.add_argument("--num_frames", type=int, default=8,
                   help="size of each training frame sequence")
    p.add_argument("--num_seq", type=int, default=4,
                   help="number of total sequences - total frames = num_frames + num_seq")
    p.add_argument("--frame_hop", type=int, default=2,
                   help="hop between each clip example in a video")
    p.add_argument("--framerate", type=int, default=30, help="video fps")
    p.add_argument("--framesize", type=int, default=256, help="scaled video frame dims")
    p.add_argument("--p_size", type=int, default=64, help="downsampled phasegram size")

    p.add_argument("--autocontrast", type=_str2bool, default=False)
    p.add_argument("--attn_diff", type=_str2bool, default=False)
    p.add_argument("--compress_audio", action="store_true")

    p.add_argument("--fft_len", type=int, default=256, help="size of fft")
    p.add_argument("-a", "--hops_per_frame", type=int, default=8)
    p.add_argument("--samplerate", type=int, default=16000)
    p.add_argument("--normalize_fft", type=_str2bool, default=True)
    p.add_argument("--normalize_output_fft", type=_str2bool, default=False)
    p.add_argument("--use_polar", type=_str2bool, default=False)
    p.add_argument("--noise_scalar", type=float, default=0.1)
    p.add_argument("--noise_schedule", type=str, default=None,
                   help="anneal the train-time additive-noise std over the "
                        "run: 'linear:<start>:<end>' | 'cosine:<start>:<end>'"
                        " (eval mixtures stay at --noise_scalar)")

    p.add_argument("--fc_size", type=int, default=4096)
    p.add_argument("--latent_chan", type=int, default=64)

    p.add_argument("--cb_freq", type=int, default=100)
    p.add_argument("--max_clip_len", type=int, default=None)
    p.add_argument("--split", type=float, default=0.8)
    p.add_argument("--saved_model", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None)

    p.add_argument("--cp_dir", type=str, default="checkpoints/")
    p.add_argument("--cp_load_opt", action="store_true")
    p.add_argument("-c", action="store_true", help="auto-loads the last saved checkpoint")
    p.add_argument("--no_save", action="store_true")
    p.add_argument("--cp_freq", type=int, default=0)

    # TPU-framework additions
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--dtype", type=str, default="float32")
    p.add_argument("--log_dir", type=str, default="runs/")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--native_loader", action="store_true",
                   help="assemble batches with the C++ loader (native/)")
    p.add_argument("--window_mode", type=str, default="scan",
                   choices=("scan", "vectorized"),
                   help="sliding windows: sequential grad accumulation "
                        "(reference semantics) or folded into the batch (fast)")
    p.add_argument("--rnn_cell", type=str, default="lstm",
                   choices=("lstm", "gru", "none"),
                   help="fusion recurrence cell (gru: fewer sequential "
                        "matmuls; none: recurrence-free Dense mixer)")
    p.add_argument("--rnn_unroll", type=int, default=1,
                   help="lax.scan unroll factor for the recurrence")
    p.add_argument("--mask_head", action="store_true",
                   help="audio head predicts a complex ratio mask applied to "
                        "the noisy input STFT (fused Pallas kernel)")
    p.add_argument("--remat", action="store_true",
                   help="jax.checkpoint the model forward in the windowed "
                        "grad (activation memory for ~1/3 more FLOPs)")
    p.add_argument("--microbatch", type=int, default=1,
                   help="sequential batch chunks per optimizer step (grad "
                        "accumulation; lifts the HBM batch ceiling — frames "
                        "and fusion regimes)")
    p.add_argument("--frames_encode", type=str, default="window",
                   choices=("window", "full"),
                   help="frames-regime visual trunk: re-encode each sliding "
                        "window (reference semantics) or encode the full "
                        "frame sequence once and slice latent windows "
                        "(~2.9x fewer conv3d FLOPs; see config.py notes)")
    p.add_argument("--frames_halo", type=int, default=0,
                   help="with --frames_encode full: real-context halo frames "
                        "per side for each training window (clips extend by "
                        "2k frames; see config.py notes)")
    p.add_argument("--fusion_encode", type=str, default="window",
                   choices=("window", "full"),
                   help="fusion-regime encoders: re-encode each sliding "
                        "window (reference semantics) or encode the full "
                        "sequence once and slice latent windows (~2.9x "
                        "less encoder input on a memory-bound step; see "
                        "config.py notes)")
    p.add_argument("--pgram_cache", action="store_true",
                   help="use precomputed phasegram rows from "
                        "save_phasegrams.py (fusion regimes)")
    p.add_argument("--fused_opt", action="store_true",
                   help="flat-buffer fused optimizer (moments in one "
                        "contiguous buffer; fewer, full-width update kernels)")
    p.add_argument("--opt_kernel", type=str, default="auto",
                   choices=("auto", "xla", "pallas"),
                   help="adam update execution: fused per-leaf Pallas kernel "
                        "or XLA's optax chain (auto = measured per-backend "
                        "winner)")
    p.add_argument("--stft_fold", type=str, default="auto",
                   choices=("auto", "xla", "fold"),
                   help="STFT-encoder execution: lane-folded exact form "
                        "(128-lane-dense activations) vs plain ConvStack")
    p.add_argument("--pgenc_kernel", type=str, default="auto",
                   choices=("auto", "xla", "pallas", "fold"),
                   help="phasegram-encoder execution: auto (per-backend "
                        "measured winner: fold on TPU), XLA's ConvStack, "
                        "fused Pallas conv+BN+tanh layers, or the exact "
                        "lane-folded XLA form (128-lane-dense activations)")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="optimizer steps per compiled dispatch (K batches "
                        "staged on device, lax.scan over them)")
    p.add_argument("--mode_schedule", type=_mode_schedule, default=None,
                   help="override the regime's modality curriculum: cycle | "
                        "random01 | fixed | random:<pa>,<pv>,<pav> (weighted "
                        "draw over {audio-only, visual-only, AV} every "
                        "mode_freq epochs; default: the reference script's "
                        "own schedule)")
    return p


def model_args(argv: Optional[Sequence[str]] = None) -> RunConfig:
    """Parse CLI flags into a RunConfig (reference entry: run_config.py:4-51)."""
    args = build_parser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(RunConfig)}
    return RunConfig(**{k: v for k, v in vars(args).items() if k in fields})
