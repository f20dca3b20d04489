#!/usr/bin/env python
"""Separation quality against training steps with the PyTorch port: train
the fusion (or frames) regime and log the eval SI-SDR every N steps, in one
process (the port's counterpart of tools/quality_curve.py).

The run is the JAX tool's:
- the training mode is pinned to AV (2), the separator's distribution, or
  under `--mode_schedule random:<pa>,<pv>,<pav>` drawn per step with those
  weights (numpy's generator seeded --seed); other schedules exit;
- `--frames_halo k` extends the frames regime's TRAIN clips by 2k frames;
  the eval clips keep the standard length, so the eval set, and its
  anchor, are a halo-0 run's;
- under `--lr_schedule` other than constant or `--noise_schedule` the
  schedules' horizons are pinned to `--steps` (epochs 1, steps_per_epoch
  --steps), and the noise schedule's value at step s - 1 is each step's
  additive noise;
- the eval set is the first `--eval_batches` batches of the validation
  stream (`make_stream` seeded --seed + 1); eval i of a record draws its
  noise from a `torch.Generator` seeded --seed + 100 + i (the JAX tool's
  `PRNGKey`; the draws differ, their distribution does not);
- the training noise comes from one `torch.Generator` seeded --seed on the
  run's device;
- a record {step, si_sdr, si_sdr_gain, noisy_anchor, n_clips, ts} (and
  anchor_drift under a relabel) is appended to `--out` and printed at step
  0, every `--eval_every` steps, and after the last step; every
  `--eval_every` steps a line "step s/S loss ... si_sdr ..." follows; the
  last line is {final, loss, wall_s, regime, mask_head}.

The eval anchor: the noisy input's SI-SDR of the eval set, which no weight
changes (`noisy_anchor`). `--anchor_file` (default
tests/fixtures/eval_anchor.json) pins it with the recipe and the SHA-256 of
the eval batches; a run on that recipe whose batches hash otherwise, or
whose anchor lies more than 0.1 dB from the pinned one, exits unless
`--allow_anchor_drift` (then its records carry anchor_drift: true).
`--pin_anchor` writes the file. Runs on the card unless `--device cpu`.

Usage:
  python tools/quality_curve_torch.py --steps 10000 --eval_every 500
      --out runs/quality/curve.jsonl -b 32 -lr 1e-3 --data_path synthetic:8
  python tools/quality_curve_torch.py --regime frames ...
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ANCHOR_FILE = os.path.join(ROOT, "tests", "fixtures", "eval_anchor.json")
ANCHOR_TOL_DB = 0.1  # absorbs backend noise, catches code drift


def batch_sha256(val_batches) -> str:
    """SHA-256 of the eval batches, every leaf as float32 bytes in sorted
    key order, batch by batch (the JAX tool's hash)."""
    import numpy as np

    h = hashlib.sha256()
    for vb in val_batches:
        for k in sorted(vb):
            h.update(np.ascontiguousarray(
                np.asarray(vb[k], dtype=np.float32)).tobytes())
    return h.hexdigest()


def anchor_recipe(cfg, regime: str, eval_batches: int) -> dict:
    """The configuration the pinned anchor holds for."""
    return {"regime": regime, "data_path": cfg.data_path,
            "batch_size": cfg.batch_size, "eval_batches": eval_batches,
            "seed": cfg.seed, "split": cfg.split,
            "noise_scalar": cfg.noise_scalar, "fft_len": cfg.fft_len,
            "hop": cfg.hop, "use_polar": cfg.use_polar,
            "normalize_fft": cfg.normalize_fft,
            "normalize_output_fft": cfg.normalize_output_fft,
            "num_frames": cfg.num_frames, "num_seq": cfg.num_seq}


def eval_seed(cfg, i: int) -> int:
    return cfg.seed + 100 + i


def noisy_anchor(cfg, val_batches, seeds, frames_model: bool = False,
                 device="cpu") -> float:
    """The mean noisy-input SI-SDR over the clips of `val_batches`, batch i
    drawing its noise from a generator seeded seeds[i]: the separator's
    `si_sdr_noisy` mean of an eval record, without a model."""
    import numpy as np
    import torch

    from maavss_tpu_torch.train.infer import noisy_si_sdr

    vals = []
    for vb, seed in zip(val_batches, seeds):
        gen = torch.Generator(device=device).manual_seed(seed)
        audio = torch.from_numpy(np.asarray(vb["audio"])).to(device)
        vals.extend(noisy_si_sdr(cfg, audio, gen, frames_model).tolist())
    return float(np.mean(vals))


def check_anchor(anchor_file: str, recipe: dict, sha: str, anchor_db: float,
                 allow_drift: bool) -> bool:
    """Hold the measured anchor to the pinned one; returns whether the
    records are relabelled anchor_drift. A missing file or another recipe
    enforces nothing."""
    if not os.path.exists(anchor_file):
        return False
    with open(anchor_file) as f:
        pinned = json.load(f)
    if pinned.get("recipe") != recipe:
        print(f"[anchor] recipe differs from {anchor_file} — anchor not "
              "enforced for this configuration", flush=True)
        return False
    drift = abs(anchor_db - pinned["anchor_db"])
    if pinned.get("batch_sha256") != sha:
        msg = (f"[anchor] EVAL BATCHES CHANGED (sha {sha[:12]} != pinned "
               f"{pinned['batch_sha256'][:12]})")
    elif drift > ANCHOR_TOL_DB:
        msg = (f"[anchor] ANCHOR DRIFT {anchor_db:.3f} dB vs pinned "
               f"{pinned['anchor_db']:.3f} (|d|={drift:.3f} > "
               f"{ANCHOR_TOL_DB})")
    else:
        print(f"[anchor] ok: {anchor_db:.3f} dB vs pinned "
              f"{pinned['anchor_db']:.3f} (|d|={drift:.3f})", flush=True)
        return False
    if not allow_drift:
        raise SystemExit(
            msg + " — SI-SDR from this run is NOT comparable to the pinned "
            "record. Re-pin with --pin_anchor (and re-run the control) or "
            "pass --allow_anchor_drift to relabel.")
    print(msg + " — records relabeled with anchor_drift=true", flush=True)
    return True


def build_state(cfg, regime: str, batch_size: int, frame_size, device):
    """(model, train state) of the regime, seeded from cfg.seed."""
    import torch

    from maavss_tpu_torch.train.setup import (
        build_frames_state,
        build_fusion_state,
    )

    gen = torch.Generator().manual_seed(cfg.seed)
    if regime == "frames":
        return build_frames_state(cfg, batch_size, frame_size, device=device,
                                  generator=gen)
    return build_fusion_state(cfg, batch_size, device, gen)


def quality_curve(cfg, regime: str = "fusion", steps: int = 10000,
                  eval_every: int = 500, eval_batches: int = 2,
                  out: str = "runs/quality_curve.jsonl",
                  anchor_file: str = ANCHOR_FILE, pin_anchor: bool = False,
                  allow_anchor_drift: bool = False, device="cuda") -> dict:
    """The run of the module docstring; returns its last line's dict."""
    import numpy as np
    import torch

    from maavss_tpu_torch.data.dataset import AVDataset, split_train_val
    from maavss_tpu_torch.train.infer import make_separator
    from maavss_tpu_torch.train.setup import (
        load_pgram_store,
        load_stores,
        make_stream,
        resolve_noise_schedule,
    )
    from maavss_tpu_torch.train.steps import make_frames_step, make_fusion_step
    from tools.evaluate_torch import cuda_device

    if cfg.lr_schedule != "constant" or cfg.noise_schedule:
        cfg = cfg.replace(epochs=1, steps_per_epoch=steps)
    device = cuda_device(device, "quality_curve_torch")
    frames_model = regime == "frames"
    frames, audio = load_stores(cfg)
    pg = None if frames_model else load_pgram_store(cfg)
    clip_len = cfg.num_frames + cfg.num_seq
    dataset = AVDataset(cfg, frames, audio, clip_len, pgrams=pg)
    halo = cfg.frames_halo if frames_model else 0
    train_ds = dataset if not halo else AVDataset(
        cfg, frames, audio, clip_len + 2 * halo, pgrams=pg)
    tr_idx, va_idx = split_train_val(len(dataset), cfg.split, cfg.seed)
    if halo:
        tr_idx, _ = split_train_val(len(train_ds), cfg.split, cfg.seed)
    if len(va_idx) < cfg.batch_size:
        va_idx = np.arange(len(dataset))

    frame_size = dataset[0]["frames"].shape[-1] if frames_model else None
    model, state = build_state(cfg, regime, cfg.batch_size, frame_size,
                               device)
    if frames_model:
        step = make_frames_step(model, cfg, device=device, k_steps=1)
    else:
        step = make_fusion_step(model, cfg, window_mode=cfg.window_mode,
                                device=device, k_steps=1)
    separate = make_separator(model, cfg, frames_model)

    train_it = make_stream(cfg, train_ds, tr_idx, cfg.seed)
    val_it = make_stream(cfg, dataset, va_idx, cfg.seed + 1)
    val_batches = [next(val_it) for _ in range(eval_batches)]
    val_dev = [{k: torch.from_numpy(v).to(device) for k, v in vb.items()}
               for vb in val_batches]

    mode_probs = None
    if cfg.mode_schedule and cfg.mode_schedule.startswith("random:"):
        ws = np.asarray([float(x) for x in
                         cfg.mode_schedule[len("random:"):].split(",")])
        mode_probs = ws / ws.sum()
    elif cfg.mode_schedule and cfg.mode_schedule != "fixed":
        raise SystemExit("quality_curve supports --mode_schedule fixed or "
                         "random:<pa>,<pv>,<pav> (see comment)")
    np_rng = np.random.default_rng(cfg.seed)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    anchor_drift = False

    def evaluate(at_step):
        sdrs, gains, noisy = [], [], []
        for i, vb in enumerate(val_dev):
            gen = torch.Generator(device=device).manual_seed(
                eval_seed(cfg, i))
            res = separate(vb, gen)
            sdrs.extend(res["si_sdr"].tolist())
            gains.extend(res["si_sdr_gain"].tolist())
            noisy.extend(res["si_sdr_noisy"].tolist())
        rec = {"step": at_step, "si_sdr": float(np.mean(sdrs)),
               "si_sdr_gain": float(np.mean(gains)),
               "noisy_anchor": float(np.mean(noisy)), "n_clips": len(sdrs),
               "ts": time.time()}
        if anchor_drift:
            rec["anchor_drift"] = True
        with open(out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
        return rec

    sha = batch_sha256(val_batches)
    recipe = anchor_recipe(cfg, regime, eval_batches)
    noise_fn = resolve_noise_schedule(cfg)
    rec0 = evaluate(0)
    if pin_anchor:
        os.makedirs(os.path.dirname(anchor_file) or ".", exist_ok=True)
        with open(anchor_file, "w") as f:
            json.dump({"recipe": recipe, "batch_sha256": sha,
                       "anchor_db": rec0["noisy_anchor"],
                       "platform": torch.device(device).type,
                       "pinned_at": time.strftime("%Y-%m-%d")}, f, indent=1)
        print(f"[anchor] pinned {rec0['noisy_anchor']:.4f} dB (batches "
              f"{sha[:12]}) -> {anchor_file}", flush=True)
    else:
        anchor_drift = check_anchor(anchor_file, recipe, sha,
                                    rec0["noisy_anchor"], allow_anchor_drift)

    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    t0 = time.perf_counter()
    loss = float("nan")
    for s in range(1, steps + 1):
        mode = 2 if mode_probs is None else int(np_rng.choice(3, p=mode_probs))
        noise = None if noise_fn is None else noise_fn(s - 1)
        state, metrics = step(state, next(train_it), mode, gen, noise)
        if s % eval_every == 0:
            loss = float(metrics["loss"])  # the segment's fetch
            rec = evaluate(s)
            rec.update(loss=loss, wall_s=round(time.perf_counter() - t0, 1))
            print(f"step {s}/{steps} loss {loss:.6f} "
                  f"si_sdr {rec['si_sdr']:.2f} dB", flush=True)
    final = evaluate(steps)
    summary = {"final": final, "loss": loss,
               "wall_s": round(time.perf_counter() - t0, 1),
               "regime": regime, "mask_head": cfg.mask_head}
    print(json.dumps(summary))
    return summary


def main(argv=None) -> dict:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--regime", choices=("fusion", "frames"),
                     default="fusion")
    pre.add_argument("--steps", type=int, default=10000)
    pre.add_argument("--eval_every", type=int, default=500)
    pre.add_argument("--eval_batches", type=int, default=2)
    pre.add_argument("--out", default="runs/quality_curve.jsonl")
    pre.add_argument("--anchor_file", default=ANCHOR_FILE,
                     help="committed eval-anchor pin")
    pre.add_argument("--pin_anchor", action="store_true",
                     help="write the measured anchor to --anchor_file")
    pre.add_argument("--allow_anchor_drift", action="store_true",
                     help="downgrade an anchor mismatch to a loud relabel")
    pre.add_argument("--device", default="cuda")
    own, rest = pre.parse_known_args(argv)

    from maavss_tpu_torch.config import model_args

    return quality_curve(model_args(rest), own.regime, own.steps,
                         own.eval_every, own.eval_batches, own.out,
                         own.anchor_file, own.pin_anchor,
                         own.allow_anchor_drift, own.device)


if __name__ == "__main__":
    main()
