#!/usr/bin/env python3
"""How far the fusion train step's first Adam update moves each leaf
between the kernels and the plain versions, on the card.

    python3 tools/fusion_step1_probe_torch.py [--tree DIR]
        [--fusion_encode full] [--pgram_cache] [--batch 8] [--microbatch 1]

`--tree` runs the checkout at DIR (its package and its chip_smoke.py's
helpers; default: this one), so that a parent commit unpacked into a
git-ignored directory and the change can be probed in one call. From one
state_dict (the flagship, batch 8, scan windows, mode 2, lr 1e-3, noise 0:
chip_smoke.py's train phase; `--fusion_encode full --pgram_cache` its
fullenc_train phase, on float16 rows; `--batch` and `--microbatch` set
the batch and its chunks), one step with every kernel, one with
the plain versions and one more plain step on the batch in reverse row
order with fp64 BatchNorm statistics (chip_smoke._reordered_step1_grads:
the rounding of one correct fp32 step). More plain steps split what the
kernels change: one with K2 (the fused-layer stack) in place of ConvStack,
one with K1 in place of the LSTM scan and one on the STFT kernel's
features, all else plain (`k2_grad_rel_l2`, `k1_grad_rel_l2`,
`stft_grad_rel_l2`: each kernel's share), and one each on
the visual input and on the audio multiplied by 1 + 1e-7 x N(0, 1)
(`perturbed_grad_rel_l2`, `audio_perturbed_grad_rel_l2`: how far a
rounding-sized change of an input moves a gradient; with raw frames the
visual one also flips the phase of the FFT's near-zero bins, so read it
with --pgram_cache).
For the 8 leaves that move furthest apart (relative L2 of the parameters
after the step), one JSON line each: the parameters' and the gradients'
relative L2 against the plain step, the plain step's own spread, those
two, the smallest and rms |g| of the plain step, how many elements'
gradients the two steps give opposite signs or a magnitude under 1e-6,
and how far the parameters go past Adam's first step of the gradients'
difference (the bound of chip_smoke._step1_close). Then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_l2(a, b) -> float:
    import torch

    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp(min=1e-12)).item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--fusion_encode", default="window",
                    choices=("window", "full"))
    ap.add_argument("--pgram_cache", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=1)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import numpy as np

    import chip_smoke as cs
    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import (
        synthetic_av_batch,
        with_pgram_rows,
    )
    from maavss_tpu_torch.train.setup import build_fusion
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_fusion_step

    if not cs.__file__.startswith(tree + os.sep):
        raise SystemExit(f"imported {cs.__file__}, not {tree}")
    cs.device_phase()
    lr = 1e-3
    cfg = RunConfig(batch_size=args.batch, noise_scalar=0.0,
                    learning_rate=lr, fusion_encode=args.fusion_encode,
                    pgram_cache=args.pgram_cache, microbatch=args.microbatch)
    model, state, step, ref, ref_state, ref_step = cs._train_pair(cfg, False)
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=cfg.seed)
    if cfg.pgram_cache:
        batch = with_pgram_rows(batch, "cuda")
    grads = cs._grab_step1_grads(state, model)
    ref_grads = cs._grab_step1_grads(ref_state, ref)
    alt_grads = cs._reordered_step1_grads(cfg, ref, batch, False)

    def plain_grads(k2, visual, k1=False, stft=False):
        """Step-1 gradients of the plain versions from ref's state_dict,
        with K2 in place of ConvStack when `k2`, K1 in place of the LSTM
        scan when `k1` and the STFT kernel's features when `stft`, on
        `visual`."""
        plain_cfg = cs._plain_cfg(cfg, False, k2_plain=not k2)
        alt = build_fusion(plain_cfg, cfg.batch_size, "cuda")
        alt.load_state_dict(ref.state_dict())
        alt.lstm.backend = "kernel" if k1 else "scan"
        alt_state = create_train_state(alt, plain_cfg, "cuda")
        out = cs._grab_step1_grads(alt_state, alt)
        cs._plain_k4(make_fusion_step(alt, plain_cfg, device="cuda"),
                     kernel_features=stft)(alt_state, dict(batch, **visual),
                                           2)
        return out

    def perturbed(key):
        noise = np.random.default_rng(0).standard_normal(batch[key].shape)
        return {key: (batch[key].astype(np.float32)
                      * (1.0 + 1e-7 * noise)).astype(np.float32)}

    k2_grads = plain_grads(True, {})
    k1_grads = plain_grads(False, {}, k1=True)
    stft_grads = plain_grads(False, {}, stft=True)
    perturbed_grads = plain_grads(
        False, perturbed("pgram" if cfg.pgram_cache else "frames"))
    audio_grads = plain_grads(False, perturbed("audio"))
    step(state, batch, 2)
    ref_step(ref_state, batch, 2)
    torch.cuda.synchronize()
    sd, sd_ref = model.state_dict(), ref.state_dict()
    fed = set(model.bn_fed_biases())
    rows = []
    for k, v in sd.items():
        if k in fed or k not in grads:
            continue
        a, b = v.float(), sd_ref[k].float()
        g, g_ref = grads[k].float(), ref_grads[k].float()
        bound = torch.clamp(lr * (g - g_ref).abs()
                            / (torch.minimum(g.abs(), g_ref.abs()) + 1e-8),
                            max=2 * lr)
        rows.append({
            "leaf": k, "param_rel_l2": rel_l2(a, b),
            "grad_rel_l2": rel_l2(g, g_ref),
            "plain_spread": rel_l2(alt_grads[k].float(), g_ref),
            "k2_grad_rel_l2": rel_l2(k2_grads[k].float(), g_ref),
            "k1_grad_rel_l2": rel_l2(k1_grads[k].float(), g_ref),
            "stft_grad_rel_l2": rel_l2(stft_grads[k].float(), g_ref),
            "perturbed_grad_rel_l2": rel_l2(perturbed_grads[k].float(),
                                            g_ref),
            "audio_perturbed_grad_rel_l2": rel_l2(audio_grads[k].float(),
                                                  g_ref),
            "min_abs_grad": g_ref.abs().min().item(),
            "rms_grad": g_ref.square().mean().sqrt().item(),
            "sign_flips": int(((g > 0) != (g_ref > 0)).sum().item()),
            "grads_under_1e-6": int((g_ref.abs() < 1e-6).sum().item()),
            "elements": g.numel(),
            "past_adam_bound": ((a - b).abs() - bound * 1.0001
                                - 1e-6 * (b.abs() + lr)).max().item()})
    for row in sorted(rows, key=lambda d: -d["param_rel_l2"])[:8]:
        print(json.dumps({"tree": os.path.relpath(tree, ROOT),
                          "fusion_encode": cfg.fusion_encode,
                          "batch": cfg.batch_size,
                          "microbatch": cfg.microbatch, **row}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
