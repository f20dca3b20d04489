#!/usr/bin/env python3
"""How far the fusion train step's first Adam update moves each leaf
between the kernels and the plain versions, on the card.

    python3 tools/fusion_step1_probe_torch.py [--tree DIR]

`--tree` runs the checkout at DIR (its package and its chip_smoke.py's
helpers; default: this one), so that a parent commit unpacked into a
git-ignored directory and the change can be probed in one call. From one
state_dict (the flagship, batch 8, scan windows, mode 2, lr 1e-3, noise 0:
chip_smoke.py's train phase), one step with every kernel, one with the
plain versions and one more plain step on the batch in reverse row order
with fp64 BatchNorm statistics (chip_smoke._reordered_step1_grads: the
rounding of one correct fp32 step). For the 8 leaves that move furthest
apart (relative L2 of the parameters after the step), one JSON line each:
the parameters' and the gradients' relative L2 against the plain step,
the plain step's own spread, the smallest and rms |g| of the plain step,
how many elements' gradients the two steps give opposite signs or a
magnitude under 1e-6, and how far the parameters go past Adam's first
step of the gradients' difference (the bound of chip_smoke._step1_close).
Then the card's name and power limit.
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
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch

    if not cs.__file__.startswith(tree + os.sep):
        raise SystemExit(f"imported {cs.__file__}, not {tree}")
    cs.device_phase()
    lr = 1e-3
    cfg = RunConfig(batch_size=8, noise_scalar=0.0, learning_rate=lr)
    model, state, step, ref, ref_state, ref_step = cs._train_pair(cfg, False)
    batch = synthetic_av_batch(cfg, cfg.batch_size, seed=cfg.seed)
    grads = cs._grab_step1_grads(state, model)
    ref_grads = cs._grab_step1_grads(ref_state, ref)
    alt_grads = cs._reordered_step1_grads(cfg, ref, batch, False)
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
            "min_abs_grad": g_ref.abs().min().item(),
            "rms_grad": g_ref.square().mean().sqrt().item(),
            "sign_flips": int(((g > 0) != (g_ref > 0)).sum().item()),
            "grads_under_1e-6": int((g_ref.abs() < 1e-6).sum().item()),
            "elements": g.numel(),
            "past_adam_bound": ((a - b).abs() - bound * 1.0001
                                - 1e-6 * (b.abs() + lr)).max().item()})
    for row in sorted(rows, key=lambda d: -d["param_rel_l2"])[:8]:
        print(json.dumps({"tree": os.path.relpath(tree, ROOT), **row}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
