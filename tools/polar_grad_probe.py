#!/usr/bin/env python
"""Which kernel moves the fusion train step's gradients under --use_polar
(and --mask_head)? One step of the full-width fusion flagship (batch 8,
scan windows, mode 2, lr 1e-3, noise_scalar 0, seeded random weights)
with all plain versions (ConvStack, the LSTM scan, K4's plain versions, the
plain Adam formula), then with one group of kernels on at a time, all from
one state_dict, and last the plain versions fed K2's phasegram latent
(each window's phasegram-encoder output taken from the K2 step) in place
of ConvStack's. Prints one JSON line per (flags, variant): the three
leaves whose step-1 gradients differ most from the plain step's (relative
L2; the conv biases that feed a train-mode BatchNorm, whose true gradient
is 0, left out) and, for the K2 variants, how far the phasegram latent
stands from ConvStack's. On the card only (TF32 off); needs nothing
outside the checkout.

Usage: python3 tools/polar_grad_probe.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# variant: (LSTM backend, --pgenc_kernel, K4 plain)
VARIANTS = {"all_kernels": ("auto", "auto", False),
            "k1_only": ("auto", "xla", True),
            "k2_only": ("scan", "auto", True),
            "k4_only": ("scan", "xla", False)}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("polar_grad_probe: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke
    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.train.setup import build_fusion
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_fusion_step

    def step1_grads(cfg, init, batch, lstm, pgenc, k4_plain, latents=None):
        """(step-1 gradients, model, the phasegram latent of each window);
        `latents` replaces each window's phasegram latent."""
        c = cfg.replace(pgenc_kernel=pgenc, opt_kernel="xla")
        model = build_fusion(c, cfg.batch_size, device="cuda")
        model.load_state_dict(init)
        if lstm == "scan":
            model.lstm.backend = "scan"
        seen = []

        def latent(module, inputs, out):
            seen.append(out.detach().clone())
            if latents is not None:
                return latents[len(seen) - 1].clone()

        hook = model.phasegram_encoder.register_forward_hook(latent)
        state = create_train_state(model, c, "cuda")
        grads = chip_smoke._grab_step1_grads(state, model)
        step = make_fusion_step(model, c, device="cuda")
        (chip_smoke._plain_k4(step) if k4_plain else step)(state, batch, 2)
        torch.cuda.synchronize()
        hook.remove()
        return grads, model, seen

    def rel(a, b) -> float:
        return ((a.double() - b.double()).norm()
                / b.double().norm().clamp(min=1e-30)).item()

    for flags in (dict(use_polar=True), dict(mask_head=True)):
        cfg = RunConfig(batch_size=8, noise_scalar=0.0, learning_rate=1e-3,
                        **flags)
        init = build_fusion(cfg, cfg.batch_size, device="cuda").state_dict()
        batch = synthetic_av_batch(cfg, cfg.batch_size, seed=cfg.seed)
        plain, model, plain_latents = step1_grads(cfg, init, batch, "scan",
                                                  "xla", True)
        fed = set(model.bn_fed_biases())
        k2_latents = None
        for name, variant in (*VARIANTS.items(),
                              ("plain_fed_k2_latent", ("scan", "xla", True))):
            grads, _, latents = step1_grads(
                cfg, init, batch, *variant,
                latents=k2_latents if name == "plain_fed_k2_latent" else None)
            if name == "k2_only":
                k2_latents = latents
            worst = sorted(((rel(grads[k], plain[k]), k) for k in grads
                            if k not in fed), reverse=True)[:3]
            line = {"flags": flags, "variant": name,
                    "worst_grad_rel_l2": worst}
            if name in ("k2_only", "plain_fed_k2_latent"):
                line["k2_latent_rel_l2"] = [rel(a, b) for a, b in
                                            zip(k2_latents, plain_latents)]
            print(json.dumps(line), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
