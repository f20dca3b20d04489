#!/usr/bin/env python
"""How well conditioned is the frames train step's gradient? One step of
the full-width frames model (framesize 256, batch 8, 4 windows, mode 2,
seeded random weights, noise_scalar 0) in several variants from one
state_dict, each variant's step-1 gradients and parameters compared with
those of the kernel step:

- kernels_again: the same kernel step a second time (cuDNN's own spread);
- k5_plain: K5's plain versions in place of its kernels;
- k5_plain_kernel_stats: the same, but fed the K5 kernel's batch statistics;
- unfused_tail: the PyTorch model without K5 (BN, max_pool3d, leaky);
- lstm_scan: the K5 kernels with the LSTM's plain scan and plain Adam.

Prints one JSON line per variant: the loss, and per visual-encoder conv
weight the gradient's relative L2 error and the parameter's after step 1,
plus the same for fc1 and the STFT encoder's first conv. On the card only
(TF32 off); it needs nothing outside the checkout.

Usage: python3 tools/frames_grad_probe.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("frames_grad_probe: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop("MAAVSS_S2D_MIN_HW", None)

    from maavss_tpu_torch.config import RunConfig
    from maavss_tpu_torch.data.synthetic import synthetic_av_batch
    from maavss_tpu_torch.models import layers
    from maavss_tpu_torch.ops import cuda_epilogue as ep
    from maavss_tpu_torch.train.setup import build_frames_model
    from maavss_tpu_torch.train.state import create_train_state
    from maavss_tpu_torch.train.steps import make_frames_step

    cfg = RunConfig(batch_size=8, noise_scalar=0.0, learning_rate=1e-3)
    init = build_frames_model(cfg, 8, device="cpu", generator=torch
                              .Generator().manual_seed(cfg.seed)).state_dict()
    batch = synthetic_av_batch(cfg, 8, seed=cfg.seed,
                               frame_size=cfg.framesize)

    def run(k5: str, lstm: str = "kernel", opt: str = "auto"):
        c = cfg.replace(opt_kernel=opt)
        model = build_frames_model(c, 8)
        model.load_state_dict(init)
        model.lstm.backend = lstm
        state = create_train_state(model, c)
        grads = {}
        update = state.tx.step

        def grab_then_update():
            grads.update({n: p.grad.detach().clone()
                          for n, p in model.named_parameters()
                          if p.grad is not None})
            update()

        state.tx.step = grab_then_update
        saved = (layers.fused_bn_pool_leaky, ep.epilogue_stats_plain,
                 os.environ.get("MAAVSS_S2D_MIN_HW"))
        if k5 in ("plain", "plain_kernel_stats"):
            layers.fused_bn_pool_leaky = ep.fused_bn_pool_leaky_plain
        if k5 == "plain_kernel_stats":
            ep.epilogue_stats_plain = ep.epilogue_stats
        if k5 == "unfused":
            os.environ["MAAVSS_S2D_MIN_HW"] = str(1 << 30)
        try:
            _, metrics = make_frames_step(model, c)(state, batch, 2)
            torch.cuda.synchronize()
        finally:
            layers.fused_bn_pool_leaky, ep.epilogue_stats_plain = saved[:2]
            if saved[2] is None:
                os.environ.pop("MAAVSS_S2D_MIN_HW", None)
            else:
                os.environ["MAAVSS_S2D_MIN_HW"] = saved[2]
        return float(metrics["loss"]), grads, model.state_dict()

    def rel(a, b) -> float:
        return ((a.double() - b.double()).norm()
                / b.double().norm().clamp(min=1e-30)).item()

    base_loss, base_g, base_p = run("kernel")
    leaves = [f"visual_encoder.Conv_{i}.weight" for i in range(5)] + [
        "stft_encoder.Conv_0.weight", "fc1.weight"]
    variants = {"kernels_again": ("kernel",), "k5_plain": ("plain",),
                "k5_plain_kernel_stats": ("plain_kernel_stats",),
                "unfused_tail": ("unfused",),
                "lstm_scan": ("kernel", "scan", "xla")}
    for name, args in variants.items():
        loss, g, p = run(*args)
        print(json.dumps({
            "variant": name, "loss": loss, "kernel_loss": base_loss,
            "grad_rel_l2": {k: rel(g[k], base_g[k]) for k in leaves},
            "param_rel_l2_after_step1": {k: rel(p[k], base_p[k])
                                         for k in leaves}}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
