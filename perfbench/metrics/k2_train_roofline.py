"""K2 in training (ops/cuda_pgenc: the forward `conv_bn_train_kernel`, the
backward `bn_bwd_kernel` and `grads_kernel`): its least time at the
phasegram encoder's shapes over its device time. A rename or a
replacement of these kernels leaves the metric unread."""

from perfbench.core.readers import roofline_percent
from perfbench.core.work import k2_bounds

KERNELS = ("conv_bn_train_kernel", "bn_bwd_kernel", "grads_kernel")
LAUNCHES = {"pgenc_train": 1, "pgenc_bwd": 2}


def read(ctx):
    cfg = ctx.cfg
    rows = ctx.traffic["batch_size"] * (cfg["num_frames"] + cfg["num_seq"]
                                        - 1)
    b = k2_bounds(cfg, rows)
    return roofline_percent(ctx, "k2_train_roofline", KERNELS, LAUNCHES,
                            b["train"] + b["bwd"])
