"""K1 in training (ops/cuda_lstm: `lstm_fwd_kernel`, and the backward's
`lstm_bwd_sweep_kernel` and `lstm_bwd_dwh_kernel`): its least time at the
fusion core's shapes over its device time. The shapes are the family's
(`k1_launches`: calls a step, rows, time steps); a family without them,
a rename or a replacement of these kernels leaves the metric unread."""

from perfbench.core.readers import roofline_percent
from perfbench.core.work import DTYPE_BYTES, k1_bounds

KERNELS = ("lstm_fwd_kernel", "lstm_bwd_sweep_kernel", "lstm_bwd_dwh_kernel")
LAUNCHES = {"lstm_fwd": 1, "lstm_bwd": 2}


def read(ctx):
    shape = getattr(ctx.fam, "k1_launches", None)
    if shape is None:
        return None
    calls, rows, t = shape(ctx.cfg, ctx.traffic["batch_size"])
    k = k1_bounds(DTYPE_BYTES[ctx.cfg["dtype"]], rows, t)
    return roofline_percent(ctx, "k1_train_roofline", KERNELS, LAUNCHES,
                            calls * (k["fwd"] + k["bwd"]))
