"""K5, the frames trunk's fused BatchNorm + pool + LeakyReLU epilogue
(ops/cuda_epilogue: `partials_kernel` and `stats_combine_kernel`,
`apply_kernel` or `apply_vec_kernel`, `bwd_partials_kernel`, `dy_kernel`):
its least time at the stages it takes, a call per microbatch, over its
device time. A rename or a replacement of these kernels leaves the metric
unread."""

from perfbench.core.readers import roofline_percent
from perfbench.core.work import DTYPE_BYTES, frames_k5_shapes, k5_bounds

KERNELS = ("partials_kernel", "stats_combine_kernel", "apply_kernel",
           "apply_vec_kernel", "bwd_partials_kernel", "dy_kernel")
LAUNCHES = {"epilogue_stats": 2, "epilogue_apply": 1,
            "epilogue_bwd_reduce": 1, "epilogue_bwd_dy": 1}


def read(ctx):
    cfg = ctx.cfg
    mb = cfg["microbatch"]
    io = DTYPE_BYTES[cfg["dtype"]]
    rows = ctx.traffic["batch_size"] // mb
    per_step = mb * sum(sum(k5_bounds(io, s).values())
                        for s in frames_k5_shapes(cfg, rows))
    return roofline_percent(ctx, "k5_roofline", KERNELS, LAUNCHES, per_step)
