"""The train step's model FLOPs (from the configuration's shapes, by its
family's `forward_flops`; the backward at twice the forward) over the
traced window, as a share of one H100's dense bf16 peak."""

from perfbench.core.readers import mfu_percent


def read(ctx):
    b = ctx.traffic["batch_size"]
    return mfu_percent(ctx, 3 * ctx.fam.forward_flops(ctx.cfg, b))
