"""Device milliseconds a train step of the frames model spends in kernels
launched under the 5-D convolutions (aten::convolution and
aten::convolution_backward on 5-D inputs: the visual trunk's conv3d,
forward and backward)."""

RECORD_SHAPES = True  # the predicate reads the ops' input dims


def is_conv3d(event):
    if event.get("name") not in ("aten::convolution",
                                 "aten::convolution_backward"):
        return False
    dims = (event.get("args") or {}).get("Input Dims") or [[]]
    return len(dims[0]) == 5


UNDER = {"conv3d_ms": is_conv3d}


def read(ctx):
    s = ctx.trace.under.get("conv3d_ms")
    if not s or ctx.units <= 0:
        return None
    return 1e3 * s / ctx.units
