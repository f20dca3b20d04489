"""Device milliseconds a train step spends in kernels launched inside the
program's `maavss.update` spans (train/steps.py: the gradients' zeroing,
their division over microbatch chunks and their all-reduce, the watch
metrics and the optimizer's update), attributed by the launches'
correlation ids; None where nothing ran inside them."""


def in_span(event):
    return event.get("name") == "maavss.update"


UNDER = {"update_ms": in_span}


def read(ctx):
    s = ctx.trace.under.get("update_ms")
    if not s or ctx.units <= 0:
        return None
    return 1e3 * s / ctx.units
