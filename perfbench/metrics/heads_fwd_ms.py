"""Device milliseconds a train step spends in kernels launched inside the
program's `maavss.heads` spans (the models' output heads after the fusion
core, the mask head included, forward), attributed by the launches'
correlation ids; None where nothing ran inside them."""


def in_span(event):
    return event.get("name") == "maavss.heads"


UNDER = {"heads_fwd_ms": in_span}


def read(ctx):
    s = ctx.trace.under.get("heads_fwd_ms")
    if not s or ctx.units <= 0:
        return None
    return 1e3 * s / ctx.units
