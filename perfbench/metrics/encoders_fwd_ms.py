"""Device milliseconds a train step spends in kernels launched inside the
program's `maavss.encoders` spans (the models' encoders, forward: the
frames model's visual trunk and STFT encoder, the fusion model's two),
attributed by the launches' correlation ids; None where nothing ran
inside them."""


def in_span(event):
    return event.get("name") == "maavss.encoders"


UNDER = {"encoders_fwd_ms": in_span}


def read(ctx):
    s = ctx.trace.under.get("encoders_fwd_ms")
    if not s or ctx.units <= 0:
        return None
    return 1e3 * s / ctx.units
