"""Device milliseconds a train step spends in kernels launched inside the
program's `maavss.frontend` spans (train/steps.py: the batch to the
device, the STFT pair, the frames or phasegram rows and their windows, the
input masks), attributed by the launches' correlation ids; None where
nothing ran inside them."""


def in_span(event):
    return event.get("name") == "maavss.frontend"


UNDER = {"frontend_ms": in_span}


def read(ctx):
    s = ctx.trace.under.get("frontend_ms")
    if not s or ctx.units <= 0:
        return None
    return 1e3 * s / ctx.units
