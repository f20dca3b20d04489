"""Device milliseconds a train step spends in kernels launched inside the
program's `maavss.fusion_core` spans (the models' `av_fusion_forward`: the
BiLSTM, fc1 and fc2, forward), attributed by the launches' correlation
ids; None where nothing ran inside them."""


def in_span(event):
    return event.get("name") == "maavss.fusion_core"


UNDER = {"fusion_core_fwd_ms": in_span}


def read(ctx):
    s = ctx.trace.under.get("fusion_core_fwd_ms")
    if not s or ctx.units <= 0:
        return None
    return 1e3 * s / ctx.units
