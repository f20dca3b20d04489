"""Device milliseconds a train step spends in the backward: kernels launched
inside the autograd engine's `autograd::engine::evaluate_function: <node>`
events, which enclose each backward node on the thread that runs it (on
the card the engine's device thread, not the one that calls
`.backward()`), attributed by the launches' correlation ids; None where
none ran inside them."""

PREFIX = "autograd::engine::evaluate_function"


def in_backward(event):
    return event.get("name", "").startswith(PREFIX)


UNDER = {"backward_ms": in_backward}


def read(ctx):
    s = ctx.trace.under.get("backward_ms")
    if not s or ctx.units <= 0:
        return None
    return 1e3 * s / ctx.units
