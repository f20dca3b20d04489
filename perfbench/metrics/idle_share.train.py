"""Share of the traced training window in which no operation runs on the
device (the union of device intervals, not their sum)."""

from perfbench.core.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
