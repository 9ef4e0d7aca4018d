"""match.device_idle: the share of the traced window in which no kernel, copy
or set ran on the card, in %."""

from gpubench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx)
