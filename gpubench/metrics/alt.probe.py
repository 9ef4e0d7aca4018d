"""alt.probe: the `probe` timer (the device probe of every window) in
seconds per million LR rows."""

from gpubench.metrics import per_million


def read(ctx):
    return per_million(ctx, "probe")
