"""match.device_wait: the `match.device_wait` timer (waiting on the device
sweep's rows) in seconds per million segments."""

from gpubench.metrics import per_million


def read(ctx):
    return per_million(ctx, "match.device_wait")
