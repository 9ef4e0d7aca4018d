"""alt.read_whitelist: the `read_whitelist` timer in seconds per million
LR rows."""

from gpubench.metrics import per_million


def read(ctx):
    return per_million(ctx, "read_whitelist")
