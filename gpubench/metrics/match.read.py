"""match.read: the stage's `read` timer (both TSVs parsed) in seconds per
million segments."""

from gpubench.metrics import per_million


def read(ctx):
    return per_million(ctx, "read")
