"""match.write: the stage's `write` timer (the gz TSV) in seconds per
million segments."""

from gpubench.metrics import per_million


def read(ctx):
    return per_million(ctx, "write")
