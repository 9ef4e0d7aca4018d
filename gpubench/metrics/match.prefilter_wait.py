"""match.prefilter_wait: the `match.prep_wait` timer (waiting on the host
dist<=1 prefilter) in seconds per million segments."""

from gpubench.metrics import per_million


def read(ctx):
    return per_million(ctx, "match.prep_wait")
