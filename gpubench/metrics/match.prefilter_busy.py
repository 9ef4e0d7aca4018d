"""match.prefilter_busy: the `match.prep` spans (the prep worker's encode
and dist<=1 probe of each slice) in seconds per million segments."""

from gpubench.spans import per_million, total_s


def read(ctx):
    return per_million(ctx, total_s(ctx, "match.prep"))
