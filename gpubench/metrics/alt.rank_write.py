"""alt.rank_write: the `rank` and `write` timers (count, rank, cutoff,
gz TSV) in seconds per million LR rows."""

from gpubench.metrics import per_million


def read(ctx):
    return per_million(ctx, "rank", "write")
