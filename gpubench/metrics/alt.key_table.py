"""alt.key_table: the `key_table` timer (the word table of the whitelist
and its reverse complements) in seconds per million LR rows."""

from gpubench.metrics import per_million


def read(ctx):
    return per_million(ctx, "key_table")
