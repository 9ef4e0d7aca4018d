"""match.ties: the `match.ties` timer (tie sets and escalation) in seconds
per million segments."""

from gpubench.metrics import per_million


def read(ctx):
    return per_million(ctx, "match.ties")
