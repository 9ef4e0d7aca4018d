"""match.prefilter_d1: reads the host prefilter's distance-1 tier
resolved at distance 1 (`prefilter_d1_resolved`) over all reads (`reads`),
in %."""

from gpubench.metrics import counters, percent


def read(ctx):
    return percent(counters(ctx, "prefilter_d1_resolved"), counters(ctx, "reads"))
