"""match.prefilter_resolved: reads the host prefilter decided
(`prefilter_resolved`) over all reads (`reads`), in %."""

from gpubench.metrics import counters, percent


def read(ctx):
    return percent(counters(ctx, "prefilter_resolved"), counters(ctx, "reads"))
