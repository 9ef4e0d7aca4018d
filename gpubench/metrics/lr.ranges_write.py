"""lr.ranges_write: the PROF timers `stage.ranges_filter` and
`stage.write` (range detection, filter, gz TSV) in seconds per million
reads."""

from gpubench.metrics import per_million


def read(ctx):
    return per_million(ctx, "stage.ranges_filter", "stage.write")
