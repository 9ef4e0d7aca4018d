"""lr.prefilter: the adapter prefilter's spans, `scan.d0probe_raw` (its
worker's raw scan) and `scan.d0probe` (applying it), in seconds per
million reads."""

from gpubench.spans import per_million, total_s


def read(ctx):
    return per_million(ctx, total_s(ctx, "scan.d0probe_raw", "scan.d0probe"))
