"""lr.adapter_scan: the `adapter_scan` timer (the streamed scan:
prefilter, packing, K6, collection) in seconds per million reads."""

from gpubench.metrics import per_million


def read(ctx):
    return per_million(ctx, "adapter_scan")
