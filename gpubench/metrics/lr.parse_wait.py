"""lr.parse_wait: the `scan.parse_wait` spans (the scan waiting on the
FASTQ parse queue) in seconds per million reads."""

from gpubench.spans import per_million, total_s


def read(ctx):
    return per_million(ctx, total_s(ctx, "scan.parse_wait"))
