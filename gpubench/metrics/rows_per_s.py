"""rows_per_s: rows of all invocations completed in the window over the time
from the window's start to the end of the last invocation (host clock)."""

from gpubench.metrics import rate


def read(ctx):
    return rate(ctx, "rows")
