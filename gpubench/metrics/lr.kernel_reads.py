"""lr.kernel_reads: reads handed to K6 SLOTS (PROF `scan.kernel_reads`)
over all reads (`reads`), in %."""

from gpubench.metrics import counters, percent


def read(ctx):
    return percent(counters(ctx, "scan.kernel_reads"), counters(ctx, "reads"))
