"""lr.slots_roofline: K6 SLOTS (`adapter_slots`) against
gpubench.roofline: reads handed to it (PROF `scan.kernel_reads`) x mean
read length x 2 strands, over the kernel's time in the trace, in %."""

import re

from gpubench import roofline
from gpubench.metrics import counters, kernel_seconds

SLOTS = re.compile(r"adapter_slots")


def read(ctx):
    reads = counters(ctx, "scan.kernel_reads")
    if not reads:
        return None
    s = ctx.summary
    least = roofline.slots_seconds(reads * s["mean_read_len"], s["adapter_len"])
    return roofline.share_pct(least, kernel_seconds(ctx, SLOTS))
