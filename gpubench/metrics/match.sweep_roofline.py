"""match.sweep_roofline: the device sweep (the FULL entry of
`match_sweep`, fixed-length and ragged, with `merge_splits`) against
gpubench.roofline: reads handed to the device (`device_reads`) x patterns x
mean segment length, over the kernels' time in the trace, in %."""

import re

from gpubench import roofline
from gpubench.metrics import counters, kernel_seconds

SWEEP = re.compile(r"match_sweep<\s*(false|true)\s*,\s*0\s*>|match_sweepILb[01]ELi0E|merge_splits")


def read(ctx):
    reads = counters(ctx, "device_reads")
    if not reads:
        return None
    s = ctx.summary
    least = roofline.sweep_seconds(reads, s["patterns"], s["mean_segment_len"], s["barcode_length"])
    return roofline.share_pct(least, kernel_seconds(ctx, SWEEP))
