"""match.sweep_padding: read positions the device sweep stepped through
past a read's own length (`sweep_pad_cells`: up to its block's longest
read, and a chunk's pad reads) over all it stepped through (`sweep_cells`),
in %."""

from gpubench.metrics import counters, percent


def read(ctx):
    return percent(counters(ctx, "sweep_pad_cells"), counters(ctx, "sweep_cells"))
