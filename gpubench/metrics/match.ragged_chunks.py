"""match.ragged_chunks: chunks the device sweep took on its ragged entry
(K2, `maxlens`: `device_chunks_ragged`) over all chunks it swept
(`device_chunks`), in %."""

from gpubench.metrics import counters, percent


def read(ctx):
    return percent(counters(ctx, "device_chunks_ragged"), counters(ctx, "device_chunks"))
