"""alt.probe_upload: the `probe.upload` spans (the key table copied to the
device) in seconds per million LR rows."""

from gpubench.spans import per_million, total_s


def read(ctx):
    return per_million(ctx, total_s(ctx, "probe.upload"))
