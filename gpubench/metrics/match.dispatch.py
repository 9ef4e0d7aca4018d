"""match.dispatch: the self time of the `match.dispatch` spans (chunk
packing, maxlens, upload, launch and the pinned copy back, without the
`match.device_wait` inside) in seconds per million segments."""

from gpubench.spans import per_million, self_s


def read(ctx):
    return per_million(ctx, self_s(ctx, "match.dispatch"))
