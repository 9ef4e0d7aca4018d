"""match.nb_build: the `match.nb_build` span (the neighborhood index's
build on its own thread) in seconds per million segments."""

from gpubench.spans import per_million, total_s


def read(ctx):
    return per_million(ctx, total_s(ctx, "match.nb_build"))
