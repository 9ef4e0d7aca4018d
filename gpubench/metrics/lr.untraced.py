"""lr.untraced: the share of the `extract_lr_bc` stage span on the stage's
own thread that no span covers, in %."""

from gpubench.spans import untraced_pct


def read(ctx):
    return untraced_pct(ctx)
