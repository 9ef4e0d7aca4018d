"""alt.read_lr_tsv: the `read_lr_tsv` spans (the LR TSV read and the NA
filter) in seconds per million LR rows."""

from gpubench.spans import per_million, total_s


def read(ctx):
    return per_million(ctx, total_s(ctx, "read_lr_tsv"))
