"""lr.read_fastq: the FASTQ parse (PROF `stage.read_fastq` on the streamed
path, the `read_fastq` timer otherwise) in seconds per million reads."""

from gpubench.metrics import per_million


def read(ctx):
    got = per_million(ctx, "stage.read_fastq")
    return got if got is not None else per_million(ctx, "read_fastq")
