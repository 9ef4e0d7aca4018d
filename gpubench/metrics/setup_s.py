"""setup_s: seconds from the start of the process to the end of the
warm-up invocation (torch import, kernel load or build, inputs, warm-up)."""


def read(ctx):
    return ctx.setup_s
