"""Set-up: from the process's start to the first timed request (imports,
kernel libraries, weights and frames on the device, the warm-up)."""


def read(ctx):
    return ctx.setup_seconds
