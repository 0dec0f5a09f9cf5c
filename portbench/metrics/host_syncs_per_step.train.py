"""Synchronizing calls a train step under CUDA's sync debug mode."""


def read(ctx):
    return ctx.syncs_per_step
