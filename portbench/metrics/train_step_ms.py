"""The window's seconds over every train step completed in it."""


def read(ctx):
    return ctx.window["seconds"] / len(ctx.window["ok"]) * 1e3
