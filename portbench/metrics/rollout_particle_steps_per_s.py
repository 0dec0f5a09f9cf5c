"""Particles times rollout steps of every certified request completed in
the window, over the window's seconds."""


def read(ctx):
    w = ctx.window
    return w["ok"].count(True) * w["work_per_request"] / w["seconds"]
