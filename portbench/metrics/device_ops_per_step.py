"""Device operations (kernels, copies, fills) in the trace a step
(``device_ops_per_step.rollout`` and ``.train``)."""


def read(ctx):
    return len(ctx.trace.device) / ctx.trace.steps
