"""The device's idle share (``device_idle_pct.rollout`` and ``.train``):
1 - the union of its operations' intervals a step in the traced requests
over the time a step with the profiler off."""

from portbench import tracing


def read(ctx):
    busy = tracing.busy_s(ctx.trace.device) / ctx.trace.steps
    return 100.0 * (1.0 - busy / tracing.step_s(ctx.window))
