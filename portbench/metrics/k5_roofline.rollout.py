"""K5, the fused step tail (the tuned kernel at width 128, the wide one
otherwise, with the wide one's weight conversion): its bound on the N
particles' rows (counts/fused_tail.py) over its mean device time a call."""

from portbench import tracing
from portbench.counts import fused_tail

MAIN = r"fused_tail_kernel|fused_tail_wide_kernel"
WEIGHTS = r"wide_weights_kernel"


def read(ctx):
    return tracing.roofline_pct(ctx.trace, MAIN, fused_tail.count(ctx.plan),
                                extra=tracing.device_s(ctx.trace.device, WEIGHTS))
