"""K4^T, the window matmul's S^T mode (the aggregation's backward): its
bound on the plan's shapes over its mean device time a launch."""

from portbench import tracing
from portbench.counts import window_matmul

PATTERN = r"persistent::kernel<true|window_matmul_kernel<true"


def read(ctx):
    return tracing.roofline_pct(ctx.trace, PATTERN,
                                window_matmul.count(ctx.plan, transpose=True))
