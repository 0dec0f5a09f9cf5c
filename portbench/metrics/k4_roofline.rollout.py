"""K4, the window matmul (both of its CUDA kernels, forward mode): its
bound on the plan's shapes (counts/window_matmul.py) over its mean device
time a launch."""

from portbench import tracing
from portbench.counts import window_matmul

PATTERN = r"persistent::kernel<false|window_matmul_kernel<false"


def read(ctx):
    return tracing.roofline_pct(ctx.trace, PATTERN, window_matmul.count(ctx.plan))
