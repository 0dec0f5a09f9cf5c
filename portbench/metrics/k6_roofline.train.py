"""K6, the fused tail's recompute-backward (the tuned kernel and its
reduction, or the wide chain, weight-gradient and reduction kernels, with
its share of the weight conversions K5 and K6 both launch): its bound on
the N particles' rows (counts/fused_tail.py) over its mean device time a
call."""

from portbench import tracing
from portbench.counts import fused_tail

CALLS = r"fused_tail_bwd_kernel|fused_tail_wide_chain_kernel"
PARTS = CALLS + r"|fused_tail_wide_dw_kernel|reduce_partials_kernel"
FORWARD = r"fused_tail_kernel|fused_tail_wide_kernel"
WEIGHTS = r"wide_weights_kernel"


def read(ctx):
    events = ctx.trace.device
    calls, forwards = len(tracing.matching(events, CALLS)), len(tracing.matching(events, FORWARD))
    weights = tracing.device_s(events, WEIGHTS)
    share = weights * calls / (calls + forwards) if calls + forwards else 0.0
    return tracing.roofline_pct(ctx.trace, PARTS, fused_tail.count(ctx.plan, backward=True),
                                extra=share, calls_pattern=CALLS)
