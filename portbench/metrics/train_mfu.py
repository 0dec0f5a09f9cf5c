"""The model's FLOPs a step (counts/model_flops.py) over the time a step
with the profiler off, as a share of the card's bf16 tensor peak."""

from portbench import tracing
from portbench.counts import model_flops, peaks


def read(ctx):
    flops = model_flops.count(ctx.cfg, train=True)
    return 100.0 * flops / tracing.step_s(ctx.window) / peaks.OPS_PER_S["bf16_tensor"]
