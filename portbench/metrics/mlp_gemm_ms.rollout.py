"""Device milliseconds a step in the library's matrix products (cuBLAS GEMM
and GEMV kernels, by name): the MLPs and the projections."""

from portbench import tracing

PATTERN = r"(?i)gemm|gemv"


def read(ctx):
    return tracing.ms_per_step(ctx.trace, PATTERN)
