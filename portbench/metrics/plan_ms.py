"""Device milliseconds a step in the re-neighbouring round's kernels
(``plan_ms.rollout`` and ``.train``): K1' (the codes k-NN), K2
(s_decode), K3 (s_onehot) and, in a train step, K7 (reverse_table)."""

from portbench import tracing

PATTERN = r"knn_select_kernel|s_decode_kernel|s_onehot_kernel|reverse_table_kernel"


def read(ctx):
    return tracing.ms_per_step(ctx.trace, PATTERN)
