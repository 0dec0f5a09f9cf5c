"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"bf16_tensor": 989e12, "tf32_tensor": 495e12, "f32": 67e12}


def bound_s(nbytes: float, ops: float, op_rate: str):
    """``(seconds, "bytes" or "operations")``: the least time the card could
    take, the larger of the bytes over the bandwidth and the operations over
    their type's peak, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[op_rate]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
