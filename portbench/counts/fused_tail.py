"""K5, the fused step tail, and K6, its recompute-backward, on the N
particles' rows of width L = H (chip_smoke.py's counts, frozen here). K5
in: the carry x, the aggregate, the weights ((3 L^2 + 5 L) float32); out:
the new carry. Three L x L products a row. K6 in: x, the aggregate, the
carry's gradient, the weights; out: dx, the aggregate's gradient and the
weights' gradients. Nine products a row (three recomputed, six backward).
Rows the program adds (the slot-space carry runs the tail on every slot of
the plan, padding included) are its overhead: they read as a lower share."""


def count(plan: dict, backward: bool = False) -> dict:
    rows, width = plan["num_particles"], plan["latent"]
    carry, agg = plan["carry_bytes"], plan["agg_bytes"]
    w_bytes = (3 * width * width + 5 * width) * 4
    if backward:
        nbytes = rows * width * (3 * carry + 2 * agg) + 2 * w_bytes
        ops = 9 * 2 * rows * width * width
    else:
        nbytes = rows * width * (2 * carry + agg) + w_bytes
        ops = 3 * 2 * rows * width * width
    return {"bytes": nbytes, "ops": ops, "op_rate": "bf16_tensor"}
