"""K4 (the window matmul) and K4^T (its S^T mode) on one cell-block plan:
each input byte read once and each output byte written once. In: the S
table ([tiles, QB, 9W] int8; K4^T: S_rev [tiles, 9W, rev_lanes] int8), the
padded bf16 candidates [num_padded, H] and the window starts [tiles, 9]
int32; out: [tiles x QB, H] float32. Operations: 2 x H a nonzero of S,
bf16 on the tensor cores; at most k nonzeros a slot row, the plan's live
rows count N x k at most (the bytes bound them at every plan measured)."""


def count(plan: dict, transpose: bool = False) -> dict:
    tiles, qb, w, h = plan["num_tiles"], plan["query_block"], plan["window"], plan["latent"]
    s = tiles * 9 * w * (plan["rev_lanes"] if transpose else qb)
    nbytes = s + plan["num_padded"] * h * 2 + tiles * 9 * 4 + tiles * qb * h * 4
    return {"bytes": nbytes, "ops": 2 * plan["num_particles"] * plan["num_neighbors"] * h,
            "op_rate": "bf16_tensor"}
