"""The plan's kernels on one cell-block plan (chip_smoke.py's counts in
shape form). K2 (s_decode): in the codes [N, k] int32, out the S offsets
[slots, k] int16; 30 float32 operations an offset. K3 (s_onehot): in the
offsets, out S [slots, 9W] int8 and its count. K7 (reverse_table): in the
sender packs [num_padded, k + 1] int32 and their sources [num_padded]
int64, out S_rev [tiles, 9W, rev_lanes] int8 and its count."""


def count(plan: dict, kernel: str) -> dict:
    n, k, slots = plan["num_particles"], plan["num_neighbors"], plan["num_slots"]
    s_width, tiles = 9 * plan["window"], plan["num_tiles"]
    if kernel == "s_decode":
        return {"bytes": n * k * 4 + slots * k * 2 + 4, "ops": 30 * slots * k, "op_rate": "f32"}
    if kernel == "s_onehot":
        return {"bytes": slots * k * 2 + slots * s_width + 4, "ops": slots * k,
                "op_rate": "f32"}
    if kernel == "reverse_table":
        pad = plan["num_padded"]
        return {"bytes": pad * (k + 1) * 4 + pad * 8 + tiles * s_width * plan["rev_lanes"] + 4,
                "ops": 0, "op_rate": "f32"}
    raise ValueError(f"no count for kernel {kernel!r}")
