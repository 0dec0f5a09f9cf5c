"""The model's floating-point operations a step, from the configuration's
shapes: 2 x the multiply-adds of every dense layer the pruned model needs
and the k - 1 adds of each aggregated latent, for N particles (never the
padding or slots a program may add). LayerNorm, ReLU and the features are
left out. A train step counts 3 x the forward (forward, and the backward's
two products per layer); recomputation is not counted."""


def forward_flops(cfg: dict) -> int:
    n, k = cfg["num_particles"], cfg["num_neighbors"]
    lat, hid, nh = cfg["latent_size"], cfg["mlp_hidden_size"], cfg["mlp_num_hidden_layers"]

    def mlp_macs(in_dim, out_dim):
        dims = [in_dim] + [hid] * nh + [out_dim]
        return sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))

    per_row = 2 * (mlp_macs(cfg["node_input_size"], lat)
                   + cfg["num_message_passing_steps"] * mlp_macs(2 * lat, lat)
                   + mlp_macs(lat, cfg["output_size"]) + mlp_macs(lat, 1))
    per_row += cfg["num_message_passing_steps"] * (k - 1) * lat
    return n * per_row


def count(cfg: dict, train: bool = False) -> int:
    """FLOPs of one rollout step, or with ``train`` one train step (batch 1)."""
    return forward_flops(cfg) * (3 if train else 1)
