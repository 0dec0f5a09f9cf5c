"""What the benchmark takes from the program under test, in one place: the
port's model configuration, statistics and plan shapes for a cell."""

from __future__ import annotations

import torch


def model_config(cfg: dict, mix: dict):
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        default_model_config,
    )
    return default_model_config(
        window_size=cfg["window"], latent_size=cfg["latent_size"],
        mlp_hidden_size=cfg["mlp_hidden_size"],
        mlp_num_hidden_layers=cfg["mlp_num_hidden_layers"],
        num_message_passing_steps=cfg["num_message_passing_steps"],
        output_size=cfg["output_size"], **mix.get("model_options", {}))


def stats(cfg: dict, device):
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats
    return NormalizationStats.from_metadata(cfg["metadata"], device=device)


def plan_shapes(cfg: dict, mix: dict) -> dict:
    """The mix's frozen cell-block plan (``mix["plan"]``) with the shapes the
    kernels' counts need: the model's sizes and the step tail's operand
    element sizes. The counts never read the program's plan; the program's
    spec for the mix's route has to equal the frozen one, or the run stops
    here, since the cell's work would have changed under it."""
    from cosmology_gnn_simulation_tpu_torch.ops.cellblock import choose_cellblock_spec
    frozen = mix["plan"]
    spec = choose_cellblock_spec(cfg["num_particles"], cfg["num_neighbors"],
                                 variable=mix["route"].get("cellblock_variable", False))
    program = {key: getattr(spec, key) for key in frozen}
    if program != frozen:
        raise SystemExit(f"portbench: the program's cell-block plan {program} is not the "
                         f"cell's frozen plan {frozen}; a changed plan is a new cell")
    carry = mix.get("model_options", {}).get("carry_dtype") or "float32"
    return dict(frozen, num_particles=cfg["num_particles"],
                num_neighbors=cfg["num_neighbors"], latent=cfg["latent_size"],
                carry_bytes=torch.finfo(getattr(torch, carry)).bits // 8,
                # The cell-block aggregation hands the tail float32 sums.
                agg_bytes=4)
