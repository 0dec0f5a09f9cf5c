"""Rollout engine (counterpart of ``rollout.py``): gather aggregation, or
the hybrid cell-block aggregation of the JAX package's main path.

Each simulated step: (re-)neighbor with the exactness certificate, featurize,
run the model, un-normalize, then the reference's semi-implicit Euler update
and periodic wrap. The step loop is a Python loop with no host round trip:
the certificate flags stay on the device until the end.

Integration semantics (the reference's, as in the JAX package):
``v = (x[-1] - x[-2]) / dt`` WITHOUT minimum image by default
(``min_image_velocity=True`` for the physical form); ``v' = v + a dt``;
``x' = remainder(x + v' dt, box)``; ``T' = T + Tdot dt``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cosmology_gnn_simulation_tpu_torch.featurize import (
    featurize,
    neighbor_search_certified,
)
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
    apply_encode_process_decode,
)
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import choose_cell_grid
from cosmology_gnn_simulation_tpu_torch.ops.cellblock import (
    build_cellblock,
    choose_cellblock_spec,
)
from cosmology_gnn_simulation_tpu_torch.ops.fused_step import resolve_fused_tail
from cosmology_gnn_simulation_tpu_torch.ops.periodic import (
    min_image_displacement,
    wrap_positions,
)
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, resolve_device


def _permute_window(win: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Permute a ``[W, N, D]`` window along N."""
    return win.index_select(1, order)


def _predict_physical(params, graph, model_config, stats, dtype, cellblock_spec=None):
    """Forward pass + un-normalization to physical units."""
    preds = apply_encode_process_decode(
        params, graph, model_config, dtype, cellblock_spec=cellblock_spec,
        cellblock_mode="hybrid",
    )
    acceleration = preds["acceleration"] * stats.acc_std + stats.acc_mean
    temp_rate = preds["temp_rate"] * stats.temp_rate_std + stats.temp_rate_mean
    return acceleration, temp_rate


def integrate_step(
    recent_position: torch.Tensor,
    previous_position: torch.Tensor,
    recent_temperature: torch.Tensor,
    acceleration: torch.Tensor,
    temp_rate: torch.Tensor,
    stats: NormalizationStats,
    *,
    min_image_velocity: bool = False,
):
    """Semi-implicit Euler update."""
    dt = stats.dt
    raw = recent_position - previous_position
    if min_image_velocity:
        raw = min_image_displacement(raw, stats.box_size)
    recent_velocity = raw / dt
    new_velocity = recent_velocity + acceleration * dt
    new_position = wrap_positions(recent_position + new_velocity * dt, stats.box_size)
    new_temperature = recent_temperature + temp_rate * dt
    return new_position, new_temperature


def rollout(
    params,
    model_config: EncodeProcessDecodeConfig,
    initial_positions,
    initial_temperatures,
    stats: NormalizationStats,
    num_steps: int,
    *,
    num_neighbors: int = 16,
    min_image_velocity: bool = False,
    dtype: Optional[torch.dtype] = None,
    neighbor_query_tile: int = 512,
    neighbor_method: str = "auto",
    reneighbor_every: int = 1,
    exactness_guard: str = "flag",
    aggregation: str = "auto",
    cellblock_spec=None,
    cellblock_variable: bool = False,
    fused_tail: Optional[bool] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Roll the learned simulator forward ``num_steps`` steps.

    Args:
      initial_positions: ``[W, N, 3]`` seed window (array or tensor).
      initial_temperatures: ``[W, N, 1]``.
      reneighbor_every: rebuild the k-NN graph every R steps (R=1, the
        reference semantics, re-neighbors every step); reused steps inherit
        the certificate of the search that built their table.
      exactness_guard: ``"flag"`` returns the per-step certificate as
        ``neighbor_exactness [num_steps]``; ``"off"`` skips it.
        ``"fallback"`` (brute-force rerun of failing steps) is not ported
        yet and raises ``NotImplementedError``.
      aggregation: ``"gather"``, or ``"cellblock_hybrid"``: the selection-
        matrix aggregation (K1' codes search, the K2/K3 plan build and K4
        each message-passing step) with the carry on the N particle rows,
        the JAX package's main path. The state then rides in cell-sorted
        order, re-sorted at each re-neighboring; outputs stay in original
        particle order, and the certificate also requires no column
        overflow and no dropped edge. ``"auto"`` resolves to ``"gather"``,
        as the JAX dispatch does off-TPU, until the crossover is measured
        on the card. The slot-space ``"cellblock"`` is not ported.
      cellblock_spec: the cell-block spec (default ``choose_cellblock_spec``
        on the k-NN grid); ``cellblock_variable`` is not ported.
      fused_tail: run each message-passing step's tail as the kernel K5;
        ``None`` = on for the pruned model on CUDA where K5 takes the shape
        (``ops.fused_step.kernel_takes``: bf16, latent = hidden = 128, one
        hidden Linear). ``True`` on another shape raises on the card.
      device: ``"cuda"`` (default; raises without a card) or ``"cpu"``,
        where every kernel is its plain PyTorch version.

    Returns:
      ``{"Coordinates": [W + num_steps, N, 3], "InternalEnergy":
      [W + num_steps, N, 1]}`` (seed window first) plus
      ``"neighbor_exactness"`` when the guard is on.
    """
    device = resolve_device(device)
    if reneighbor_every < 1:
        raise ValueError(f"reneighbor_every must be >= 1, got {reneighbor_every}")
    if exactness_guard not in ("off", "flag", "fallback"):
        raise ValueError(f"unknown exactness_guard: {exactness_guard}")
    if aggregation not in ("auto", "gather", "cellblock", "cellblock_hybrid"):
        raise ValueError(f"unknown aggregation: {aggregation}")
    if aggregation == "auto":
        aggregation = "gather"
    if aggregation.startswith("cellblock"):
        if exactness_guard == "fallback":
            raise ValueError(
                "cellblock aggregation supports exactness_guard 'flag'/'off' "
                "(brute-force fallback neighbors can exceed the one-cell window "
                "the selection matrices cover)"
            )
        if aggregation == "cellblock" or cellblock_variable:
            raise NotImplementedError(
                "the slot-space aggregation='cellblock' and cellblock_variable "
                "are not ported; use aggregation='cellblock_hybrid'"
            )
    if exactness_guard == "fallback":
        raise NotImplementedError("exactness_guard='fallback' is not ported yet")
    pruned = (
        model_config.aggregate == "sender_latents"
        and model_config.prune_dead_edge_stream
    )
    model_config = model_config._replace(
        fused_tail=resolve_fused_tail(fused_tail, model_config, device, dtype))
    guard = exactness_guard != "off"

    pos_window = torch.as_tensor(initial_positions, device=device).float()
    temp_window = torch.as_tensor(initial_temperatures, device=device).float()
    seed_pos, seed_temp = pos_window, temp_window
    box = stats.box_size
    spec = None
    if aggregation == "cellblock_hybrid":
        spec = _cellblock_spec(pos_window.shape[1], num_neighbors, cellblock_spec)
    positions, temperatures, exactness = [], [], []
    neighbors = plan = exact = None
    # On the cell-block path the window rides in cell-sorted order, re-sorted
    # at each re-neighboring (the plan and the window order must agree);
    # inv_ids maps each original particle to its current row, so outputs
    # stay in original order. None: the window keeps the original order.
    inv_ids = None
    for step in range(num_steps):
        if step % reneighbor_every == 0:
            # featurize wraps before it searches; the seed window may hold
            # unwrapped coordinates.
            wrapped = wrap_positions(pos_window[-1], box)
            if spec is None:
                neighbors, exact = neighbor_search_certified(
                    wrapped, num_neighbors, box,
                    method=neighbor_method, query_tile=neighbor_query_tile,
                )
            else:
                plan, exact = _cellblock_plan(wrapped, num_neighbors, box, spec,
                                              neighbor_method, neighbor_query_tile)
                pos_window = _permute_window(pos_window, plan.order)
                temp_window = _permute_window(temp_window, plan.order)
                inv_order = torch.empty_like(plan.order)
                inv_order[plan.order] = torch.arange(plan.order.shape[0], device=device)
                inv_ids = inv_order if inv_ids is None else inv_order[inv_ids]
        graph = featurize(pos_window, temp_window, stats, neighbors,
                          build_edges=not pruned)._replace(cellblock=plan)
        acceleration, temp_rate = _predict_physical(
            params, graph, model_config, stats, dtype, cellblock_spec=spec
        )
        new_position, new_temperature = integrate_step(
            pos_window[-1], pos_window[-2], temp_window[-1],
            acceleration, temp_rate, stats,
            min_image_velocity=min_image_velocity,
        )
        pos_window = torch.cat([pos_window[1:], new_position[None]])
        temp_window = torch.cat([temp_window[1:], new_temperature[None]])
        if inv_ids is not None:
            new_position, new_temperature = new_position[inv_ids], new_temperature[inv_ids]
        positions.append(new_position)
        temperatures.append(new_temperature)
        exactness.append(exact)
    result = {
        "Coordinates": torch.cat([seed_pos, torch.stack(positions)]) if positions else seed_pos,
        "InternalEnergy": torch.cat([seed_temp, torch.stack(temperatures)]) if temperatures else seed_temp,
    }
    if guard:
        result["neighbor_exactness"] = (
            torch.stack(exactness) if exactness
            else torch.zeros(0, dtype=torch.bool, device=device)
        )
    return result


def _cellblock_spec(n: int, k: int, spec):
    """The hybrid path's spec: by default the JAX chooser's on the k-NN
    exactness grid (both certificates demand every neighbor within one cell
    edge). A spec on another grid needs the plan built from neighbor ids."""
    if spec is None:
        spec = choose_cellblock_spec(n, k)
    if choose_cell_grid(n, k).grid_size != spec.grid_size:
        raise NotImplementedError(
            f"cellblock_spec grid {spec.grid_size} differs from the k-NN grid "
            f"{choose_cell_grid(n, k).grid_size}: its plan needs neighbor ids "
            "(the aux path), which is not ported"
        )
    return spec


def _cellblock_plan(wrapped, k, box, spec, method, tile):
    """K1' codes search, then the plan (K2, K3). Returns the plan and the
    step's certificate: exact k-NN, no column overflow, no dropped edge."""
    _, codes, codes_cap, spill, exact = neighbor_search_certified(
        wrapped, k, box, method=method, query_tile=tile,
        with_codes=True, codes_only=True,
    )
    if codes is None:
        raise NotImplementedError(
            "the cell-block plan needs the cell-list kernel's codes; brute "
            "force served this search (fewer than 8192 particles with "
            "neighbor_method='auto', or a grid under 3 cells) and plans "
            "from neighbor ids (the aux path) are not ported"
        )
    plan = build_cellblock(wrapped, None, box, spec, neighbor_codes=codes,
                           codes_cap=codes_cap, codes_spill=spill)
    return plan, exact & (plan.overflow == 0) & (plan.dropped_edges == 0)
