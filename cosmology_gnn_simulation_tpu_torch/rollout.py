"""Rollout engine (counterpart of ``rollout.py``), gather aggregation.

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
from cosmology_gnn_simulation_tpu_torch.ops.periodic import (
    min_image_displacement,
    wrap_positions,
)
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, resolve_device


def _predict_physical(params, graph, model_config, stats, dtype):
    """Forward pass + un-normalization to physical units."""
    preds = apply_encode_process_decode(params, graph, model_config, dtype)
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
      aggregation: ``"gather"``; ``"auto"`` resolves to it, as the JAX
        package's dispatch does on every backend that is not a TPU. The
        cell-block modes are not ported yet.
      fused_tail: run each message-passing step's tail as the kernel K5;
        ``None`` = on for the pruned model with bf16 operands on CUDA.
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
    if exactness_guard == "fallback":
        raise NotImplementedError("exactness_guard='fallback' is not ported yet")
    if aggregation not in ("auto", "gather", "cellblock", "cellblock_hybrid"):
        raise ValueError(f"unknown aggregation: {aggregation}")
    if aggregation.startswith("cellblock"):
        raise NotImplementedError(f"aggregation={aggregation!r} is not ported yet")
    pruned = (
        model_config.aggregate == "sender_latents"
        and model_config.prune_dead_edge_stream
    )
    if fused_tail is None:
        fused_tail = pruned and device.type == "cuda" and dtype == torch.bfloat16
    elif fused_tail and not pruned:
        raise ValueError("fused_tail requires the pruned sender_latents mode")
    model_config = model_config._replace(fused_tail=bool(fused_tail))
    guard = exactness_guard != "off"

    pos_window = torch.as_tensor(initial_positions, device=device).float()
    temp_window = torch.as_tensor(initial_temperatures, device=device).float()
    seed_pos, seed_temp = pos_window, temp_window
    positions, temperatures, exactness = [], [], []
    neighbors = exact = None
    for step in range(num_steps):
        if step % reneighbor_every == 0:
            # featurize wraps before it searches; the seed window may hold
            # unwrapped coordinates.
            wrapped = wrap_positions(pos_window[-1], stats.box_size)
            neighbors, exact = neighbor_search_certified(
                wrapped, num_neighbors, stats.box_size,
                method=neighbor_method, query_tile=neighbor_query_tile,
            )
        graph = featurize(pos_window, temp_window, stats, neighbors,
                          build_edges=not pruned)
        acceleration, temp_rate = _predict_physical(
            params, graph, model_config, stats, dtype
        )
        new_position, new_temperature = integrate_step(
            pos_window[-1], pos_window[-2], temp_window[-1],
            acceleration, temp_rate, stats,
            min_image_velocity=min_image_velocity,
        )
        pos_window = torch.cat([pos_window[1:], new_position[None]])
        temp_window = torch.cat([temp_window[1:], new_temperature[None]])
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
