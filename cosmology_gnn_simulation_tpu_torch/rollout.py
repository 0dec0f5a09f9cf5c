"""Rollout engine (counterpart of ``rollout.py``): gather aggregation, or
the cell-block aggregation with the carry on the particle rows (hybrid, the
JAX package's main path) or in slot space (its config-4 path), and the
one-step prediction of each.

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
    resolve_neighbor_method,
)
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
    apply_encode_process_decode,
)
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import cell_sort_order, choose_cell_grid
from cosmology_gnn_simulation_tpu_torch.ops.cellblock import (
    build_cellblock,
    choose_cellblock_spec,
    choose_dense_search_spec,
)
from cosmology_gnn_simulation_tpu_torch.ops.fused_step import resolve_fused_tail
from cosmology_gnn_simulation_tpu_torch.ops.neighbors import knn_periodic
from cosmology_gnn_simulation_tpu_torch.ops.periodic import (
    min_image_displacement,
    wrap_positions,
)
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, resolve_device


def _permute_window(win: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Permute a ``[W, N, D]`` window along N."""
    return win.index_select(1, order)


def _predict_physical(params, graph, model_config, stats, dtype, cellblock_spec=None,
                      cellblock_mode="hybrid"):
    """Forward pass + un-normalization to physical units."""
    preds = apply_encode_process_decode(
        params, graph, model_config, dtype, cellblock_spec=cellblock_spec,
        cellblock_mode=cellblock_mode,
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
    cellblock_search: str = "auto",
    dense_search_spec=None,
    sorted_state: str = "auto",
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
        ``neighbor_exactness [num_steps]``; ``"off"`` skips it;
        ``"fallback"`` also reruns the search by exact brute force at each
        re-neighboring whose certificate fails (gather only), overwriting
        the search's ids in place: on the card K9 reads the certificate
        itself and returns at once where it holds, so no step waits for
        the host. ``neighbor_exactness`` still reports the search's own
        certificate, as in the JAX package.
      aggregation: ``"gather"``, ``"cellblock_hybrid"``: the selection-
        matrix aggregation (a plan each re-neighboring, K4 each
        message-passing step) with the carry on the N particle rows, the
        JAX package's main path, or ``"cellblock"``: the same with the
        carry in slot space (expanded once after the encoder, compacted
        once before the decoders; the JAX package's config-4 path). The
        state then rides in cell-sorted order, re-sorted at each
        re-neighboring; outputs stay in original particle order, and the
        certificate also requires no column overflow and no dropped edge.
        ``"auto"`` resolves to ``"gather"``, as the JAX dispatch does
        off-TPU, until the crossover is measured on the card.
      cellblock_spec: the cell-block spec (default ``choose_cellblock_spec``
        on the k-NN grid, with variable capacities where
        ``cellblock_variable``). On the k-NN grid the plan decodes the
        cell-list kernel's codes (K1', K2); on another grid, or when another
        search served (brute force below 8192 particles with ``"auto"``), it
        is built from neighbor ids (the aux path; K1'' when the kernel
        searches).
      sorted_state: ``"on"`` carries the gather rollout's window in
        cell-sorted order (``ops.cell_list.cell_sort_order``), re-sorted at
        each re-neighboring, with outputs in the original order: the same
        numbers on tie-free data. ``"auto"`` resolves to ``"off"``, as in
        the JAX package. The cell-block path always rides sorted.
      cellblock_search: ``"auto"`` and ``"codes"``: the search round above;
        ``"dense"``: the fused dense-query search K8 inside the plan build
        (uniform cubic specs only), whose certificate also requires no
        search-window truncation and every k-th neighbor within its margin.
        ``dense_search_spec`` overrides ``choose_dense_search_spec``.
      fused_tail: run each message-passing step's tail as the kernel K5;
        ``None`` = on for the pruned model on CUDA where K5 takes the shape
        (``ops.fused_step.kernel_takes``: bf16, latent = hidden = 128 or
        256, one hidden Linear). ``True`` on another shape raises on the
        card.
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
    if sorted_state not in ("auto", "on", "off"):
        raise ValueError(f"unknown sorted_state: {sorted_state}")
    if cellblock_search not in ("auto", "dense", "codes"):
        raise ValueError(f"unknown cellblock_search: {cellblock_search}")
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
    spec = dspec = None
    cellblock_mode = "hybrid" if aggregation == "cellblock_hybrid" else "slots"
    if aggregation.startswith("cellblock"):
        n = pos_window.shape[1]
        spec = cellblock_spec or choose_cellblock_spec(n, num_neighbors,
                                                       variable=cellblock_variable)
        if cellblock_search == "dense":
            if spec.variable or spec.grid_x or not spec.periodic_x:
                raise ValueError("cellblock_search='dense' requires the uniform cubic "
                                 "periodic layout")
            dspec = dense_search_spec or choose_dense_search_spec(n, spec)
    sort_gather = spec is None and sorted_state == "on"
    # Brute force is exact by construction: a fallback behind it reruns
    # nothing.
    fallback = exactness_guard == "fallback" and resolve_neighbor_method(
        pos_window.shape[1], num_neighbors, neighbor_method) != "bruteforce"
    positions, temperatures, exactness = [], [], []
    neighbors = plan = exact = None
    # On the cell-block path (and the gather path with sorted_state="on")
    # the window rides in cell-sorted order, re-sorted at each
    # re-neighboring (the plan and the window order must agree); inv_ids
    # maps each original particle to its current row, so outputs stay in
    # original order. None: the window keeps the original order.
    inv_ids = None
    for step in range(num_steps):
        if step % reneighbor_every == 0:
            # featurize wraps before it searches; the seed window may hold
            # unwrapped coordinates.
            wrapped = wrap_positions(pos_window[-1], box)
            if spec is None:
                if sort_gather:
                    order = cell_sort_order(wrapped, num_neighbors, box)
                    wrapped = wrapped[order]
                    pos_window, temp_window, inv_ids = _resort(pos_window, temp_window,
                                                               inv_ids, order)
                neighbors, exact = neighbor_search_certified(
                    wrapped, num_neighbors, box,
                    method=neighbor_method, query_tile=neighbor_query_tile,
                )
                if fallback:
                    # Overwritten in place by exact brute force where the
                    # certificate fails; read on the device, not here.
                    neighbors = knn_periodic(wrapped, num_neighbors, box,
                                             query_tile=neighbor_query_tile,
                                             skip_if=exact, out=neighbors)
            else:
                plan, exact = _cellblock_plan(wrapped, num_neighbors, box, spec, dspec,
                                              neighbor_method, neighbor_query_tile)
                pos_window, temp_window, inv_ids = _resort(pos_window, temp_window, inv_ids,
                                                           plan.order)
        graph = featurize(pos_window, temp_window, stats, neighbors,
                          build_edges=not pruned)._replace(cellblock=plan)
        acceleration, temp_rate = _predict_physical(
            params, graph, model_config, stats, dtype, cellblock_spec=spec,
            cellblock_mode=cellblock_mode,
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


def _cellblock_plan(wrapped, k, box, spec, dspec, method, tile):
    """One re-neighboring round of the cell-block paths. Returns the plan and the
    step's certificate: exact k-NN (or, on the dense search, no window
    truncation and every k-th neighbor within its margin), no column
    overflow, no dropped edge.

    The dense search (``dspec``) runs inside the plan build. Otherwise the
    k-NN search runs first: on the spec's grid the kernel's codes (K1')
    decode into the plan (K2); on another grid the kernel searches in its
    dual mode (K1'') and its codes are dropped, and the plan is built from
    the ids, as it is whenever another search served."""
    if dspec is not None:
        plan = build_cellblock(wrapped, None, box, spec, dense_search=dspec, num_neighbors=k)
        exact = ((plan.search_window_overflow == 0) & (plan.search_excess <= 0.0)
                 & (plan.overflow == 0) & (plan.dropped_edges == 0))
        return plan, exact
    codes_ok = choose_cell_grid(wrapped.shape[0], k).grid_size == spec.grid_size
    neighbors, codes, codes_cap, spill, exact = neighbor_search_certified(
        wrapped, k, box, method=method, query_tile=tile,
        with_codes=True, codes_only=codes_ok,
    )
    if not codes_ok:
        codes = codes_cap = spill = None
    plan = build_cellblock(wrapped, neighbors, box, spec, neighbor_codes=codes,
                           codes_cap=codes_cap, codes_spill=spill)
    return plan, exact & (plan.overflow == 0) & (plan.dropped_edges == 0)


def _resort(pos_window, temp_window, inv_ids, order):
    """Permute the windows' rows by ``order`` and fold it into ``inv_ids``
    (original particle -> current row; ``None`` = the identity)."""
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(order.shape[0], device=order.device)
    return (_permute_window(pos_window, order), _permute_window(temp_window, order),
            inv_order if inv_ids is None else inv_order[inv_ids])


def one_step_prediction(
    params,
    model_config: EncodeProcessDecodeConfig,
    position_seq,
    temperature_seq,
    stats: NormalizationStats,
    *,
    num_neighbors: int = 16,
    min_image_velocity: bool = False,
    dtype: Optional[torch.dtype] = None,
    neighbor_query_tile: int = 512,
    neighbor_method: str = "auto",
    aggregation: str = "gather",
    cellblock_spec=None,
    cellblock_variable: bool = False,
    fused_tail: Optional[bool] = None,
    device="cuda",
):
    """Predict the next frame from a ``[W, N, 3]`` / ``[W, N, 1]`` window:
    ``(new_position [N, 3], new_temperature [N, 1])`` in the input particle
    order. It is the first frame of a 1-step ``rollout`` of the same window
    with the certificate off, and takes ``rollout``'s options and refusals:
    ``aggregation`` ``"gather"`` (default), ``"cellblock_hybrid"`` or
    ``"cellblock"`` (codes on the k-NN grid, the aux plan from neighbor ids
    on another spec or when another search served), ``cellblock_variable``.
    """
    out = rollout(
        params, model_config, position_seq, temperature_seq, stats, 1,
        num_neighbors=num_neighbors, min_image_velocity=min_image_velocity,
        dtype=dtype, neighbor_query_tile=neighbor_query_tile,
        neighbor_method=neighbor_method, exactness_guard="off",
        aggregation=aggregation, cellblock_spec=cellblock_spec,
        cellblock_variable=cellblock_variable, fused_tail=fused_tail, device=device,
    )
    return out["Coordinates"][-1], out["InternalEnergy"][-1]
