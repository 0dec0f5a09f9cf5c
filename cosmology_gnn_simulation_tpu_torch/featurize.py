"""Graph featurization (counterpart of ``featurize.py``): noise-then-wrap
positions, minimum-image finite-difference velocities, node features of
normalized velocity + temperature history, the certified k-NN search, the
raw (non-minimum-image) edge features when the model reads them, and the
training targets and sender-sorted edge stream; and the one-frame
exactness check of the cell-list search (``verify_neighbor_exactness``)."""

from __future__ import annotations

from typing import Optional

import torch

from cosmology_gnn_simulation_tpu_torch.ops.aggregation import build_sorted_edges
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import cell_list_knn, choose_cell_grid
from cosmology_gnn_simulation_tpu_torch.ops.neighbors import knn_periodic
from cosmology_gnn_simulation_tpu_torch.ops.noise import (
    random_walk_position_noise,
    random_walk_temperature_noise,
)
from cosmology_gnn_simulation_tpu_torch.ops.pallas_knn import (
    codes_packing_cap,
    pallas_cell_list_knn,
)
from cosmology_gnn_simulation_tpu_torch.ops.periodic import (
    min_image_displacement,
    wrap_positions,
)
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, ParticleGraph


def node_feature_size(window_size: int) -> int:
    """3*(T-1) velocity dims + T temperature dims."""
    return 3 * (window_size - 1) + window_size


# Below this many particles the brute-force search beats the cell list's
# table build (the JAX package's threshold, kept until measured here).
_CELL_LIST_MIN_N = 8192


def resolve_neighbor_method(n: int, k: int, method: str = "auto", *,
                            self_query: bool = True) -> str:
    """The search that serves ``method`` for ``n`` reference particles:
    ``"pallas"`` (the cell-list kernel K1, self-queries only), ``"celllist"``
    (the plain PyTorch cell list) or ``"bruteforce"``. ``"auto"`` picks brute
    force below 8192 particles, else K1 for self-queries and the cell list
    for separate queries (the JAX package picks its XLA cell list off the
    TPU for both); brute force also serves when no grid of >= 3 cells per
    edge exists."""
    if method not in ("auto", "pallas", "celllist", "bruteforce"):
        raise ValueError(f"unknown neighbor method: {method}")
    if method == "auto":
        if n < _CELL_LIST_MIN_N:
            return "bruteforce"
        method = "pallas"
    if method == "pallas" and not self_query:
        method = "celllist"
    if method != "bruteforce" and choose_cell_grid(n, k).grid_size < 3:
        method = "bruteforce"
    return method


def neighbor_search(
    positions: torch.Tensor,
    k: int,
    box_size,
    *,
    queries: Optional[torch.Tensor] = None,
    method: str = "auto",
    query_tile: int = 512,
    with_codes: bool = False,
    codes_only: bool = False,
):
    """k-NN search without its certificate: ``[Q, k]`` int64 indices into
    ``positions`` of the k nearest of each of ``queries`` (default: the
    particles themselves). ``method`` as ``resolve_neighbor_method``:
    separate queries go to the plain cell list (``"auto"`` and
    ``"pallas"``) or to brute force.

    ``with_codes=True`` returns ``(neighbors, codes, codes_cap, spill)``:
    K1's candidate codes for the cell-block plan build where K1 serves (in
    its dual mode, or with ``codes_only`` its codes mode, ``neighbors``
    then ``None``), else the neighbors and three ``None``.
    """
    n = positions.shape[0]
    self_query = queries is None or queries is positions
    method = resolve_neighbor_method(n, k, method, self_query=self_query)
    grid = choose_cell_grid(n, k)
    if method == "pallas":
        if with_codes:
            idx, codes, spill = pallas_cell_list_knn(positions, k, box_size, grid,
                                                     with_codes=True, codes_only=codes_only)
            return idx, codes, codes_packing_cap(n, k, grid), spill
        return pallas_cell_list_knn(positions, k, box_size, grid)
    if method == "celllist":
        idx = cell_list_knn(positions, k, box_size, grid, queries=queries,
                            query_tile=max(query_tile, 4096))
    else:
        idx = knn_periodic(positions, k, box_size, queries=queries, query_tile=query_tile)
    return (idx, None, None, None) if with_codes else idx


def neighbor_search_certified(
    positions: torch.Tensor,
    k: int,
    box_size,
    *,
    method: str = "auto",
    query_tile: int = 512,
    with_codes: bool = False,
    codes_only: bool = False,
):
    """k-NN search plus its exactness certificate.

    Returns ``(neighbors [N, k] int64, exact)`` with ``exact`` a 0-d bool
    tensor on the device: True iff the result is provably the exact k-NN
    set (brute force always; the cell-list searches when no cell or spill
    block overflowed and every k-th neighbor is within its window margin).

    ``method``: ``"pallas"`` is the cell-list kernel K1 (the JAX package's
    name for its fused cell-list kernel); ``"celllist"`` the plain PyTorch
    cell list (``ops.cell_list.cell_list_knn``, the JAX package's XLA
    search); ``"bruteforce"`` the exact search (K9 on the card); ``"auto"``
    picks brute force below 8192 particles, else K1 (the JAX package picks
    its XLA cell list off the TPU). Brute force also serves when no grid of
    >= 3 cells per edge exists (``resolve_neighbor_method``).

    ``with_codes=True`` returns ``(neighbors, codes, codes_cap, spill,
    exact)``: the cell-list kernel's candidate codes, their packing
    capacity and spill tables for the cell-block plan build, or ``None``
    for all three when another search served. The kernel then runs in its
    dual mode K1'' (ids and codes); with ``codes_only`` in its codes mode
    K1', and ``neighbors`` is ``None``.
    """
    n = positions.shape[0]
    method = resolve_neighbor_method(n, k, method)
    grid = choose_cell_grid(n, k)
    if method == "bruteforce":
        idx = knn_periodic(positions, k, box_size, query_tile=query_tile)
        exact = torch.ones((), dtype=torch.bool, device=positions.device)
        return (idx, None, None, None, exact) if with_codes else (idx, exact)
    if method == "celllist":
        idx, (overflow, _, max_excess) = cell_list_knn(
            positions, k, box_size, grid, query_tile=max(query_tile, 4096),
            return_diagnostics=True,
        )
        exact = (overflow == 0) & (max_excess <= 0.0)
        return (idx, None, None, None, exact) if with_codes else (idx, exact)
    if with_codes:
        idx, codes, spill, (overflow, _, max_excess) = pallas_cell_list_knn(
            positions, k, box_size, grid, return_diagnostics=True,
            with_codes=True, codes_only=codes_only,
        )
        exact = (overflow == 0) & (max_excess <= 0.0)
        return idx, codes, codes_packing_cap(n, k, grid), spill, exact
    idx, (overflow, _, max_excess) = pallas_cell_list_knn(
        positions, k, box_size, grid, return_diagnostics=True
    )
    return idx, (overflow == 0) & (max_excess <= 0.0)


def verify_neighbor_exactness(
    positions,
    k: int,
    box_size,
    *,
    method: str = "auto",
    strict: bool = True,
):
    """Exactness check of the cell-list k-NN on one frame.

    The cell-list searches are exact only when (a) no cell overflows its
    capacity and (b) every query's k-th neighbor lies within its 3x3x3
    window's margin (``ops.cell_list.window_margin_sq``). Both hold for
    near-uniform boxes at the default grid; strongly clustered data can
    break them and silently degrade the graphs. Run this once, outside the
    step loop, on representative positions (the Trainer does, on its first
    batch): the plain cell list (``ops.cell_list.cell_list_knn``) runs on
    the positions' device and its diagnostics are read back once.

    Returns a dict of diagnostics; raises ``ValueError`` (``strict``) or
    warns when the certificate fails, naming the remedy.
    """
    import warnings

    positions = torch.as_tensor(positions, dtype=torch.float32)
    n = positions.shape[0]
    if method == "bruteforce" or n < _CELL_LIST_MIN_N:
        return {"method": "bruteforce", "exact": True}
    grid = choose_cell_grid(n, k)
    if grid.grid_size < 3:
        return {"method": "bruteforce", "exact": True}
    _, diagnostics = cell_list_knn(positions, k, box_size, grid, return_diagnostics=True)
    overflow, max_d2, max_excess = torch.stack([d.double() for d in diagnostics]).tolist()
    overflow = int(overflow)
    cell_edge_sq = (float(box_size) / grid.grid_size) ** 2
    exact = overflow == 0 and max_excess <= 0.0
    result = {
        "method": "celllist",
        "grid": grid,
        "overflow": overflow,
        "max_kth_distance_sq": max_d2,
        "max_excess_sq": max_excess,
        "cell_edge_sq": cell_edge_sq,
        "exact": exact,
    }
    if not exact:
        msg = (
            f"Cell-list k-NN exactness certificate FAILED for this particle "
            f"distribution: overflow={overflow} particles dropped from "
            f"candidate tables, max k-th-neighbor distance^2 {max_d2:.3e} "
            f"exceeds its query's window margin^2 by {max_excess:.3e} "
            f"(cell edge^2 {cell_edge_sq:.3e}). Neighbor graphs may be "
            f"approximate. Remedies: choose_cell_grid(capacity_multiplier=...)"
            f" larger / safety smaller, or neighbor_method='bruteforce'."
        )
        if strict:
            raise ValueError(msg)
        warnings.warn(msg)
    return result


def featurize(
    position_seq: torch.Tensor,
    temperature_seq: torch.Tensor,
    stats: NormalizationStats,
    neighbors: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    noise_std=0.0,
    num_neighbors: Optional[int] = None,
    neighbor_method: str = "auto",
    neighbor_query_tile: int = 512,
    target_position: Optional[torch.Tensor] = None,
    target_temperature: Optional[torch.Tensor] = None,
    build_edges: bool = True,
    build_reverse: bool = False,
    with_codes: bool = False,
    codes_only: bool = False,
):
    """Build a ``ParticleGraph`` from a ``[T, N, 3]`` / ``[T, N, 1]``
    time-major window.

    Neighbors: the caller's ``[N, k]`` table of the last frame
    (``neighbor_search_certified``, so it can keep the certificate and reuse
    a table across steps), or, with ``num_neighbors``, a search here on the
    noised, wrapped last frame (the training path, whose noise the caller
    cannot see). ``with_codes`` then returns ``(graph, codes, codes_cap,
    spill)``, the cell-list kernel's codes for the cell-block plan (all None
    when another search served); with ``codes_only`` the kernel makes no
    ids (another search still does).
    ``build_edges=False`` skips the ``[N, k, 4]`` edge features the pruned
    model never reads (``neighbors`` may then be None: the cell-block path).

    Training: ``noise_std`` adds the random-walk noise drawn from
    ``generator``; ``target_position`` / ``target_temperature`` ``[N, 3]`` /
    ``[N, 1]`` attach the normalized targets, shifted by the last noise
    frame; ``build_reverse`` attaches the sender-sorted edge stream
    (``graph.sorted_edges``) for the scatter-free aggregation backward.
    """
    box = stats.box_size
    dt = stats.dt
    pos_seq = position_seq.float().transpose(0, 1)  # [N, T, 3]
    temp_seq = temperature_seq.float().transpose(0, 1)

    position_noise = random_walk_position_noise(pos_seq, noise_std, dt, generator)
    pos_seq = wrap_positions(pos_seq + position_noise, box)
    temperature_noise = random_walk_temperature_noise(
        temp_seq, noise_std, stats.temp_rate_std, dt, generator
    )
    temp_seq = temp_seq + temperature_noise

    recent_position = pos_seq[:, -1]
    velocity_seq = min_image_displacement(pos_seq[:, 1:] - pos_seq[:, :-1], box) / dt
    n = pos_seq.shape[0]
    normal_velocity = (velocity_seq - stats.vel_mean) / stats.vel_std
    normal_temp = (temp_seq - stats.temp_mean) / stats.temp_std
    nodes = torch.cat(
        [normal_velocity.reshape(n, -1), normal_temp.reshape(n, -1)], dim=-1
    )
    codes = codes_cap = spill = None
    if num_neighbors is not None:
        if neighbors is not None:
            raise ValueError("pass neighbors or num_neighbors, not both")
        if codes_only and (build_edges or build_reverse):
            raise ValueError("codes_only returns no neighbor ids: incompatible "
                             "with build_edges/build_reverse")
        found = neighbor_search_certified(
            recent_position, num_neighbors, box, method=neighbor_method,
            query_tile=neighbor_query_tile, with_codes=with_codes, codes_only=codes_only,
        )
        neighbors = found[0]
        if with_codes:
            codes, codes_cap, spill = found[1:4]
    edges = None
    if build_edges:
        # Raw sender - receiver displacement, deliberately NOT minimum-image
        # (the reference's edge features).
        disp = recent_position[neighbors] - recent_position[:, None, :]
        edges = torch.cat([disp, torch.linalg.norm(disp, dim=-1, keepdim=True)], dim=-1)
    sorted_edges = build_sorted_edges(neighbors) if build_reverse else None

    target_acceleration = target_temp_rate = None
    if target_position is not None:
        shifted = target_position.float() + position_noise[:, -1]
        next_velocity = min_image_displacement(shifted - recent_position, box) / dt
        acceleration = (next_velocity - velocity_seq[:, -1]) / dt
        target_acceleration = (acceleration - stats.acc_mean) / stats.acc_std
    if target_temperature is not None:
        shifted_temp = target_temperature.float() + temperature_noise[:, -1]
        temp_rate = (shifted_temp - temp_seq[:, -1]) / dt
        target_temp_rate = (temp_rate - stats.temp_rate_mean) / stats.temp_rate_std
    graph = ParticleGraph(nodes=nodes, neighbors=neighbors, edges=edges,
                          positions=recent_position,
                          target_acceleration=target_acceleration,
                          target_temp_rate=target_temp_rate, sorted_edges=sorted_edges)
    if with_codes:
        return graph, codes, codes_cap, spill
    return graph
