"""Graph featurization (counterpart of ``featurize.py``): noise-then-wrap
positions, minimum-image finite-difference velocities, node features of
normalized velocity + temperature history, the certified k-NN search, and
the raw (non-minimum-image) edge features when the model reads them."""

from __future__ import annotations

import torch

from cosmology_gnn_simulation_tpu_torch.ops.cell_list import choose_cell_grid
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
    set (brute force always; the cell-list kernel when no spill-block
    exhaustion and every k-th neighbor within its window margin).

    ``method``: ``"pallas"`` is the cell-list kernel K1 (the JAX package's
    name for its fused cell-list kernel); ``"bruteforce"`` the exact tiled
    search; ``"auto"`` picks brute force below 8192 particles, else K1.
    Brute force also serves when no grid of >= 3 cells per edge exists.

    ``with_codes=True`` returns ``(neighbors, codes, codes_cap, spill,
    exact)``: the cell-list kernel's candidate codes, their packing
    capacity and spill tables for the cell-block plan build, or ``None``
    for all three when brute force served. With ``codes_only`` the kernel
    runs in its codes mode K1' and ``neighbors`` is ``None``.
    """
    if method not in ("auto", "pallas", "bruteforce"):
        raise ValueError(f"unknown neighbor method: {method}")
    n = positions.shape[0]
    if method == "auto":
        method = "bruteforce" if n < _CELL_LIST_MIN_N else "pallas"
    grid = choose_cell_grid(n, k)
    if method == "bruteforce" or grid.grid_size < 3:
        idx = knn_periodic(positions, k, box_size, query_tile=query_tile)
        exact = torch.ones((), dtype=torch.bool, device=positions.device)
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


def featurize(
    position_seq: torch.Tensor,
    temperature_seq: torch.Tensor,
    stats: NormalizationStats,
    neighbors: torch.Tensor,
    *,
    noise_std=0.0,
    build_edges: bool = True,
) -> ParticleGraph:
    """Build a ``ParticleGraph`` from a ``[T, N, 3]`` / ``[T, N, 1]``
    time-major window and the ``[N, k]`` neighbors of its last frame
    (``neighbor_search_certified``; the caller searches, so it can keep the
    certificate and reuse a table across steps). ``build_edges=False``
    skips the ``[N, k, 4]`` edge features that the pruned model never
    reads; ``neighbors`` may then be ``None`` (the cell-block path)."""
    box = stats.box_size
    dt = stats.dt
    pos_seq = position_seq.float().transpose(0, 1)  # [N, T, 3]
    temp_seq = temperature_seq.float().transpose(0, 1)

    pos_seq = wrap_positions(
        pos_seq + random_walk_position_noise(pos_seq, noise_std, dt), box
    )
    temp_seq = temp_seq + random_walk_temperature_noise(
        temp_seq, noise_std, stats.temp_rate_std, dt
    )

    recent_position = pos_seq[:, -1]
    velocity_seq = min_image_displacement(pos_seq[:, 1:] - pos_seq[:, :-1], box) / dt
    n = pos_seq.shape[0]
    normal_velocity = (velocity_seq - stats.vel_mean) / stats.vel_std
    normal_temp = (temp_seq - stats.temp_mean) / stats.temp_std
    nodes = torch.cat(
        [normal_velocity.reshape(n, -1), normal_temp.reshape(n, -1)], dim=-1
    )
    edges = None
    if build_edges:
        # Raw sender - receiver displacement, deliberately NOT minimum-image
        # (the reference's edge features).
        disp = recent_position[neighbors] - recent_position[:, None, :]
        edges = torch.cat([disp, torch.linalg.norm(disp, dim=-1, keepdim=True)], dim=-1)
    return ParticleGraph(nodes=nodes, neighbors=neighbors, edges=edges,
                         positions=recent_position)
