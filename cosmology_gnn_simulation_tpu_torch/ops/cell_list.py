"""Cell-list geometry (counterpart of ``ops/cell_list.py``).

Particles are binned into a G^3 periodic grid whose cell edge is at least
the k-th-neighbor radius with margin; a query's candidates are its 27
surrounding cells. The per-query certificate ``window_margin_sq`` says when
that candidate window provably holds the exact k nearest neighbors.
``cell_list_knn`` is the search on that grid in plain PyTorch (the JAX
package's XLA cell list, no kernel).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch.ops.binning import bin_by_key, scatter_to_table
from cosmology_gnn_simulation_tpu_torch.ops.periodic import min_image_displacement


# The 27 neighbor-cell offsets of a cell's 3x3x3 window, dx slowest (the
# candidate lane order of the cell-list searches and of the k-NN codes).
NEIGHBOR_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                    for dz in (-1, 0, 1)]


class CellGrid(NamedTuple):
    """Static cell-list configuration."""

    grid_size: int  # G: cells per box edge
    cell_capacity: int  # C: max particles tabulated per cell


def poisson_occupancy_capacity(
    mean_occupancy: float, num_cells: int, frame_failure_prob: float = 1e-4
) -> int:
    """Smallest capacity ``c`` with ``P(any of num_cells Poisson(lam) cells
    exceeds c) <= frame_failure_prob``."""
    lam = float(mean_occupancy)
    tail_target = frame_failure_prob / max(num_cells, 1)
    pmf = math.exp(-lam)
    survivor = 1.0 - pmf
    c = 0
    while survivor > tail_target and c < 100_000:
        c += 1
        pmf *= lam / c
        survivor -= pmf
        survivor = max(survivor, 0.0)  # guard accumulated rounding
    return c


def choose_cell_grid(
    num_particles: int,
    k: int,
    *,
    safety: Optional[float] = None,
    capacity_multiplier: Optional[float] = None,
) -> CellGrid:
    """Pick (G, C) for a roughly uniform distribution of ``num_particles`` in
    a unit-scaled box: cell edge = ``safety`` x the uniform k-th-neighbor
    radius, ``safety = max(1.35, ((k + 3 sqrt(k) + ln N) / k)^(1/3))``, and
    capacity the Poisson upper quantile of the occupancy (or
    ``capacity_multiplier`` x the mean)."""
    if safety is None:
        tail = (k + 3.0 * math.sqrt(k) + math.log(num_particles)) / k
        safety = max(1.35, tail ** (1.0 / 3.0))
    r_k = (3.0 * k / (4.0 * math.pi * num_particles)) ** (1.0 / 3.0)
    grid_size = max(3, int(1.0 / (safety * r_k)))
    mean_occupancy = num_particles / grid_size**3
    if capacity_multiplier is None:
        capacity = poisson_occupancy_capacity(mean_occupancy, grid_size**3)
    else:
        capacity = int(math.ceil(capacity_multiplier * mean_occupancy))
    return CellGrid(grid_size=grid_size, cell_capacity=max(k, capacity))


def f32(value, device) -> torch.Tensor:
    """A float32 scalar tensor (box sizes are rounded to f32 once, as
    ``jnp.asarray(box, float32)``, before any arithmetic). Filled on the
    device, so a CUDA scalar costs no host-to-device copy (which would wait
    for the stream and could not be captured in a CUDA graph)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def host_f32(box) -> float:
    """The box size rounded to float32 on the host, once (``np.float32``
    rounds to nearest, as ``f32`` does): a Python float with the bits of
    ``f32(box)``, for a kernel launch. A CPU tensor is read; a tensor on
    the card is refused, since reading it back would wait for the device."""
    if isinstance(box, torch.Tensor):
        if box.device.type != "cpu":
            raise ValueError("a kernel launch takes the box size as a host number, not a "
                             f"tensor on {box.device} (reading it back syncs the device)")
        box = box.item()
    return float(np.float32(box))


def neighbor_offsets(device) -> torch.Tensor:
    """``NEIGHBOR_OFFSETS`` as an int64 ``[27, 3]`` tensor, made on the
    device (no host-to-device copy)."""
    j = torch.arange(27, device=device)
    return torch.stack([j // 9 - 1, (j // 3) % 3 - 1, j % 3 - 1], dim=1)


def cell_coords(positions: torch.Tensor, g: int, box: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` int64 cell coordinates ``clip(floor(p * (g / box)))``."""
    inv_cell = f32(g, positions.device) / box
    return torch.clamp(torch.floor(positions * inv_cell).long(), 0, g - 1)


def window_margin_sq(queries: torch.Tensor, box: torch.Tensor, grid: CellGrid) -> torch.Tensor:
    """Per-query squared exactness radius of the 3x3x3 candidate window:
    ``m(q) = edge + min_d min(frac_d, edge - frac_d)`` (``frac_d`` = offset
    into its cell); ``d_k(q)^2 <= m(q)^2`` certifies query ``q``."""
    g = grid.grid_size
    edge = box / g
    c = cell_coords(queries, g, box)
    frac = queries - c.float() * edge
    m = edge + torch.minimum(frac, edge - frac).min(dim=-1).values
    return m * m



def cell_sort_order(positions: torch.Tensor, k: int, box_size) -> torch.Tensor:
    """Stable cell-sort permutation of ``positions`` on the exactness grid
    (``choose_cell_grid(N, k)``): int64 ``[N]``, particles ordered by cell
    id ``(cx * G + cy) * G + cz``, ties in index order. The identity when no
    grid of >= 3 cells per edge exists. The ``sorted_state`` rollout carries
    its state in this order."""
    n = positions.shape[0]
    g = choose_cell_grid(n, k).grid_size
    if g < 3:
        return torch.arange(n, device=positions.device)
    c = cell_coords(positions.float(), g, f32(box_size, positions.device))
    cell_id = (c[:, 0] * g + c[:, 1]) * g + c[:, 2]
    return torch.sort(cell_id, stable=True)[1]


def cell_list_knn(
    positions: torch.Tensor,
    k: int,
    box_size,
    grid: CellGrid,
    *,
    queries: Optional[torch.Tensor] = None,
    query_tile: int = 8192,
    return_diagnostics: bool = False,
    valid: Optional[torch.Tensor] = None,
):
    """Periodic k-NN through the cell list (the JAX package's XLA
    ``cell_list_knn``): per query, the ``[27 * C]`` candidate ids of its
    3x3x3 cells (``C = grid.cell_capacity``; particles past it are dropped
    and counted), min-image ``d^2 = (dx^2 + dy^2) + dz^2``, and the k
    smallest by a stable sort (the smallest lane wins exact ties, as
    ``lax.top_k``). A row with fewer than k candidates repeats its nearest
    pick for the missing ones, and a row with none gets 0 (such rows keep
    ``+inf`` distances, so ``max_d2`` and the certificate fail).

    ``queries`` ``[Q, 3]`` are searched against the reference set
    ``positions`` ``[N, 3]`` (default: the particles themselves). ``valid``
    ``[N]`` bool drops the False rows from the candidates entirely (a halo
    shard's padding rows): they bin under the sentinel key ``G^3`` and are
    not counted as overflow. Returns ``[Q, k]`` int64 indices into
    ``positions`` (ascending distance), plus ``(overflow, max_d2,
    max_excess)`` over the queries if requested: exact iff ``overflow ==
    0`` and ``max_excess <= 0`` (``window_margin_sq``). ``query_tile``
    queries are searched at a time.
    """
    g, cap = grid.grid_size, grid.cell_capacity
    if g < 3:
        raise ValueError("grid_size must be >= 3 (use brute force below that)")
    n = positions.shape[0]
    dev = positions.device
    box = f32(box_size, dev)
    positions = positions.float()
    queries = positions if queries is None else queries.float()
    coords = cell_coords(positions, g, box)
    cell_id = (coords[:, 0] * g + coords[:, 1]) * g + coords[:, 2]
    if valid is None:
        b = bin_by_key(cell_id, g**3, cap)
        overflow = b.overflow
    else:
        # Invalid rows share the sentinel key G^3, one bucket past the
        # table; the ones beyond its capacity are not real overflow.
        b = bin_by_key(torch.where(valid.to(dev), cell_id, g**3), g**3 + 1, cap)
        overflow = b.overflow - torch.clamp((~valid.to(dev)).sum() - cap, min=0)
    table = scatter_to_table(b, b.order, g**3 + (valid is not None), cap, n, torch.int64)
    planes = [torch.cat([positions[:, d], positions.new_zeros(1)]) for d in range(3)]
    offsets = neighbor_offsets(dev)
    idx_tiles, d2_tiles = [], []
    for start in range(0, queries.shape[0], query_tile):
        q = queries[start:start + query_tile]
        ncells = torch.remainder(cell_coords(q, g, box)[:, None, :] + offsets, g)
        ncell_id = (ncells[..., 0] * g + ncells[..., 1]) * g + ncells[..., 2]
        cand = table[ncell_id].reshape(q.shape[0], -1)
        d2 = None
        for d in range(3):
            delta = min_image_displacement(q[:, d:d + 1] - planes[d][cand], box)
            d2 = delta * delta if d2 is None else d2 + delta * delta
        d2 = torch.where(cand == n, torch.inf, d2)
        d2_sorted, pick = torch.sort(d2, dim=1, stable=True)
        picked = torch.gather(cand, 1, pick[:, :k])
        picked = torch.where(picked == n, picked[:, :1], picked)
        picked = torch.where(picked == n, 0, picked)
        idx_tiles.append(picked)
        d2_tiles.append(d2_sorted[:, :k])
    idx = torch.cat(idx_tiles)
    if not return_diagnostics:
        return idx
    d2 = torch.cat(d2_tiles)
    excess = d2.max(dim=1).values - window_margin_sq(queries, box, grid)
    return idx, (overflow, d2.max(), excess.max())
