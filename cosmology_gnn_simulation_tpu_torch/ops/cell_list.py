"""Cell-list geometry (counterpart of ``ops/cell_list.py``).

Particles are binned into a G^3 periodic grid whose cell edge is at least
the k-th-neighbor radius with margin; a query's candidates are its 27
surrounding cells. The per-query certificate ``window_margin_sq`` says when
that candidate window provably holds the exact k nearest neighbors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


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
    ``jnp.asarray(box, float32)``, before any arithmetic)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


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
