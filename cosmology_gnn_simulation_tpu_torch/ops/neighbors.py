"""Exact brute-force periodic k-NN (counterpart of ``ops/neighbors.py``).

Queries are processed in tiles of ``query_tile`` rows against all N
particles under the minimum-image metric. The result is ascending by
distance with the SMALLEST INDEX first among equal distances — JAX's
``lax.top_k`` order — so the self-loop leads each self-query row. It is the
small-N search and the yardstick of the cell-list kernel's exactness.
"""

from __future__ import annotations

import torch

from cosmology_gnn_simulation_tpu_torch.ops.periodic import min_image_displacement


def knn_periodic(
    positions: torch.Tensor,
    k: int,
    box_size,
    *,
    query_tile: int = 512,
    return_distances: bool = False,
):
    """``[N, k]`` int64 indices of the k nearest (periodic) particles of each
    particle (self included); optionally also ``[N, k]`` squared distances.
    Peak temporary memory is ``query_tile * N * 4`` bytes x a few."""
    n = positions.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds particle count {n}")
    idx_tiles, d2_tiles = [], []
    for start in range(0, n, query_tile):
        q = positions[start:start + query_tile]
        delta = min_image_displacement(q[:, None, :] - positions[None, :, :], box_size)
        d2 = (delta * delta).sum(dim=-1)
        # Stable sort: equal distances keep ascending index order.
        d2_sorted, order = torch.sort(d2, dim=1, stable=True)
        idx_tiles.append(order[:, :k])
        d2_tiles.append(d2_sorted[:, :k])
    idx = torch.cat(idx_tiles)
    if return_distances:
        return idx, torch.cat(d2_tiles)
    return idx
