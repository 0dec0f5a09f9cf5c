"""Exact periodic k-nearest neighbours, plain PyTorch.

Each particle's k nearest particles (itself first, at distance 0) under the
minimum-image metric of a cubic periodic box. Distances are worked out in
float64 from the float32 positions, so the order they give is the exact
one; a search in float32 can order two candidates whose squared distances
lie within its rounding either way, and both orders are exact to float32.
``ambiguous`` marks the particles where that can happen at the k-th place.

The search bins the particles into a grid of cells no narrower than the
k-th neighbour distance needs, takes each query's 27 surrounding cells as
its candidates, and keeps the result only where the k-th distance is below
one cell edge (every point outside the 27 cells is at least that far); the
few queries that fail this are searched again against every particle.
"""

from __future__ import annotations

import math

import torch

# Two squared distances closer than this share of either are treated as a
# tie that float32 arithmetic may order either way (its unit roundoff is
# 6e-8; the differences, squares and sums of a squared distance add a few).
TIE_REL = 1e-6


def _min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


def _select(d2: torch.Tensor, ids: torch.Tensor, k: int):
    """The k + 1 smallest of each row: (ids [Q, k], d2 [Q, k + 1])."""
    take = min(k + 1, d2.shape[1])
    best, where = torch.topk(d2, take, dim=1, largest=False, sorted=True)
    if take == k:
        best = torch.cat([best, torch.full_like(best[:, :1], math.inf)], dim=1)
    return torch.gather(ids, 1, where[:, :k]), best


def _brute(pos64: torch.Tensor, queries: torch.Tensor, k: int, box: float, block: int):
    """k-NN of the rows ``queries`` against every particle."""
    out_ids, out_d2 = [], []
    all_ids = torch.arange(pos64.shape[0], device=pos64.device)
    for start in range(0, queries.shape[0], block):
        q = pos64[queries[start:start + block]]
        d2 = torch.zeros(q.shape[0], pos64.shape[0], dtype=torch.float64, device=pos64.device)
        for a in range(3):
            d2 += _min_image(pos64[None, :, a] - q[:, None, a], box) ** 2
        ids, best = _select(d2, all_ids.expand(q.shape[0], -1), k)
        out_ids.append(ids)
        out_d2.append(best)
    return torch.cat(out_ids), torch.cat(out_d2)


def knn(positions: torch.Tensor, k: int, box: float, *, pairs_per_block: int = 2**27):
    """``(neighbors [N, k] int64, ambiguous [N] bool)`` of ``positions [N,
    3]`` (wrapped into ``[0, box)``)."""
    n, dev = positions.shape[0], positions.device
    pos64 = positions.double()
    # About 2k particles a cell: the k-th neighbour then lies well inside
    # one cell edge for any near-uniform box.
    g = max(1, int((n / (2.0 * k)) ** (1.0 / 3.0)))
    if g < 3:
        ids, best = _brute(pos64, torch.arange(n, device=dev), k, box, 1024)
        return ids, (best[:, k] - best[:, k - 1]) <= TIE_REL * best[:, k]
    edge = box / g
    cell3 = torch.clamp((pos64 / edge).long(), 0, g - 1)
    cell = (cell3[:, 0] * g + cell3[:, 1]) * g + cell3[:, 2]
    order = torch.argsort(cell, stable=True)
    counts = torch.bincount(cell, minlength=g**3)
    cap = int(counts.max())
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[cell[order]]
    table = torch.full((g**3, cap), -1, dtype=torch.long, device=dev)
    table[cell[order], rank] = order
    shifts = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)],
                          device=dev)
    ids = torch.empty(n, k, dtype=torch.long, device=dev)
    best_all = torch.empty(n, k + 1, dtype=torch.float64, device=dev)
    cells_per_block = max(1, pairs_per_block // (cap * 27 * cap))
    all_cells = torch.arange(g**3, device=dev)
    for start in range(0, g**3, cells_per_block):
        cells = all_cells[start:start + cells_per_block]
        c3 = torch.stack([cells // (g * g), (cells // g) % g, cells % g], dim=1)
        around = torch.remainder(c3[:, None, :] + shifts[None], g)
        around = (around[..., 0] * g + around[..., 1]) * g + around[..., 2]
        cand = table[around].reshape(cells.shape[0], 27 * cap)        # [B, 27 cap]
        query = table[cells]                                             # [B, cap]
        cpos = pos64[cand.clamp(min=0)]
        qpos = pos64[query.clamp(min=0)]
        d2 = torch.zeros(cells.shape[0], cap, 27 * cap, dtype=torch.float64, device=dev)
        for a in range(3):
            d2 += _min_image(cpos[:, None, :, a] - qpos[:, :, None, a], box) ** 2
        d2.masked_fill_((cand < 0)[:, None, :], math.inf)
        live = query >= 0
        sel, best = _select(d2[live], cand[:, None, :].expand(-1, cap, -1)[live], k)
        ids[query[live]] = sel
        best_all[query[live]] = best
    # Every point outside a query's 27 cells is at least one edge away.
    redo = torch.nonzero(~(best_all[:, k - 1] < edge * edge * (1.0 - 1e-9))).flatten()
    if redo.numel():
        ids[redo], best_all[redo] = _brute(pos64, redo, k, box, 1024)
    ambiguous = (best_all[:, k] - best_all[:, k - 1]) <= TIE_REL * best_all[:, k]
    return ids, ambiguous
