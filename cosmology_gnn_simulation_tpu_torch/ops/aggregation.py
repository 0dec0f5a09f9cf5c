"""Neighbor gather/aggregation ops with deterministic, scatter-free
backward passes (counterpart of ``ops/aggregation.py``).

``aggregate_sender_latents``: ``agg[i] = sum_j z[neighbors[i, j]]`` over a
regular ``[N, k]`` neighbor table. Autograd's own transpose of this row
gather scatter-adds into ``dz`` with atomics, whose order changes from run
to run. Here, as in the JAX package, the edge stream is sorted by SENDER
once per graph (``build_sorted_edges``), and the backward is a segment sum
over the sorted runs: gather the cotangent rows in sorted-edge order and
read each sender's sum as a difference of two float32 prefix sums at its
run's boundaries. The prefix sum is two-level (within chunks of 128 edges,
then over the chunk totals), which bounds its rounding as the JAX
package's chunked form does. Plain PyTorch: in the JAX package this is
XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cosmology_gnn_simulation_tpu_torch.ops.binning import bucket_boundaries


class SortedEdges(NamedTuple):
    """Edge stream of a regular ``[N, k]`` neighbor table, sorted by sender.
    Edge ``e = i * k + j`` is (receiver i, sender ``neighbors[i, j]``).

    Attributes:
      order:      ``[N*k]`` int64 — flat edge indices in ascending-sender
                  order (stable: ties keep flat order).
      receivers:  ``[N*k]`` int64 — receiver of each sorted edge.
      boundaries: ``[N+1]`` int64 — ``boundaries[p]:boundaries[p+1]`` is the
                  run of sorted edges whose sender is particle ``p``.
    """

    order: torch.Tensor
    receivers: torch.Tensor
    boundaries: torch.Tensor


def build_sorted_edges(neighbors: torch.Tensor) -> SortedEdges:
    """Sort the edge stream by sender (stable)."""
    n, k = neighbors.shape
    sorted_senders, order = torch.sort(neighbors.reshape(-1), stable=True)
    return SortedEdges(order=order, receivers=order // k,
                       boundaries=bucket_boundaries(sorted_senders, n))


# Above this many bytes for the gathered [N, k, H] rows (counted at 4 B an
# element, as in the JAX package), the gather-sum runs over row chunks.
_GATHER_CHUNK_BYTES = 1 << 28

# Edges per chunk of the two-level prefix sum (the JAX package's chunk).
_PREFIX_CHUNK = 128


def gather_sum(values: torch.Tensor, neighbors: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_j values[neighbors[i, j]]``, summed in f32 and returned
    in ``values.dtype``; chunked so the gathered rows stay under ~256 MB."""
    n, k = neighbors.shape
    h = values.shape[-1]
    rows = max(1, _GATHER_CHUNK_BYTES // (k * h * 4))
    out = torch.empty((n, h), dtype=values.dtype, device=values.device)
    for start in range(0, n, rows):
        nb = neighbors[start:start + rows]
        gathered = values.index_select(0, nb.reshape(-1)).view(nb.shape[0], k, h)
        out[start:start + rows] = gathered.sum(dim=1, dtype=torch.float32)
    return out


def segment_sum_sorted(rows: torch.Tensor, boundaries: torch.Tensor, out_dtype) -> torch.Tensor:
    """``out[p] = sum(rows[boundaries[p]:boundaries[p+1]])`` for an already
    sorted ``[E, H]`` row stream, as float32 prefix-sum differences (no
    scatter), returned in ``out_dtype``."""
    e, h = rows.shape
    rows = rows.float()
    pad = (-e) % _PREFIX_CHUNK
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, h))])
    tiles = rows.view(-1, _PREFIX_CHUNK, h)
    intra = torch.cumsum(tiles, dim=1)  # inclusive, within each chunk
    totals = intra[:, -1]
    inter = torch.cumsum(totals, dim=0) - totals  # exclusive chunk offsets
    intra_flat = intra.view(-1, h)

    def prefix_at(b):  # sum(rows[:b]); 0 at b = 0
        idx = torch.clamp(b - 1, min=0)
        val = inter[idx // _PREFIX_CHUNK] + intra_flat[idx]
        return torch.where((b > 0)[:, None], val, 0.0)

    return (prefix_at(boundaries[1:]) - prefix_at(boundaries[:-1])).to(out_dtype)


class _AggregateSenderLatents(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, neighbors, receivers, boundaries):
        ctx.save_for_backward(receivers, boundaries)
        return gather_sum(z, neighbors)

    @staticmethod
    def backward(ctx, g):
        receivers, boundaries = ctx.saved_tensors
        dz = segment_sum_sorted(g.index_select(0, receivers), boundaries, g.dtype)
        return dz, None, None, None


def aggregate_sender_latents(z: torch.Tensor, neighbors: torch.Tensor,
                             sorted_edges: SortedEdges) -> torch.Tensor:
    """``sum_j z[neighbors[i, j]]`` with the sorted-edge segment-sum backward."""
    return _AggregateSenderLatents.apply(z, neighbors, sorted_edges.receivers,
                                         sorted_edges.boundaries)

