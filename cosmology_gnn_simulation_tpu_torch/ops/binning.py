"""Sort-and-rank binning (counterpart of ``ops/binning.py``).

Stable-sort integer keys, rank each item within its key group, and scatter
into a fixed-capacity ``[num_keys, capacity]`` table with an overflow count.
The stable sort makes the rank of a particle within its cell the rank of
its index among the cell's particles — the same rank the JAX package gives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Binning(NamedTuple):
    """Result of sorting ``keys`` into fixed-capacity buckets.

    Attributes:
      order:    ``[M]`` stable permutation sorting the items by key.
      rank:     ``[M]`` each sorted item's index within its key group.
      slot:     ``[M]`` flat table slot ``key * capacity + rank`` of each
                sorted item, or the sentinel ``num_keys * capacity`` for an
                item past ``capacity`` (dropped by ``scatter_to_table``).
      overflow: scalar tensor — items beyond ``capacity`` in their group.
      payload:  tuple of ``[M, ...]`` tensors co-sorted with the keys.
    """

    order: torch.Tensor
    rank: torch.Tensor
    slot: torch.Tensor
    overflow: torch.Tensor
    payload: tuple = ()


def run_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """``out[i]`` = first index of the equal-key run containing ``i``."""
    m = sorted_keys.shape[0]
    iota = torch.arange(m, device=sorted_keys.device)
    is_start = torch.ones(m, dtype=torch.bool, device=sorted_keys.device)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return torch.cummax(torch.where(is_start, iota, 0), dim=0).values


def bucket_boundaries(sorted_keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """``b[v]`` = first index ``i`` with ``sorted_keys[i] >= v`` for
    ``v in [0, num_buckets]``, so bucket ``v`` spans ``[b[v], b[v+1])``."""
    values = torch.arange(num_buckets + 1, device=sorted_keys.device,
                          dtype=sorted_keys.dtype)
    return torch.searchsorted(sorted_keys, values)


def bin_by_key(keys: torch.Tensor, num_keys: int, capacity: int, payload=()) -> Binning:
    """Stable-sort ``keys`` and compute per-group ranks + capacity slots."""
    sorted_keys, order = torch.sort(keys, stable=True)
    rank = torch.arange(keys.shape[0], device=keys.device) - run_starts(sorted_keys)
    overflow = (rank >= capacity).sum()
    slot = torch.where(
        rank < capacity, sorted_keys * capacity + rank, num_keys * capacity
    )
    return Binning(
        order=order, rank=rank, slot=slot, overflow=overflow,
        payload=tuple(p[order] for p in payload),
    )


def scatter_to_table(
    binning: Binning,
    sorted_values: torch.Tensor,
    num_keys: int,
    capacity: int,
    fill,
    dtype,
) -> torch.Tensor:
    """Scatter sorted per-item values into the ``[num_keys, capacity]`` table
    (overflow items land in a spare slot that is cut off)."""
    base = torch.full(
        (num_keys * capacity + 1,), fill, dtype=dtype, device=sorted_values.device
    )
    base[binning.slot] = sorted_values.to(dtype)
    return base[:-1].reshape(num_keys, capacity)
