"""Container types (counterpart of the JAX package's ``types.py``).

The k-NN graph is regular — exactly ``k`` incoming edges per node, self-loop
included — so it is a dense ``[N, k]`` index tensor, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """Return ``device`` as a ``torch.device``; raise when CUDA is asked for
    and absent (entry points default to ``"cuda"`` and never fall back to
    the CPU silently)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return device


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over parameter trees of dicts and tuples (the
    JAX pytree layout the port keeps)."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: tree_map(fn, *(t[key] for t in trees)) for key in first}
    if isinstance(first, (tuple, list)):
        return tuple(tree_map(fn, *items) for items in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a parameter tree, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


class ParticleGraph(NamedTuple):
    """A static-shape particle-interaction graph.

    Attributes:
      nodes:     ``[N, F]`` normalized velocity + temperature history.
      neighbors: ``[N, k]`` int64 — ``neighbors[i, j]`` is the j-th nearest
                 neighbor of particle i under the minimum-image metric
                 (self first); edge (sender=neighbors[i, j], receiver=i).
                 None on the cell-block path, which never reads ids.
      edges:     ``[N, k, 4]`` raw (NOT minimum-image) displacement
                 ``pos[sender] - pos[receiver]`` plus its norm, or None when
                 the pruned model does not read them.
      positions: ``[N, 3]`` most recent (wrapped) positions.
      cellblock: optional per-graph cell-block plan
                 (``ops.cellblock.CellBlockGraph``); when set, the rows are
                 cell-sorted and the pruned model aggregates through it.
      target_acceleration: ``[N, 3]`` normalized training target, or None.
      target_temp_rate:    ``[N, 1]`` normalized training target, or None.
      sorted_edges: the sender-sorted edge stream
                 (``ops.aggregation.SortedEdges``) for the scatter-free
                 aggregation backward, or None.
    """

    nodes: torch.Tensor
    neighbors: Optional[torch.Tensor]
    edges: Optional[torch.Tensor]
    positions: torch.Tensor
    cellblock: Optional[tuple] = None
    target_acceleration: Optional[torch.Tensor] = None
    target_temp_rate: Optional[torch.Tensor] = None
    sorted_edges: Optional[tuple] = None


class NormalizationStats(NamedTuple):
    """Normalization statistics (the ``metadata.json`` schema) as float32
    tensors, plus the box edge and timestep as Python floats."""

    temp_mean: torch.Tensor
    temp_std: torch.Tensor
    temp_rate_mean: torch.Tensor
    temp_rate_std: torch.Tensor
    vel_mean: torch.Tensor
    vel_std: torch.Tensor
    acc_mean: torch.Tensor
    acc_std: torch.Tensor
    box_size: float
    dt: float

    @classmethod
    def from_metadata(cls, metadata: dict, device="cuda") -> "NormalizationStats":
        """Build from a parsed ``metadata.json`` dict."""
        device = resolve_device(device)

        def arr(x):
            return torch.as_tensor(
                np.asarray(x, dtype=np.float32), device=device
            )

        box = metadata["box_size"]
        return cls(
            temp_mean=arr(metadata["temp_mean"]),
            temp_std=arr(metadata["temp_std"]),
            temp_rate_mean=arr(metadata["temp_rate_mean"]),
            temp_rate_std=arr(metadata["temp_rate_std"]),
            vel_mean=arr(metadata["vel_mean"]),
            vel_std=arr(metadata["vel_std"]),
            acc_mean=arr(metadata["acc_mean"]),
            acc_std=arr(metadata["acc_std"]),
            box_size=float(box[0] if isinstance(box, (list, tuple)) else box),
            dt=float(metadata["dt"]),
        )

    def to(self, device) -> "NormalizationStats":
        """The same statistics with their tensors on ``device``."""
        return self._replace(**{name: value.to(device) for name, value in self._asdict().items()
                                if isinstance(value, torch.Tensor)})
