"""Periodic-box geometry (counterpart of ``ops/periodic.py``)."""

from __future__ import annotations

import torch


def wrap_positions(positions: torch.Tensor, box_size) -> torch.Tensor:
    """Wrap coordinates into ``[0, box)`` (floored remainder, like
    ``jnp.remainder``)."""
    return torch.remainder(positions, box_size)


def min_image_displacement(displacement: torch.Tensor, box_size) -> torch.Tensor:
    """``d - box * round(d / box)``: the minimum-image equivalent of any
    ``|d| < 1.5 * box`` (round half to even, as ``jnp.round``)."""
    return displacement - box_size * torch.round(displacement / box_size)


def periodic_displacement(a: torch.Tensor, b: torch.Tensor, box_size) -> torch.Tensor:
    """Minimum-image displacement ``a - b`` in a periodic box."""
    return min_image_displacement(a - b, box_size)
