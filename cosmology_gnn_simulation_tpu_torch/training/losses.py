"""Loss stack (counterpart of ``training/losses.py``).

* Acceleration / temperature-rate MSE on normalized predictions.
* Momentum-conservation loss: per graph, the squared norm of the total
  normalized-acceleration impulse ``sum_particles(a * dt)``, averaged over
  the batch, times a weight.
* Combined: ``w_acc * L_acc + w_temp * L_temp + L_momentum`` (default
  weights 1/1/0).
"""

from __future__ import annotations

from typing import Dict

import torch


def momentum_conservation_loss(accelerations: torch.Tensor, dt, momentum_weight) -> torch.Tensor:
    """Per-graph momentum penalty. ``accelerations`` is ``[N, 3]`` (one
    graph) or ``[B, N, 3]`` (a batch; mean over B)."""
    total = torch.sum(accelerations * dt, dim=-2)  # [3] or [B, 3]
    per_graph = torch.sum(total**2, dim=-1)
    return momentum_weight * torch.mean(per_graph)


def combined_loss(
    predictions: Dict[str, torch.Tensor],
    target_acceleration: torch.Tensor,
    target_temp_rate: torch.Tensor,
    dt,
    *,
    acc_weight=1.0,
    temp_rate_weight=1.0,
    momentum_weight=0.0,
):
    """Returns ``(total, components)``: components holds the acceleration and
    temperature-rate MSEs (unweighted) and the momentum term (weighted)."""
    acc_loss = torch.mean((predictions["acceleration"] - target_acceleration) ** 2)
    temp_rate_loss = torch.mean((predictions["temp_rate"] - target_temp_rate) ** 2)
    momentum_loss = momentum_conservation_loss(predictions["acceleration"], dt, momentum_weight)
    total = acc_weight * acc_loss + temp_rate_weight * temp_rate_loss + momentum_loss
    return total, {
        "acceleration": acc_loss,
        "temp_rate": temp_rate_loss,
        "momentum": momentum_loss,
    }
