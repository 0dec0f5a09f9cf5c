"""Standalone validation (counterpart of ``training/validation.py``): the
combined and per-component losses averaged over a dataset, with no noise,
no augmentation and no gradients, on the device given (the Trainer's
``evaluate`` runs the same eval step)."""

from __future__ import annotations

from typing import Dict, Tuple

from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
)
from cosmology_gnn_simulation_tpu_torch.training.trainer import (
    TrainConfig,
    make_eval_step,
    mean_metrics,
)
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, resolve_device, tree_map


def validate(
    params,
    dataset,
    model_config: EncodeProcessDecodeConfig,
    stats: NormalizationStats,
    *,
    batch_size: int = 1,
    num_neighbors: int = 16,
    acc_loss_weight: float = 1.0,
    temp_rate_loss_weight: float = 1.0,
    momentum_loss_weight: float = 0.0,
    compute_dtype=None,
    device="cuda",
) -> Tuple[float, Dict[str, float]]:
    """Returns ``(avg_combined_loss, component_losses)`` over
    ``dataset.batches(batch_size, shuffle=False)`` (the remainder dropped,
    as in the JAX package), with ``params`` and ``stats`` moved to
    ``device``."""
    device = resolve_device(device)
    tc = TrainConfig(
        num_neighbors=num_neighbors,
        batch_size=batch_size,
        acc_loss_weight=acc_loss_weight,
        temp_rate_loss_weight=temp_rate_loss_weight,
        momentum_loss_weight=momentum_loss_weight,
        compute_dtype=compute_dtype,
    )
    params = tree_map(lambda t: t.to(device), params)
    eval_step = make_eval_step(model_config, stats.to(device), tc)
    metrics = [eval_step(params, batch) for batch in dataset.batches(batch_size, shuffle=False)]
    if not metrics:
        # The Trainer's contract: an empty validation set is a configuration
        # error, not an infinite loss.
        raise ValueError(
            f"Validation produced zero batches: dataset has "
            f"{len(dataset)} windows, batch_size={batch_size}."
        )
    avg = mean_metrics(metrics)
    return avg["loss"], {
        "acceleration": avg["acceleration"],
        "temp_rate": avg["temp_rate"],
        "momentum": avg["momentum"],
    }
