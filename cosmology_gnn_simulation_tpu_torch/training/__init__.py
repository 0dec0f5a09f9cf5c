"""Training (counterpart of ``training/``): the loss stack, the train and
eval steps with their optimizer, the epoch-driven ``Trainer`` and
``validate``; the loss plots are ``training/plots.py``."""

from cosmology_gnn_simulation_tpu_torch.training.losses import (
    combined_loss,
    momentum_conservation_loss,
)
from cosmology_gnn_simulation_tpu_torch.training.trainer import (
    Optimizer,
    TrainConfig,
    Trainer,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from cosmology_gnn_simulation_tpu_torch.training.validation import validate

__all__ = [
    "Optimizer",
    "TrainConfig",
    "Trainer",
    "combined_loss",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "momentum_conservation_loss",
    "validate",
]
