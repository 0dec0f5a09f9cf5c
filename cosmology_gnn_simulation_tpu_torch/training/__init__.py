"""Training (counterpart of ``training/``): the loss stack and the train and
eval steps with their optimizer. The epoch-driven ``Trainer``, validation,
checkpoints and the data pipeline are not ported yet."""

from cosmology_gnn_simulation_tpu_torch.training.losses import (
    combined_loss,
    momentum_conservation_loss,
)
from cosmology_gnn_simulation_tpu_torch.training.trainer import (
    Optimizer,
    TrainConfig,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "Optimizer",
    "TrainConfig",
    "combined_loss",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "momentum_conservation_loss",
]
