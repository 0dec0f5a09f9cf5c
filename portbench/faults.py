"""Faults planted in the program's timed path, to see the comparison catch
them: each is a context manager that swaps one function of the port for a
broken one while it is open. A rollout cell can have a step that returns
its state unchanged and an answer altered where it is produced (one
particle moved 0.01 of the box); a train cell a step that leaves the
parameters unchanged and a loss altered where it is produced (times 1.5).
One card and batches of one: no exchange between cards, no half batch.

    python3 portbench/control.py --workload <cell> --fault <name> --seeds ...

runs a cell with one of them on the card; ``portbench/tests/`` runs each
at a test's size on the CPU.
"""

from __future__ import annotations

import contextlib
import importlib


def _unchanged_state(original):
    def step(recent_position, previous_position, recent_temperature, *args, **kwargs):
        return recent_position, recent_temperature
    return step


def _moved_particle(original):
    def step(*args, **kwargs):
        position, temperature = original(*args, **kwargs)
        position = position.clone()
        position[0, 0] = (position[0, 0] + 0.01) % 1.0
        return position, temperature
    return step


def _no_update(original):
    def apply(state, grads):
        state.optimizer.zero_grad(set_to_none=True)
    return staticmethod(apply)


def _loss_times(factor):
    def make(original):
        def loss(*args, **kwargs):
            total, components = original(*args, **kwargs)
            return total * factor, components
        return loss
    return make


ROLLOUT = "cosmology_gnn_simulation_tpu_torch.rollout"
TRAINER = "cosmology_gnn_simulation_tpu_torch.training.trainer"
# name: (module, owner within it or None, attribute, maker of the fault)
FAULTS = {
    "rollout_state_unchanged": (ROLLOUT, None, "integrate_step", _unchanged_state),
    "rollout_answer_altered": (ROLLOUT, None, "integrate_step", _moved_particle),
    "train_state_unchanged": (TRAINER, "Optimizer", "apply", _no_update),
    "train_loss_altered": (TRAINER, None, "combined_loss", _loss_times(1.5)),
}


@contextlib.contextmanager
def planted(name: str):
    module, owner, attribute, make = FAULTS[name]
    target = importlib.import_module(module)
    if owner is not None:
        target = getattr(target, owner)
    original = target.__dict__[attribute]
    setattr(target, attribute, make(getattr(target, attribute)))
    try:
        yield
    finally:
        setattr(target, attribute, original)
