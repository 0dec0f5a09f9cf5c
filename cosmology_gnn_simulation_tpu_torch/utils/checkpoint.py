"""Checkpoints in the port's own format (the counterpart of
``utils/checkpoint.py``, whose Orbax format needs JAX).

A checkpoint is a directory ``<directory>/<name>/`` holding

* ``state.pt`` (``torch.save``; read back with ``weights_only=True``):
  ``params``, the parameter tree (dicts and tuples, the JAX tree's
  structure) as float32 CPU tensors; and, where given, ``optimizer`` and
  ``schedule`` (the ``torch.optim`` optimizer's and LR scheduler's
  ``state_dict``), ``epoch`` and ``generator`` (a ``torch.Generator``'s
  ``get_state()``);
* ``config.json``, the model and train configuration (the JAX Trainer's
  ``{"model": ..., "train": ...}``), where given;
* ``history.json``, written beside them by the Trainer.

The payload holds only tensors, dicts, lists, tuples and plain numbers
(no NamedTuple), so ``weights_only`` loading accepts it. A JAX package
checkpoint (Orbax) comes across through the repository's
``import_jax_checkpoint.py``, run on a host that has JAX: its params,
epoch and config in this format; a directory without ``state.pt`` handed to
``load_state`` raises a ``ValueError`` that says so.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from cosmology_gnn_simulation_tpu_torch.types import resolve_device, tree_map

STATE_FILE = "state.pt"


def save_checkpoint(
    directory: str,
    name: str,
    params: Any,
    opt_state: Any = None,
    *,
    epoch: Optional[int] = None,
    generator_state: Optional[torch.Tensor] = None,
    config: Optional[Dict] = None,
) -> str:
    """Save ``params`` (and the optimizer state ``opt_state``, an
    ``training.trainer.OptState``, the epoch, the generator state and the
    config) under ``directory/name``; returns that path."""
    path = os.path.abspath(os.path.join(directory, name))
    os.makedirs(path, exist_ok=True)
    payload = {"params": tree_map(lambda t: t.detach().float().cpu(), params)}
    if opt_state is not None:
        payload["optimizer"] = opt_state.optimizer.state_dict()
        if opt_state.schedule is not None:
            payload["schedule"] = opt_state.schedule.state_dict()
    if epoch is not None:
        payload["epoch"] = int(epoch)
    if generator_state is not None:
        payload["generator"] = generator_state.cpu()
    torch.save(payload, os.path.join(path, STATE_FILE))
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
    return path


def load_state(path: str) -> Dict:
    """The saved payload of checkpoint ``path`` with every tensor on the CPU
    (``weights_only``), for a full restore."""
    state_file = os.path.join(path, STATE_FILE)
    if os.path.isdir(path) and not os.path.exists(state_file):
        raise ValueError(
            f"{path} holds no {STATE_FILE}: not a checkpoint of the port. A JAX package "
            f"(Orbax) checkpoint is imported on a host with JAX by `python "
            f"import_jax_checkpoint.py {path} <output>` at the repository root, which writes "
            "one that these loaders read")
    return torch.load(state_file, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, device="cuda") -> Dict:
    """Load checkpoint ``path``: its payload with ``params`` on ``device``,
    plus ``config`` (the parsed ``config.json``) where it has one."""
    device = resolve_device(device)
    restored = load_state(path)
    restored["params"] = tree_map(lambda t: t.to(device), restored["params"])
    config_path = os.path.join(path, "config.json")
    if os.path.exists(config_path):
        with open(config_path) as f:
            restored["config"] = json.load(f)
    return restored
