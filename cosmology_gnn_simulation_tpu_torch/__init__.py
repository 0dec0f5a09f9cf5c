"""PyTorch + CUDA port of the learned cosmological particle simulator.

The JAX package ``cosmology_gnn_simulation_tpu`` is the reference; this
package mirrors its module names (``types.py``, ``ops/periodic.py``,
``models/mlp.py``, ...) so every function has a findable counterpart, and
imports nothing from it (nor JAX). Its TPU kernels become hand-written CUDA
kernels for Hopper (``csrc/``), each beside a plain PyTorch version of the
same function that the CPU path and the tests use.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; a missing CUDA device raises instead of falling back.
"""

__version__ = "0.1.0"

from cosmology_gnn_simulation_tpu_torch.types import (
    NormalizationStats,
    ParticleGraph,
    resolve_device,
    tree_map,
)

__all__ = ["NormalizationStats", "ParticleGraph", "resolve_device", "tree_map", "__version__"]
