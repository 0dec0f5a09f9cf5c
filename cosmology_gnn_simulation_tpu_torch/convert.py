"""Carry JAX parameters across to the port, and back.

The JAX param pytree is nested dicts and tuples of arrays; the port uses the
same tree of tensors, in the same ``w: [in, out]`` layout, with the
processor's per-step params stacked on a leading ``[M]`` axis as in
``init_encode_process_decode`` of the JAX package. The converter takes the
tree with its leaves already as numpy arrays (``jax.tree.map(np.asarray,
params)``), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch.types import resolve_device, tree_map


def params_from_jax(tree, device="cuda"):
    """Nested dicts/tuples/lists of numpy arrays -> the same tree of float32
    tensors on ``device`` (lists become tuples, as the JAX ``layers``)."""
    device = resolve_device(device)

    def convert(leaf):
        arr = np.asarray(leaf)
        if arr.dtype.kind != "f":
            raise TypeError(f"expected a float parameter array, got {arr.dtype}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)

    return tree_map(convert, tree)


def params_to_numpy(tree):
    """The inverse of ``params_from_jax``: the same tree with each tensor as
    a float32 numpy array on the host (tuples stay tuples)."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)
