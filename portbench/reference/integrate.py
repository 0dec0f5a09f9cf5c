"""One simulated step, plain PyTorch: the semi-implicit Euler update.

From a window's last two frames x[-2], x[-1] and the model's physical
acceleration a and temperature rate r: ``v = (x[-1] - x[-2]) / dt``, the
plain difference with no minimum image (the simulator's stated semantics),
``x' = remainder(x[-1] + (v + a dt) dt, box)`` and ``T' = T[-1] + r dt``.
"""

from __future__ import annotations

import torch

from portbench.reference import featurize, knn, model


def next_frame(pos: torch.Tensor, temp: torch.Tensor, params, stats: dict, k: int, low=None):
    """``(position [N, 3], temperature [N, 1], ambiguous [N])`` one step after
    the window ``pos [T, N, 3]``, ``temp [T, N, 1]``; ``ambiguous`` marks
    the particles whose k-th neighbour ties within float32 rounding."""
    box, dt = stats["box_size"], stats["dt"]
    wrapped, _, nodes = featurize.node_features(pos, temp, stats)
    neighbors, ambiguous = knn.knn(wrapped[-1], k, box)
    acc, rate = model.forward(params, nodes, neighbors, low)
    acc = acc * stats["acc_std"] + stats["acc_mean"]
    rate = rate * stats["temp_rate_std"] + stats["temp_rate_mean"]
    velocity = (pos[-1] - pos[-2]) / dt + acc * dt
    return torch.remainder(pos[-1] + velocity * dt, box), temp[-1] + rate * dt, ambiguous
