"""Random-walk training noise (counterpart of ``ops/noise.py``), as far as
inference needs it: ``noise_std == 0`` gives exact zeros. The noised
training stream belongs to the training slice of the port."""

from __future__ import annotations

import torch


def _zero_walk(seq: torch.Tensor, noise_std) -> torch.Tensor:
    if float(noise_std) != 0.0:
        raise NotImplementedError(
            "random-walk noise with noise_std != 0 is not ported yet "
            "(it comes with the training slice)"
        )
    return torch.zeros_like(seq)


def random_walk_position_noise(position_seq: torch.Tensor, noise_std, dt) -> torch.Tensor:
    """``[N, T, 3]`` position noise; zeros for ``noise_std == 0``."""
    return _zero_walk(position_seq, noise_std)


def random_walk_temperature_noise(temperature_seq: torch.Tensor, noise_std,
                                  temp_rate_std, dt) -> torch.Tensor:
    """``[N, T, D]`` temperature noise; zeros for ``noise_std == 0``."""
    return _zero_walk(temperature_seq, noise_std)
