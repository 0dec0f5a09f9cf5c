"""Random-walk training noise (counterpart of ``ops/noise.py``).

The reference's denoising-curriculum noise: i.i.d. velocity-space noise of
scale ``noise_std / sqrt(T-1)`` accumulated twice (velocity walk, then
position walk times dt), with zero noise at the first frame. Temperature
noise is the same scheme scaled by ``temp_rate_std``.

The draws come from an explicit ``torch.Generator``, one block per call
(the JAX package's default "stream" keying). A ``torch.Generator`` does not
give ``jax.random``'s numbers, so the tests hand both packages the same
draws through ``_iid_normal``. The per-particle keying by global id
(``gids``, the JAX ``partition_invariant_noise``) is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _iid_normal(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """``shape`` standard normal float32 draws on ``device``, from
    ``generator`` (drawn on the generator's device)."""
    gen_device = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gen_device).to(device)


def _double_cumsum_walk(generator, shape, scale, dt, device) -> torch.Tensor:
    """Draw iid noise of ``scale``, cumsum twice over time axis 1, scale by
    dt, and prepend a zero frame. ``shape`` is ``[N, T-1, D]``; returns
    ``[N, T, D]``."""
    steps = shape[1]
    iid = _iid_normal(generator, shape, device) * (scale / math.sqrt(steps))
    walk = torch.cumsum(iid, dim=1)
    accumulated = torch.cumsum(walk, dim=1) * dt
    return torch.cat([torch.zeros_like(accumulated[:, :1]), accumulated], dim=1)


def random_walk_position_noise(position_seq: torch.Tensor, noise_std, dt,
                               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[N, T, 3]`` position noise, zeros at ``t = 0``; exact zeros, with no
    draw, for ``noise_std == 0``."""
    if float(noise_std) == 0.0:
        return torch.zeros_like(position_seq)
    n, t, d = position_seq.shape
    scale = torch.tensor(float(noise_std), dtype=position_seq.dtype,
                         device=position_seq.device)
    return _double_cumsum_walk(generator, (n, t - 1, d), scale, dt, position_seq.device)


def random_walk_temperature_noise(temperature_seq: torch.Tensor, noise_std, temp_rate_std,
                                  dt, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[N, T, D]`` temperature noise: the position scheme with the iid
    draws scaled by ``noise_std * temp_rate_std`` (scalar or per feature);
    exact zeros for ``noise_std == 0``."""
    if float(noise_std) == 0.0:
        return torch.zeros_like(temperature_seq)
    n, t, d = temperature_seq.shape
    scale = float(noise_std) * torch.as_tensor(
        temp_rate_std, dtype=temperature_seq.dtype, device=temperature_seq.device)
    return _double_cumsum_walk(generator, (n, t - 1, d), scale, dt, temperature_seq.device)
