"""Random-walk training noise (counterpart of ``ops/noise.py``).

The reference's denoising-curriculum noise: i.i.d. velocity-space noise of
scale ``noise_std / sqrt(T-1)`` accumulated twice (velocity walk, then
position walk times dt), with zero noise at the first frame. Temperature
noise is the same scheme scaled by ``temp_rate_std``.

Two keyings, as in the JAX package:

* stream (``gids=None``): one block of draws per call from an explicit
  ``torch.Generator`` (the JAX default). The draw a particle receives
  depends on its row.
* per particle (``gids [N]``, the JAX ``partition_invariant_noise``): row
  ``i``'s draws are a pure function of the call's key, ``gids[i]`` and the
  element index, so they do not depend on row order, padding or N (what
  makes single-device and halo-sharded training give the same numbers). A
  ``torch.Generator`` cannot be forked per row, so the key is ONE integer
  draw from the call's generator, and each element's bits come from a
  counter-based hash (``gid_bits``): murmur3's 32-bit finalizer chained
  over (key, gid, 2e) and (key, gid, 2e + 1) for element ``e = t * D + d``
  of the row, in int64 tensor ops that keep every value below 2^63. Integer
  ops give the same bits on the CPU and on the card. Box-Muller turns the
  two 24-bit uniforms of an element into one normal
  (``sqrt(-2 ln u1) cos(2 pi u2)``, ``u1`` in ``(0, 1]``); the card's and
  the CPU's ``log``, ``sqrt`` and ``cos`` may differ in the last bits.

Neither keying reproduces ``jax.random``'s numbers (threefry), so the tests
hand both packages the same draws through ``_iid_normal`` and
``_gid_normal`` (the JAX package's ``_iid_normal`` serves both keyings).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for int64 lanes holding uint32 values, in two
    16-bit halves of ``c`` so no product reaches 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + ((h * hi) & 0xFFFF) * 65536) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer (a bijection with full avalanche)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gid_bits(key: torch.Tensor, gids: torch.Tensor, elements: int) -> torch.Tensor:
    """The counter-based hash bits of the per-particle keying: ``[N,
    elements, 2]`` int64 values below 2^32 for the int64 ``key`` (a 0-d
    or one-element tensor) and ``gids [N]``; entry ``(i, e, c)`` depends
    only on ``key``, ``gids[i]`` and ``2e + c``."""
    dev = gids.device
    stream = _fmix32(_fmix32(key.reshape(()).to(dev) & _MASK32) ^ (gids.long() & _MASK32))
    counter = torch.arange(2 * elements, device=dev, dtype=torch.int64).view(elements, 2)
    return _fmix32(stream[:, None, None] ^ _fmix32(counter))


def gid_normals(key: torch.Tensor, gids: torch.Tensor, shape) -> torch.Tensor:
    """``shape = [N, ...]`` standard normal float32 draws from ``gid_bits``
    by Box-Muller: two 24-bit uniforms an element."""
    n, rest = shape[0], tuple(shape[1:])
    bits = gid_bits(key, gids, math.prod(rest))
    u = (bits >> 8).float() * 2.0**-24
    radius = torch.sqrt(-2.0 * torch.log(1.0 - u[..., 0]))  # 1 - u in (0, 1]
    return (radius * torch.cos((2.0 * math.pi) * u[..., 1])).reshape(n, *rest)


def _iid_normal(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """``shape`` standard normal float32 draws on ``device``, one block from
    ``generator`` (drawn on the generator's device): the stream keying."""
    gen_device = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gen_device).to(device)


def gid_key(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The per-particle keying's integer key of one call: one draw from
    ``generator`` (on its own device)."""
    gen_device = generator.device if generator is not None else device
    return torch.randint(0, 2**32, (1,), generator=generator, device=gen_device)


def _gid_normal(generator: Optional[torch.Generator], shape, device,
                gids: torch.Tensor) -> torch.Tensor:
    """``shape = [N, ...]`` standard normal float32 draws on ``device``
    keyed per particle by ``gids [N]``: one integer key from ``generator``
    (``gid_key``), then ``gid_normals``."""
    return gid_normals(gid_key(generator, device), gids.to(device), shape)


def _double_cumsum_walk(generator, shape, scale, dt, device, gids=None) -> torch.Tensor:
    """Draw iid noise of ``scale``, cumsum twice over time axis 1, scale by
    dt, and prepend a zero frame. ``shape`` is ``[N, T-1, D]``; returns
    ``[N, T, D]``."""
    steps = shape[1]
    iid = (_iid_normal(generator, shape, device) if gids is None
           else _gid_normal(generator, shape, device, gids))
    iid = iid * (scale / math.sqrt(steps))
    walk = torch.cumsum(iid, dim=1)
    accumulated = torch.cumsum(walk, dim=1) * dt
    return torch.cat([torch.zeros_like(accumulated[:, :1]), accumulated], dim=1)


def random_walk_position_noise(position_seq: torch.Tensor, noise_std, dt,
                               generator: Optional[torch.Generator] = None,
                               gids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[N, T, 3]`` position noise, zeros at ``t = 0``; exact zeros, with no
    draw, for ``noise_std == 0``. ``gids [N]``: the per-particle keying."""
    if float(noise_std) == 0.0:
        return torch.zeros_like(position_seq)
    n, t, d = position_seq.shape
    scale = torch.tensor(float(noise_std), dtype=position_seq.dtype,
                         device=position_seq.device)
    return _double_cumsum_walk(generator, (n, t - 1, d), scale, dt, position_seq.device, gids)


def random_walk_temperature_noise(temperature_seq: torch.Tensor, noise_std, temp_rate_std,
                                  dt, generator: Optional[torch.Generator] = None,
                                  gids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[N, T, D]`` temperature noise: the position scheme with the iid
    draws scaled by ``noise_std * temp_rate_std`` (scalar or per feature);
    exact zeros for ``noise_std == 0``. ``gids [N]``: the per-particle
    keying."""
    if float(noise_std) == 0.0:
        return torch.zeros_like(temperature_seq)
    n, t, d = temperature_seq.shape
    scale = float(noise_std) * torch.as_tensor(
        temp_rate_std, dtype=temperature_seq.dtype, device=temperature_seq.device)
    return _double_cumsum_walk(generator, (n, t - 1, d), scale, dt, temperature_seq.device,
                               gids)
