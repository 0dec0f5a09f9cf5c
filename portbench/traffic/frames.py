"""Seeded particle windows: the one generator of every traffic mix.

A window is a uniform base frame (N independent uniform points in the unit
box, so the density has Poisson fluctuations) plus a small random-walk
drift per frame (``drift_sigma`` a frame), wrapped into the box: the seed
frames of the repository's ``bench.py`` and ``chip_smoke.py::seed_window``
and ``train_batch``, copied here. Rollout windows have ``frames`` frames
and temperatures drawn about ``temp_mean`` with spread ``temp_sigma``
(absolute values); training windows have ``frames + 1`` frames, the last
being the target, and temperatures that drift from 1 by ``temp_drift`` a
frame. Every window of a pool has the same size, so a seed changes the
values and never the work.
"""

from __future__ import annotations

import numpy as np


def _positions(n: int, count: int, mix: dict, rng) -> np.ndarray:
    """``[count, N, 3]`` float32 positions: the base frame, then the drift."""
    base = rng.uniform(0, 1, (1, n, 3))
    drift = rng.normal(0, mix["drift_sigma"], (count, n, 3)).cumsum(axis=0)
    return np.remainder(base + drift, 1.0).astype(np.float32)


def rollout_window(n: int, mix: dict, seed: int):
    """``(positions [F, N, 3], temperatures [F, N, 1])`` float32."""
    frames = mix["frames"]
    rng = np.random.default_rng(seed)
    pos = _positions(n, frames, mix, rng)
    temp = np.abs(rng.normal(mix["temp_mean"], mix["temp_sigma"], (frames, n, 1)))
    return pos, temp.astype(np.float32)


def train_window(n: int, mix: dict, seed: int):
    """A batch of one: ``positions [1, F, N, 3]``, ``temperatures [1, F, N,
    1]``, ``target_positions [1, N, 3]``, ``target_temperatures [1, N, 1]``."""
    frames = mix["frames"]
    rng = np.random.default_rng(seed)
    pos = _positions(n, frames + 1, mix, rng)
    temp = (1.0 + rng.normal(0, mix["temp_drift"], (frames + 1, n, 1)).cumsum(axis=0))
    temp = temp.astype(np.float32)
    return {"positions": pos[None, :frames], "temperatures": temp[None, :frames],
            "target_positions": pos[None, frames], "target_temperatures": temp[None, frames]}


def pool_seeds(seed: int, count: int) -> list:
    """``count`` window seeds drawn from the run's seed."""
    return [int(s) for s in np.random.default_rng(seed).integers(0, 2**62, count)]
