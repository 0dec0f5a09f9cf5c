"""Synthetic SPH-like trajectory generator (counterpart of
``data/synthetic.py``, numpy only; the same numbers for a given seed).

Physically plausible periodic-box particle trajectories with smooth
accelerations and temperature evolution, in the HDF5 schema of
``data/hdf5.py``.

The dynamics are a cheap stand-in (damped interactions with a few attractor
modes + curl noise), not real SPH — what matters for the framework is the
schema, the statistics (nonzero means/stds), and periodic boundary crossings.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def generate_synthetic_simulation(
    num_snapshots: int = 20,
    num_particles: int = 256,
    box_size: float = 1.0,
    dt: float = 0.05,
    seed: int = 0,
    velocity_scale: float = 0.05,
) -> Dict[str, np.ndarray]:
    """Generate one simulation in the HDF5 schema.

    Returns dict with ``Coordinates [T,N,3]``, ``Velocities [T,N,3]``,
    ``InternalEnergy [T,N,1]``, ``HydroAcceleration [T,N,3]``, ``BoxSize``,
    ``TimeStep``. Velocities/accelerations are consistent with the coordinate
    finite differences up to the smooth forcing used.
    """
    rng = np.random.default_rng(seed)
    n, t = num_particles, num_snapshots

    positions = np.empty((t, n, 3), dtype=np.float64)
    velocities = np.empty((t, n, 3), dtype=np.float64)
    accelerations = np.empty((t, n, 3), dtype=np.float64)
    energy = np.empty((t, n, 1), dtype=np.float64)

    pos = rng.uniform(0, box_size, size=(n, 3))
    vel = rng.normal(0, velocity_scale * box_size, size=(n, 3))
    temp = np.abs(rng.normal(1.0, 0.3, size=(n, 1)))

    # A few fixed attractor points exert smooth periodic forces.
    attractors = rng.uniform(0, box_size, size=(4, 3))
    phases = rng.uniform(0, 2 * np.pi, size=(4,))

    for step in range(t):
        # Smooth force toward attractors (minimum-image), time-modulated.
        acc = np.zeros((n, 3))
        for a_i, (a_pos, phase) in enumerate(zip(attractors, phases)):
            delta = a_pos - pos
            delta -= box_size * np.round(delta / box_size)
            r2 = np.sum(delta**2, axis=-1, keepdims=True)
            strength = 0.15 * np.sin(0.3 * step + phase) * box_size
            acc += strength * delta / (r2 + 0.05 * box_size**2)
        acc -= 0.5 * vel  # damping

        # Temperature follows local speed + slow drift.
        speed = np.linalg.norm(vel, axis=-1, keepdims=True)
        temp_rate = 0.2 * (speed - temp * 0.1) + 0.02 * np.sin(
            0.2 * step + pos[:, :1] / box_size * 2 * np.pi
        )

        positions[step] = pos
        velocities[step] = vel
        accelerations[step] = acc
        energy[step] = temp

        vel = vel + acc * dt
        pos = np.remainder(pos + vel * dt, box_size)
        temp = temp + temp_rate * dt

    return {
        "Coordinates": positions.astype(np.float32),
        "Velocities": velocities.astype(np.float32),
        "InternalEnergy": energy.astype(np.float32),
        "HydroAcceleration": accelerations.astype(np.float32),
        "BoxSize": box_size,
        "TimeStep": dt,
    }
