"""Normalization statistics (``metadata.json``) (counterpart of
``metadata.py``: the same schema and values).

* ``temp_mean/std``: over snapshots and particles, per remaining feature
  axis (a scalar for 2-D ``InternalEnergy``, a length-1 list for 3-D);
* ``temp_rate_mean/std``: of the finite differences ``(E[t+1]-E[t]) / dt``;
* ``vel_mean/std``, ``acc_mean/std``: per-axis statistics of the stored
  ``Velocities`` / ``HydroAcceleration`` fields, collapsed to scalars by
  averaging the three axis values (training velocities come from
  coordinate finite differences instead);
* plus ``box_size`` and ``dt``.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

from cosmology_gnn_simulation_tpu_torch.data.hdf5 import read_simulation


def compute_metadata(sim: Dict) -> Dict:
    """Compute the metadata dict from an in-memory simulation."""
    velocities = np.asarray(sim["Velocities"], dtype=np.float64)
    accelerations = np.asarray(sim["HydroAcceleration"], dtype=np.float64)
    internal_energy = np.asarray(sim["InternalEnergy"], dtype=np.float64)
    box_size = float(sim["BoxSize"])
    dt = float(sim["TimeStep"])

    temp_mean = np.mean(internal_energy, axis=(0, 1))
    temp_std = np.std(internal_energy, axis=(0, 1))

    temp_rate = (internal_energy[1:] - internal_energy[:-1]) / dt
    temp_rate_mean = np.mean(temp_rate, axis=(0, 1))
    temp_rate_std = np.std(temp_rate, axis=(0, 1))

    vel_mean = float(np.mean(np.mean(velocities, axis=(0, 1))))
    vel_std = float(np.mean(np.std(velocities, axis=(0, 1))))
    acc_mean = float(np.mean(np.mean(accelerations, axis=(0, 1))))
    acc_std = float(np.mean(np.std(accelerations, axis=(0, 1))))

    def listify(x):
        return x.tolist() if isinstance(x, np.ndarray) else float(x)

    return {
        "temp_mean": listify(temp_mean),
        "temp_std": listify(temp_std),
        "temp_rate_mean": listify(temp_rate_mean),
        "temp_rate_std": listify(temp_rate_std),
        "vel_mean": vel_mean,
        "vel_std": vel_std,
        "acc_mean": acc_mean,
        "acc_std": acc_std,
        "box_size": box_size,
        "dt": dt,
    }


def generate_metadata(dataset_path: str, output_path: str) -> Dict:
    """Read one HDF5 simulation, compute stats, write ``metadata.json``."""
    sim = read_simulation(dataset_path)
    metadata = compute_metadata(sim)
    with open(output_path, "w") as f:
        json.dump(metadata, f, indent=4)
    print(f"Metadata saved to {output_path}")
    return metadata
