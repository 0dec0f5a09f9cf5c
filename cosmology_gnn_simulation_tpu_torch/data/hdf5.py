"""HDF5 simulation-file schema I/O (counterpart of ``data/hdf5.py``).

Per file, the datasets

* ``Coordinates``        ``[T, N, 3]`` float
* ``Velocities``         ``[T, N, 3]`` float
* ``InternalEnergy``     ``[T, N]`` or ``[T, N, 1]`` float
* ``HydroAcceleration``  ``[T, N, 3]`` float
* ``BoxSize``            scalar
* ``TimeStep``           scalar

``h5py`` is imported inside the functions, so importing this module does
not need it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

FIELD_NAMES = (
    "Coordinates",
    "Velocities",
    "InternalEnergy",
    "HydroAcceleration",
)
SCALAR_FIELDS = ("BoxSize", "TimeStep")


def read_simulation(path: str, fields=None) -> Dict[str, np.ndarray]:
    """Load a simulation file into host memory.

    Returns a dict of float32 arrays plus float ``BoxSize`` / ``TimeStep``.
    ``InternalEnergy`` is normalized to ``[T, N, 1]``.
    """
    import h5py

    out: Dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        names = fields if fields is not None else list(f.keys())
        for name in names:
            data = f[name]
            if data.ndim == 0:
                out[name] = float(data[...])
            else:
                arr = np.asarray(data[:], dtype=np.float32)
                if name == "InternalEnergy" and arr.ndim == 2:
                    arr = arr[..., None]
                out[name] = arr
    return out


def write_simulation(path: str, data: Dict) -> None:
    """Write a simulation dict out in the same schema (arrays as float32)."""
    import h5py

    with h5py.File(path, "w") as f:
        for name, value in data.items():
            if np.isscalar(value) or np.ndim(value) == 0:
                f.create_dataset(name, data=value)
            else:
                f.create_dataset(name, data=np.asarray(value, dtype=np.float32))
