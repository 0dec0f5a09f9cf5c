"""Data (counterpart of ``data/``): the HDF5 schema, the windowed dataset
and the synthetic generator. Numpy only; ``h5py`` is imported where files
are read or written. The native (C++) loader is ``data/native_loader.py``,
imported from its module (it needs torch and builds its library at first
use)."""

from cosmology_gnn_simulation_tpu_torch.data.dataset import SequenceDataset
from cosmology_gnn_simulation_tpu_torch.data.hdf5 import (
    FIELD_NAMES,
    read_simulation,
    write_simulation,
)
from cosmology_gnn_simulation_tpu_torch.data.synthetic import generate_synthetic_simulation

__all__ = [
    "FIELD_NAMES",
    "read_simulation",
    "write_simulation",
    "SequenceDataset",
    "generate_synthetic_simulation",
]
