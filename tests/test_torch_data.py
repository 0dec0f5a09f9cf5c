"""The port's data modules held against the JAX package's on the same files:
the HDF5 schema, the synthetic generator, the metadata statistics and the
windowed dataset. Everything here is numpy on both sides (no JAX compile),
so every comparison is exact: bit-equal arrays, equal dicts.
"""

import json
from pathlib import Path

import h5py
import numpy as np
import pytest

from cosmology_gnn_simulation_tpu.data.dataset import SequenceDataset as JaxSequenceDataset
from cosmology_gnn_simulation_tpu.data.hdf5 import read_simulation as jax_read_simulation
from cosmology_gnn_simulation_tpu.data.synthetic import (
    generate_synthetic_simulation as jax_generate,
)
from cosmology_gnn_simulation_tpu.metadata import compute_metadata as jax_compute_metadata
from cosmology_gnn_simulation_tpu_torch import data as port_data
from cosmology_gnn_simulation_tpu_torch.data import (
    FIELD_NAMES,
    SequenceDataset,
    generate_synthetic_simulation,
    read_simulation,
    write_simulation,
)
from cosmology_gnn_simulation_tpu_torch.metadata import compute_metadata, generate_metadata

FIXTURES = Path(__file__).resolve().parents[1] / "benchmarks" / "fixtures"
MSE_TRAIN = str(FIXTURES / "mse_train_n2048")
TRAIN_FILE = str(FIXTURES / "train_n2048.hdf5")


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            _assert_tree_equal(a[key], b[key])
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_package_exports_match_jax():
    from cosmology_gnn_simulation_tpu import data as jax_data

    assert sorted(port_data.__all__) == sorted(jax_data.__all__)
    assert FIELD_NAMES == jax_data.FIELD_NAMES


def test_hdf5_round_trip_and_2d_internal_energy(tmp_path):
    sim = generate_synthetic_simulation(num_snapshots=4, num_particles=32, seed=3)
    path = str(tmp_path / "sim.hdf5")
    write_simulation(path, sim)
    back = read_simulation(path)
    assert sorted(back) == sorted(sim)
    for name in FIELD_NAMES:
        np.testing.assert_array_equal(back[name], sim[name])
        assert back[name].dtype == np.float32
    assert back["BoxSize"] == sim["BoxSize"] and back["TimeStep"] == sim["TimeStep"]
    assert read_simulation(path, fields=["Coordinates"]).keys() == {"Coordinates"}
    # A 2-D InternalEnergy [T, N] is read as [T, N, 1], as JAX reads it.
    flat = str(tmp_path / "flat.hdf5")
    write_simulation(flat, {**sim, "InternalEnergy": sim["InternalEnergy"][..., 0]})
    with h5py.File(flat, "r") as f:
        assert f["InternalEnergy"].ndim == 2
    back = read_simulation(flat)
    assert back["InternalEnergy"].shape == (4, 32, 1)
    _assert_tree_equal(back, jax_read_simulation(flat))


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_simulation_bit_equal_to_jax(seed):
    kw = dict(num_snapshots=6, num_particles=200, seed=seed)
    port, ref = generate_synthetic_simulation(**kw), jax_generate(**kw)
    assert sorted(port) == sorted(ref)
    for name in FIELD_NAMES:
        np.testing.assert_array_equal(port[name], ref[name])
        assert port[name].dtype == ref[name].dtype
    assert port["BoxSize"] == ref["BoxSize"] and port["TimeStep"] == ref["TimeStep"]


def test_compute_metadata_equals_jax(tmp_path):
    sim = read_simulation(TRAIN_FILE)
    meta = compute_metadata(sim)
    assert meta == jax_compute_metadata(jax_read_simulation(TRAIN_FILE))
    out = tmp_path / "metadata.json"
    assert generate_metadata(TRAIN_FILE, str(out)) == meta
    assert json.loads(out.read_text()) == json.loads(json.dumps(meta))


def _metadata():
    with open(FIXTURES / "mse_metadata_n2048.json") as f:
        return json.load(f)


def test_sequence_dataset_windows_equal_jax():
    meta = _metadata()
    port, ref = SequenceDataset(MSE_TRAIN, 5, meta), JaxSequenceDataset(MSE_TRAIN, 5, meta)
    assert len(port) == len(ref) == 2 * 15
    assert port.field_names == ref.field_names
    assert (port.num_snapshots, port.num_particles) == (ref.num_snapshots, ref.num_particles)
    for idx in (0, 14, 15, 29, 3):  # both files; the LRU cache revisits file 0
        _assert_tree_equal(port[idx], ref[idx])


# (dataset kwargs, batches kwargs): two shuffle seeds, a subset of windows,
# the tail batch kept, and every field served with the extras stacked.
MODEL_FIELDS = {"fields": ("Coordinates", "InternalEnergy")}
BATCH_CASES = {
    "seed0": (MODEL_FIELDS, dict(batch_size=4, seed=0)),
    "seed11": (MODEL_FIELDS, dict(batch_size=3, seed=11)),
    "start_indices": ({**MODEL_FIELDS, "start_indices": [29, 2, 17, 5, 16, 0, 8]},
                      dict(batch_size=2, seed=4)),
    "tail": (MODEL_FIELDS, dict(batch_size=4, shuffle=False, drop_remainder=False)),
    "extras": ({"fields": None}, dict(batch_size=4, seed=2, drop_remainder=False,
                                      include_extras=True)),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_sequence_dataset_batches_equal_jax(case):
    ds_kw, batch_kw = BATCH_CASES[case]
    meta = _metadata()
    port = SequenceDataset(MSE_TRAIN, 5, meta, **ds_kw)
    ref = JaxSequenceDataset(MSE_TRAIN, 5, meta, **ds_kw)
    port_batches = list(port.batches(**batch_kw))
    ref_batches = list(ref.batches(**batch_kw))
    assert len(port_batches) == len(ref_batches) > 0
    for a, b in zip(port_batches, ref_batches):
        _assert_tree_equal(a, b)
    if case == "tail":
        assert port_batches[-1]["positions"].shape[0] == len(port) % 4
    if case == "extras":
        assert sorted(port_batches[0]["extra_inputs"]) == ["HydroAcceleration", "Velocities"]


def test_dataset_errors(tmp_path):
    meta = _metadata()
    with pytest.raises(FileNotFoundError, match="No HDF5 files"):
        SequenceDataset(str(tmp_path), 5, meta)
    for dataset in (SequenceDataset, JaxSequenceDataset):
        with pytest.raises(FileNotFoundError):
            dataset(str(tmp_path / "missing"), 5, meta)
    a, b = tmp_path / "a.hdf5", tmp_path / "b.hdf5"
    write_simulation(str(a), generate_synthetic_simulation(num_snapshots=8, num_particles=16))
    write_simulation(str(b), generate_synthetic_simulation(num_snapshots=8, num_particles=24))
    with pytest.raises(ValueError, match="mismatches"):
        SequenceDataset(str(tmp_path), 5, meta)
    with pytest.raises(ValueError, match="must exceed"):
        SequenceDataset(str(a), 8, meta)
    with pytest.raises(ValueError, match="Invalid start index"):
        SequenceDataset(str(a), 5, meta, start_indices=[3])
    with pytest.raises(ValueError, match="needs field"):
        next(SequenceDataset(str(a), 5, meta, fields=("Velocities",)).batches(1))
