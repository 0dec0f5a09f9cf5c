"""The port's native loader (``data/native_loader.py``, over the repository's
``csrc/window_loader.cpp``): the eight contracts of
``tests/test_native_loader.py`` on the port, its cache writer byte-equal to
the JAX package's ``convert_hdf5_to_cache``, its batches bit-equal to the
JAX ``NativeSequenceLoader``'s over the same caches and to the port's
``SequenceDataset``, and ``cli.train --native_loader`` bit-equal to the
Python loader's run. Everything is a copy of float32 data: equal, bit for
bit.
"""

import os
import struct

import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu.data import native_loader as jax_native_loader
from cosmology_gnn_simulation_tpu_torch.cli import generate_metadata as generate_metadata_cli
from cosmology_gnn_simulation_tpu_torch.cli import train as train_cli
from cosmology_gnn_simulation_tpu_torch.data import native_loader
from cosmology_gnn_simulation_tpu_torch.data.dataset import SequenceDataset
from cosmology_gnn_simulation_tpu_torch.data.hdf5 import write_simulation
from cosmology_gnn_simulation_tpu_torch.data.synthetic import generate_synthetic_simulation
from cosmology_gnn_simulation_tpu_torch.metadata import compute_metadata
from cosmology_gnn_simulation_tpu_torch.training import plots
from cosmology_gnn_simulation_tpu_torch.types import tree_leaves
from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib

V1_MAGIC = 0x43474E4E53494D31
BATCH_KEYS = ("positions", "temperatures", "target_positions", "target_temperatures")


@pytest.fixture
def sim_dir(tmp_path):
    sims = []
    for i in range(2):
        sim = generate_synthetic_simulation(num_snapshots=9, num_particles=24, seed=i)
        write_simulation(str(tmp_path / f"sim{i}.hdf5"), sim)
        sims.append(sim)
    return tmp_path, sims


def assert_batches_equal(got, want, extras=False):
    for key in BATCH_KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    if extras:
        for group in ("extra_inputs", "extra_targets"):
            assert sorted(got[group]) == sorted(want[group])
            for name, value in want[group].items():
                np.testing.assert_array_equal(np.asarray(got[group][name]), value)


# ---- the eight contracts of tests/test_native_loader.py ----------------------


def test_open_and_metadata(sim_dir):
    path, sims = sim_dir
    loader = native_loader.open_directory(str(path), window_size=5)
    assert loader.num_particles == 24
    assert loader.num_snapshots == 9
    assert loader.box_size == pytest.approx(sims[0]["BoxSize"])
    assert loader.dt == pytest.approx(sims[0]["TimeStep"])
    assert len(loader) == 2 * (9 - 5)
    loader.close()


def test_batches_match_python_dataset(sim_dir):
    path, sims = sim_dir
    py_ds = SequenceDataset(str(path), window_size=5, metadata=compute_metadata(sims[0]))
    loader = native_loader.open_directory(str(path), window_size=5)
    native = loader.get_batch([0, 3, 5])
    for i, seq in enumerate([0, 3, 5]):
        sample = py_ds[seq]
        np.testing.assert_array_equal(native["positions"][i], sample["input"]["Coordinates"])
        np.testing.assert_array_equal(native["temperatures"][i],
                                      sample["input"]["InternalEnergy"])
        np.testing.assert_array_equal(native["target_positions"][i],
                                      sample["target"]["Coordinates"])
        np.testing.assert_array_equal(native["target_temperatures"][i],
                                      sample["target"]["InternalEnergy"])
    loader.close()


def test_prefetch_iteration_covers_epoch(sim_dir):
    path, _ = sim_dir
    loader = native_loader.open_directory(str(path), window_size=5)
    batches = list(loader.batches(2, shuffle=True, seed=3))
    assert len(batches) == len(loader) // 2
    assert batches[0]["positions"].shape == (2, 5, 24, 3)
    order = np.arange(len(loader), dtype=np.int64)
    np.random.default_rng(3).shuffle(order)
    for i, batch in enumerate(batches):
        assert_batches_equal(batch, loader.get_batch(order[2 * i:2 * i + 2]))
    loader.close()


def test_bad_cache_rejected(tmp_path):
    bad = tmp_path / "bad.cgnn"
    bad.write_bytes(b"not a cache file at all....")
    with pytest.raises(ValueError, match="failed to open"):
        native_loader.NativeSequenceLoader([str(bad)], window_size=5)


def test_truncated_cache_rejected_safely(tmp_path):
    """Valid magic, truncated payload: rejected, and the process opens a
    good cache afterwards."""
    bad = tmp_path / "truncated.cgnn"
    bad.write_bytes(struct.pack("<qqqdd", V1_MAGIC, 10, 100, 1.0, 0.05) + b"\x00" * 64)
    with pytest.raises(ValueError, match="failed to open"):
        native_loader.NativeSequenceLoader([str(bad)], window_size=5)
    sim = generate_synthetic_simulation(num_snapshots=8, num_particles=16)
    write_simulation(str(tmp_path / "ok.hdf5"), sim)
    cache = native_loader.convert_hdf5_to_cache(str(tmp_path / "ok.hdf5"),
                                                str(tmp_path / "ok.cgnn"))
    loader = native_loader.NativeSequenceLoader([cache], window_size=5)
    assert len(loader) == 3
    loader.close()


def test_overflow_header_rejected(tmp_path):
    """A header whose T * N overflows, or a negative T, is rejected."""
    for name, t, n in (("overflow", 1 << 60, 4), ("neg", -3, 16)):
        bad = tmp_path / f"{name}.cgnn"
        bad.write_bytes(struct.pack("<qqqdd", V1_MAGIC, t, n, 1.0, 0.05) + b"\x00" * 64)
        with pytest.raises(ValueError, match="failed to open"):
            native_loader.NativeSequenceLoader([str(bad)], window_size=5)


def test_extras_match_python_dataset(sim_dir):
    """v2 caches serve every ndim > 0 field; the extras are the dataset's."""
    path, sims = sim_dir
    py_ds = SequenceDataset(str(path), window_size=5, metadata=compute_metadata(sims[0]))
    loader = native_loader.open_directory(str(path), window_size=5)
    assert set(loader.field_names) >= {"Coordinates", "InternalEnergy", "Velocities",
                                       "HydroAcceleration"}
    native = loader.get_batch([1, 6], include_extras=True)
    for name in loader.field_names[2:]:
        for i, seq in enumerate([1, 6]):
            sample = py_ds[seq]
            np.testing.assert_array_equal(native["extra_inputs"][name][i], sample["input"][name])
            np.testing.assert_array_equal(native["extra_targets"][name][i],
                                          sample["target"][name])
    batches = list(loader.batches(2, shuffle=True, seed=7, include_extras=True))
    assert len(batches) == len(loader) // 2
    assert batches[0]["extra_inputs"]["Velocities"].shape == (2, 5, 24, 3)
    order = np.arange(len(loader), dtype=np.int64)
    np.random.default_rng(7).shuffle(order)
    assert_batches_equal(batches[0], loader.get_batch(order[:2], include_extras=True),
                         extras=True)
    loader.close()


def test_v1_cache_still_readable(tmp_path):
    """Old 2-field caches (magic CGNNSIM1) keep working."""
    sim = generate_synthetic_simulation(num_snapshots=8, num_particles=16)
    coords = np.ascontiguousarray(sim["Coordinates"], np.float32)
    energy = np.ascontiguousarray(sim["InternalEnergy"], np.float32)
    v1 = tmp_path / "v1.cgnn"
    v1.write_bytes(struct.pack("<qqqdd", V1_MAGIC, 8, 16, float(sim["BoxSize"]),
                               float(sim["TimeStep"])) + coords.tobytes() + energy.tobytes())
    loader = native_loader.NativeSequenceLoader([str(v1)], window_size=5)
    assert loader.field_names == ["Coordinates", "InternalEnergy"]
    batch = loader.get_batch([0])
    np.testing.assert_array_equal(batch["positions"][0], coords[:5])
    np.testing.assert_array_equal(batch["target_temperatures"][0], energy[5].reshape(16, 1))
    loader.close()


# ---- against the JAX package and the Python loader -------------------------------


def test_write_cache_is_jax_convert_byte_for_byte(sim_dir):
    path, sims = sim_dir
    jax_cache = jax_native_loader.convert_hdf5_to_cache(str(path / "sim0.hdf5"),
                                                        str(path / "jax.cgnn"))
    from_hdf5 = native_loader.convert_hdf5_to_cache(str(path / "sim0.hdf5"),
                                                    str(path / "port.cgnn"))
    in_memory = native_loader.write_cache(sims[0], str(path / "memory.cgnn"))
    want = open(jax_cache, "rb").read()
    assert open(from_hdf5, "rb").read() == want
    assert open(in_memory, "rb").read() == want
    assert not [f for f in os.listdir(path) if ".tmp." in f]


@pytest.mark.parametrize("shuffle, extras, drop_remainder", [
    (False, False, False), (True, False, True), (True, True, False)])
def test_batches_equal_jax_loader_and_dataset(sim_dir, shuffle, extras, drop_remainder):
    path, sims = sim_dir
    caches = [native_loader.write_cache(sim, str(path / f"c{i}.cgnn"))
              for i, sim in enumerate(sims)]
    port = native_loader.NativeSequenceLoader(caches, window_size=5)
    jax_loader = jax_native_loader.NativeSequenceLoader(caches, window_size=5)
    py_ds = SequenceDataset(str(path), window_size=5, metadata=compute_metadata(sims[0]))
    kw = dict(shuffle=shuffle, seed=11, drop_remainder=drop_remainder, include_extras=extras)
    got = list(port.batches(3, **kw))
    for others in (jax_loader.batches(3, **kw), py_ds.batches(3, **kw)):
        others = list(others)
        assert len(got) == len(others) == (3 if not drop_remainder else 2)
        for a, b in zip(got, others):
            assert_batches_equal(a, b, extras=extras)
    port.close()
    jax_loader.close()


def test_build_failure_raises_with_the_compilers_error(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises with g++'s output."""
    broken = tmp_path / "window_loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", broken)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error: expected"):
        native_loader.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_train_cli_native_loader_equals_python_loader(tmp_path, monkeypatch):
    """One epoch of ``cli.train --native_loader`` and the same without it:
    the same batches in the same order, so the same params, Adam state and
    history, bit for bit (no loss plots: seconds each, and unread)."""
    monkeypatch.setattr(plots, "plot_losses", lambda *args, **kwargs: None)
    for sub, seeds in (("train", (0, 1)), ("val", (2,))):
        os.makedirs(tmp_path / sub)
        for seed in seeds:
            write_simulation(str(tmp_path / sub / f"sim{seed}.hdf5"),
                             generate_synthetic_simulation(num_snapshots=8, num_particles=128,
                                                           seed=seed))
    generate_metadata_cli.main(["--dataset", str(tmp_path / "train" / "sim0.hdf5"),
                                "--output", str(tmp_path / "metadata.json")])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {}
        for name, flags in (("python", []), ("native", ["--native_loader"])):
            out = tmp_path / name
            runs[name] = train_cli.main([
                "--train_dir", str(tmp_path / "train"), "--val_dir", str(tmp_path / "val"),
                "--metadata_path", str(tmp_path / "metadata.json"), "--output_dir", str(out),
                "--device", "cpu", "--num_epochs", "1", "--batch_size", "2",
                "--latent_size", "16", "--mlp_hidden_size", "16", "--mlp_num_hidden_layers", "1",
                "--num_message_passing_steps", "2", "--num_neighbors", "8",
                "--noise_std", "3e-4", "--learning_rate", "1e-3", *flags])
    finally:
        torch.set_num_threads(threads)
    assert runs["native"].history == runs["python"].history
    a, b = (ckpt_lib.load_state(str(tmp_path / name / "model_epoch_0"))
            for name in ("python", "native"))
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
        assert torch.equal(x, y)
    for i, state in a["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state[key], b["optimizer"]["state"][i][key])
    assert sorted(os.listdir(tmp_path / "train" / ".cgnn_cache")) == ["sim0.cgnn", "sim1.cgnn"]
