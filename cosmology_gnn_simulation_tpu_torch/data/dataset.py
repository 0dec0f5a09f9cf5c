"""Windowed sequence dataset over HDF5 simulation files (counterpart of
``data/dataset.py``: the same windows, cache, ``start_indices`` and batch
order).

Files are found by globbing ``*.hdf5`` (else ``*.h5``) in a directory, or
given as a path or a list; their ``[T, N]`` shapes must agree. Each window
is ``window_size`` input frames plus one target frame per field, with
``InternalEnergy`` expanded to ``[..., 1]``. ``batches`` stacks them into
numpy arrays ``[B, T, N, .]`` for the train step, shuffled by
``np.random.default_rng(seed)``. The xyz augmentation is not applied here:
the train step draws it on the device.

A small LRU cache holds whole files (default 2). Globally uniform shuffling
over more files than the cache holds reads a whole file per few samples;
raise ``cache_capacity`` for many-file corpora. ``h5py`` is imported where
files are read, so importing this module does not need it.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from glob import glob
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class SequenceDataset:
    def __init__(
        self,
        paths,
        window_size: int,
        metadata: Dict,
        start_indices: Optional[Sequence[int]] = None,
        fields: Optional[Sequence[str]] = None,
        cache_capacity: int = 2,
    ):
        """``fields=None`` (default) serves every ndim > 0 field found in
        the files. Pass a tuple to restrict it (e.g. ``("Coordinates",
        "InternalEnergy")``, the two the model reads and the two
        ``batches()`` stacks under its canonical keys; other served fields
        ride along under ``extra_inputs`` / ``extra_targets``)."""
        import h5py

        if isinstance(paths, str):
            if os.path.isdir(paths):
                file_lists = sorted(glob(os.path.join(paths, "*.hdf5")))
                if not file_lists:
                    file_lists = sorted(glob(os.path.join(paths, "*.h5")))
                if not file_lists:
                    raise FileNotFoundError(f"No HDF5 files found in {paths}")
            else:
                file_lists = [paths]
        elif isinstance(paths, (list, tuple)):
            file_lists = list(paths)
        else:
            raise ValueError("paths must be a directory, file, or list of files")

        self.file_lists: List[str] = file_lists
        self.nfiles = len(file_lists)
        if self.nfiles == 0:
            raise FileNotFoundError("No files found")

        with h5py.File(self.file_lists[0], "r") as f:
            available = [k for k in f.keys() if f[k].ndim > 0]
            if fields is None:
                self.field_names = sorted(available)
            else:
                self.field_names = [n for n in fields if n in available]
            if not self.field_names:
                raise ValueError(f"None of {fields} present in {self.file_lists[0]}")
            self.num_snapshots = f[self.field_names[0]].shape[0]
            self.num_particles = f[self.field_names[0]].shape[1]

        for file_path in self.file_lists[1:]:
            with h5py.File(file_path, "r") as f:
                shape = f[self.field_names[0]].shape
                if shape[0] != self.num_snapshots or shape[1] != self.num_particles:
                    raise ValueError(
                        f"File {file_path} shape {shape[:2]} mismatches "
                        f"({self.num_snapshots}, {self.num_particles})"
                    )

        self.metadata = metadata
        self.dt = float(metadata["dt"])
        self.box_size = float(metadata["box_size"])
        self.window_size = window_size
        if self.num_snapshots < self.window_size + 1:
            raise ValueError(f"num_snapshots ({self.num_snapshots}) must exceed "
                             f"window_size ({self.window_size})")
        self.num_sequences_per_sim = self.num_snapshots - self.window_size
        if start_indices is not None:
            max_possible = self.nfiles * self.num_sequences_per_sim
            if max(start_indices) >= max_possible:
                raise ValueError(f"Invalid start index: {max(start_indices)} >= {max_possible}")
            self.start_indices = list(start_indices)
        else:
            self.start_indices = None

        self._cache: OrderedDict[int, Dict[str, np.ndarray]] = OrderedDict()
        self._cache_capacity = cache_capacity

    def __len__(self) -> int:
        if self.start_indices is not None:
            return len(self.start_indices)
        return self.nfiles * self.num_sequences_per_sim

    def _load_simulation(self, sim_idx: int) -> Dict[str, np.ndarray]:
        if sim_idx in self._cache:
            self._cache.move_to_end(sim_idx)
            return self._cache[sim_idx]
        import h5py

        data = {}
        with h5py.File(self.file_lists[sim_idx], "r") as f:
            for name in self.field_names:
                arr = np.asarray(f[name][:], dtype=np.float32)
                if name == "InternalEnergy" and arr.ndim == 2:
                    arr = arr[..., None]
                data[name] = arr
        self._cache[sim_idx] = data
        while len(self._cache) > self._cache_capacity:
            self._cache.popitem(last=False)
        return data

    def __getitem__(self, idx: int) -> Dict[str, Dict[str, np.ndarray]]:
        """One sample: ``{"input": {field: [T, N, .]}, "target": {field: [N, .]}}``."""
        if self.start_indices is not None:
            idx = self.start_indices[idx]
        sim_idx, seq_idx = divmod(idx, self.num_sequences_per_sim)
        data = self._load_simulation(sim_idx)
        start, end = seq_idx, seq_idx + self.window_size
        sample_in = {name: data[name][start:end] for name in self.field_names}
        sample_tgt = {name: data[name][end] for name in self.field_names}
        return {"input": sample_in, "target": sample_tgt}

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        include_extras: bool = False,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield stacked minibatches for the train and eval steps.

        Each batch: ``positions [B, T, N, 3]``, ``temperatures [B, T, N, 1]``,
        ``target_positions [B, N, 3]``, ``target_temperatures [B, N, 1]``.
        With ``include_extras=True`` any served field beyond Coordinates /
        InternalEnergy is stacked under ``extra_inputs[name] [B, T, N, .]``
        and ``extra_targets[name] [B, N, .]``. With ``drop_remainder``
        (default) every batch has the same shape.
        """
        for name in ("Coordinates", "InternalEnergy"):
            if name not in self.field_names:
                raise ValueError(
                    f"batches() needs field {name!r}; dataset serves only "
                    f"{self.field_names}"
                )
        extras = [
            n for n in self.field_names
            if include_extras and n not in ("Coordinates", "InternalEnergy")
        ]
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            chunk = order[i: i + batch_size]
            if drop_remainder and len(chunk) < batch_size:
                break
            samples = [self[int(j)] for j in chunk]
            batch = {
                "positions": np.stack([s["input"]["Coordinates"] for s in samples]),
                "temperatures": np.stack([s["input"]["InternalEnergy"] for s in samples]),
                "target_positions": np.stack([s["target"]["Coordinates"] for s in samples]),
                "target_temperatures": np.stack(
                    [s["target"]["InternalEnergy"] for s in samples]),
            }
            if extras:
                batch["extra_inputs"] = {
                    n: np.stack([s["input"][n] for s in samples]) for n in extras
                }
                batch["extra_targets"] = {
                    n: np.stack([s["target"][n] for s in samples]) for n in extras
                }
            yield batch
