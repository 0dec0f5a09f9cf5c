"""The native (C++) windowed-batch loader (counterpart of
``data/native_loader.py``): ctypes bindings to the repository's
``csrc/window_loader.cpp``, the flat binary cache it maps, and the batch
iterator over it.

* ``write_cache(sim, path)`` writes a simulation held in memory (the
  ``read_simulation`` dict, or the synthetic generator's) as a v2 ``.cgnn``
  cache: every ndim > 0 field, ``[T, N]`` fields as ``[T, N, 1]``,
  ``Coordinates`` and ``InternalEnergy`` first, the rest by name, written to
  a temporary file and renamed into place. ``convert_hdf5_to_cache`` is the
  HDF5 read (``data/hdf5.py``) followed by it, so caches can be made where
  ``h5py`` is missing;
* the C++ library maps the caches and assembles batches with threaded
  copies and a background prefetch thread, so batch i + 1 is built while
  the device runs step i. It is built at first use by ``g++ -O3 -std=c++17
  -shared -fPIC -pthread`` into ``build/native/`` at the repository root,
  named by a hash of the source and the flags, and renamed into place, so
  ranks that open it together never see half a library. A build that fails
  raises with the compiler's output: nothing falls back to the Python
  loader;
* ``NativeSequenceLoader.batches`` keeps ``SequenceDataset.batches``'
  contract (the same windows and ``np.random.default_rng(seed)`` shuffle,
  ``include_extras``, a tail batch built synchronously). With
  ``pin_memory=True`` (a loader that feeds a card) each batch's arrays are
  fresh pinned host tensors from PyTorch's pinned allocator, which the C++
  writes into, so the train step uploads them with ``non_blocking=True``.
  The caller keeps the tensors, never numpy views of them: the allocator
  holds a pinned block back from reuse only while a tensor it handed out
  records the copy still reading it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import struct
import subprocess
from glob import glob
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

MAGIC_V2 = 0x43474E4E53494D32
CORE_FIELDS = ("Coordinates", "InternalEnergy")
SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "window_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_F32P = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """The library of ``csrc/window_loader.cpp``, named by a hash of the
    flags and the source."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libwindow_loader-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library if it is not built yet; returns its path. Raises
    with the compiler's output if the build fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library with its C signatures (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    signatures = {
        "wl_open": (ctypes.c_void_p, [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]),
        "wl_num_sequences": (ctypes.c_int64, [ctypes.c_void_p]),
        "wl_num_particles": (ctypes.c_int64, [ctypes.c_void_p]),
        "wl_num_snapshots": (ctypes.c_int64, [ctypes.c_void_p]),
        "wl_box_size": (ctypes.c_double, [ctypes.c_void_p]),
        "wl_dt": (ctypes.c_double, [ctypes.c_void_p]),
        "wl_num_fields": (ctypes.c_int, [ctypes.c_void_p]),
        "wl_field_dim": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int]),
        "wl_field_name": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                                         ctypes.c_int]),
        "wl_get_batch_fields": (None, [ctypes.c_void_p, i64p, ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(_F32P), ctypes.POINTER(_F32P)]),
        "wl_close": (None, [ctypes.c_void_p]),
        "wl_prefetch_start_fields": (ctypes.c_void_p, [ctypes.c_void_p, i64p, ctypes.c_int64,
                                                       ctypes.c_int, ctypes.c_int,
                                                       ctypes.c_int]),
        "wl_prefetch_next_fields": (ctypes.c_int, [ctypes.c_void_p, ctypes.POINTER(_F32P),
                                                   ctypes.POINTER(_F32P)]),
        "wl_prefetch_stop": (None, [ctypes.c_void_p]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def write_cache(sim: Dict, cache_path: str) -> str:
    """Write simulation ``sim`` (arrays by field name, scalar ``BoxSize``
    and ``TimeStep``) as a v2 cache at ``cache_path``: the bytes
    ``convert_hdf5_to_cache`` of the JAX package writes for the same
    fields. Returns the path."""
    extra = sorted(name for name, arr in sim.items()
                   if getattr(arr, "ndim", 0) > 0 and name not in CORE_FIELDS)
    arrays: List[np.ndarray] = []
    names: List[str] = []
    for name in (*CORE_FIELDS, *extra):
        if name not in sim:
            raise ValueError(f"simulation lacks required field {name}")
        arr = np.asarray(sim[name], dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.ndim != 3:
            raise ValueError(f"{name}: expected [T, N(, d)], got {arr.shape}")
        arrays.append(np.ascontiguousarray(arr))
        names.append(name)
    t, n = arrays[0].shape[:2]
    tmp_path = f"{cache_path}.tmp.{os.getpid()}"
    with open(tmp_path, "wb") as f:
        f.write(struct.pack("<qqqdd", MAGIC_V2, t, n, float(sim["BoxSize"]),
                            float(sim["TimeStep"])))
        f.write(struct.pack("<q", len(names)))
        for name, arr in zip(names, arrays):
            encoded = name.encode()
            f.write(struct.pack("<q", len(encoded)))
            f.write(encoded)
            f.write(struct.pack("<q", arr.shape[2]))
        for arr in arrays:
            f.write(arr.tobytes())
    os.replace(tmp_path, cache_path)
    return cache_path


def convert_hdf5_to_cache(hdf5_path: str, cache_path: str) -> str:
    """One HDF5 simulation file as a v2 cache (``write_cache`` of its
    ``read_simulation``)."""
    from cosmology_gnn_simulation_tpu_torch.data.hdf5 import read_simulation

    return write_cache(read_simulation(hdf5_path), cache_path)


def _pointers(buffers) -> ctypes.Array:
    """A C array of the buffers' float pointers (numpy arrays or tensors)."""
    addresses = [b.data_ptr() if isinstance(b, torch.Tensor) else b.ctypes.data
                 for b in buffers]
    return (_F32P * len(buffers))(*[ctypes.cast(a, _F32P) for a in addresses])


class NativeSequenceLoader:
    """A batch source over ``.cgnn`` caches, assembled by the C++ library:
    ``batches`` and ``get_batch`` return ``SequenceDataset.batches``' dict
    (numpy arrays, or pinned CPU tensors with ``pin_memory``)."""

    def __init__(self, cache_paths: Sequence[str], window_size: int, num_threads: int = 4,
                 *, pin_memory: bool = False):
        self._lib = library()
        self._handle = None
        paths = (ctypes.c_char_p * len(cache_paths))(*[os.fsencode(p) for p in cache_paths])
        self._handle = self._lib.wl_open(paths, len(cache_paths), window_size, num_threads)
        if not self._handle:
            raise ValueError(f"failed to open caches (bad magic/shape mismatch): "
                             f"{list(cache_paths)}")
        self.window_size = window_size
        self.pin_memory = pin_memory
        self.num_particles = int(self._lib.wl_num_particles(self._handle))
        self.num_snapshots = int(self._lib.wl_num_snapshots(self._handle))
        self.box_size = float(self._lib.wl_box_size(self._handle))
        self.dt = float(self._lib.wl_dt(self._handle))
        self.field_names: List[str] = []
        self.field_dims: List[int] = []
        buf = ctypes.create_string_buffer(256)
        for i in range(int(self._lib.wl_num_fields(self._handle))):
            self._lib.wl_field_name(self._handle, i, buf, 256)
            self.field_names.append(buf.value.decode())
            self.field_dims.append(int(self._lib.wl_field_dim(self._handle, i)))
        if tuple(self.field_names[:2]) != CORE_FIELDS:
            raise ValueError(f"cache field order {self.field_names[:2]} != {CORE_FIELDS}")

    def __len__(self) -> int:
        return int(self._lib.wl_num_sequences(self._handle))

    def _empty(self, shape):
        if self.pin_memory:
            return torch.empty(shape, dtype=torch.float32, pin_memory=True)
        return np.empty(shape, np.float32)

    def _alloc(self, batch_size: int, num_fields: int):
        """Fresh window and target buffers of the leading ``num_fields``."""
        w, n = self.window_size, self.num_particles
        dims = self.field_dims[:num_fields]
        return ([self._empty((batch_size, w, n, d)) for d in dims],
                [self._empty((batch_size, n, d)) for d in dims])

    def _pack(self, wins, tgts) -> Dict:
        batch = {"positions": wins[0], "temperatures": wins[1], "target_positions": tgts[0],
                 "target_temperatures": tgts[1]}
        if len(wins) > 2:
            batch["extra_inputs"] = dict(zip(self.field_names[2:], wins[2:]))
            batch["extra_targets"] = dict(zip(self.field_names[2:], tgts[2:]))
        return batch

    def _num_fields(self, include_extras: bool) -> int:
        return len(self.field_names) if include_extras else 2

    def get_batch(self, seq_indices: Sequence[int], *, include_extras: bool = False) -> Dict:
        """The windows ``seq_indices``, assembled synchronously."""
        nf = self._num_fields(include_extras)
        seqs = np.ascontiguousarray(seq_indices, dtype=np.int64)
        if len(seqs) and (seqs.min() < 0 or seqs.max() >= len(self)):
            raise IndexError(f"window index out of range [0, {len(self)}): {seqs.tolist()}")
        wins, tgts = self._alloc(len(seqs), nf)
        self._lib.wl_get_batch_fields(self._handle, seqs, len(seqs), nf, _pointers(wins),
                                      _pointers(tgts))
        return self._pack(wins, tgts)

    def batches(self, batch_size: int, *, shuffle: bool = True, seed: int = 0,
                drop_remainder: bool = True, prefetch_depth: int = 2,
                include_extras: bool = False) -> Iterator[Dict]:
        """``SequenceDataset.batches``' batches, the full ones built ahead by
        the prefetch thread."""
        order = np.arange(len(self), dtype=np.int64)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        num_full = (len(order) // batch_size) * batch_size
        nf = self._num_fields(include_extras)
        full = np.ascontiguousarray(order[:num_full])
        pf = self._lib.wl_prefetch_start_fields(self._handle, full, num_full, batch_size,
                                                prefetch_depth, nf)
        if not pf:
            raise RuntimeError(f"native prefetcher failed to start (fields={nf}, "
                               f"batch_size={batch_size})")
        try:
            while True:
                wins, tgts = self._alloc(batch_size, nf)
                if not self._lib.wl_prefetch_next_fields(pf, _pointers(wins), _pointers(tgts)):
                    break
                yield self._pack(wins, tgts)
        finally:
            self._lib.wl_prefetch_stop(pf)
        if not drop_remainder and num_full < len(order):
            yield self.get_batch(order[num_full:], include_extras=include_extras)

    def close(self) -> None:
        if self._handle:
            self._lib.wl_close(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


def open_directory(path: str, window_size: int, *, cache_dir: Optional[str] = None,
                   pin_memory: bool = False) -> NativeSequenceLoader:
    """A loader over every HDF5 file in ``path`` (``*.hdf5``, else
    ``*.h5``), each converted to a cache in ``cache_dir`` (default
    ``path/.cgnn_cache``) where the cache is missing or older than it."""
    files = sorted(glob(os.path.join(path, "*.hdf5"))) or sorted(
        glob(os.path.join(path, "*.h5")))
    if not files:
        raise FileNotFoundError(f"No HDF5 files found in {path}")
    cache_dir = cache_dir or os.path.join(path, ".cgnn_cache")
    os.makedirs(cache_dir, exist_ok=True)
    caches = []
    for f in files:
        cache = os.path.join(cache_dir, os.path.splitext(os.path.basename(f))[0] + ".cgnn")
        if not os.path.exists(cache) or os.path.getmtime(cache) < os.path.getmtime(f):
            convert_hdf5_to_cache(f, cache)
        caches.append(cache)
    return NativeSequenceLoader(caches, window_size, pin_memory=pin_memory)
