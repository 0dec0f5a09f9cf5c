"""Build and load the hand-written CUDA kernels; count their launches.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, built by one ``nvcc`` call for ``sm_90a`` (Hopper) at first use and
loaded with ``ctypes``. Nothing includes PyTorch's headers, so a build takes
seconds. Libraries go to ``build/kernels/`` at the repository root, named by
a hash of their source, the local headers it includes (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt and a stale library is
never loaded.

``launches[name]`` counts the launches of kernel ``name`` (one source may
host several: ``knn_select.cu`` has ``knn_select``, ``knn_codes`` and
``knn_dual``, ``window_matmul.cu`` has ``window_matmul`` and its S^T mode
``window_matmul_t``): each
wrapper adds one where it launches its kernel and nowhere else, so a caller
can zero the counts, drive a path, and see which kernels it went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

SOURCES = ("knn_select", "fused_tail", "fused_tail_bwd", "s_decode", "s_onehot",
           "window_matmul", "reverse_table", "dense_select", "knn_brute")
KERNELS = ("knn_select", "knn_codes", "knn_dual", "s_decode", "dense_select", "s_onehot",
           "reverse_table", "window_matmul", "window_matmul_t", "fused_tail",
           "fused_tail_bwd", "knn_brute")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# One library's flags beside NVCC_FLAGS. K6 is built without FMA
# contraction: its row warpgroup then spills less and runs faster.
EXTRA_FLAGS: Dict[str, List[str]] = {"fused_tail_bwd": ["--fmad=false"]}

launches: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: Optional[list] = None) -> list:
    """``path`` and every file it includes with ``#include "..."`` (relative
    to the including file, recursively), each once, in the order met."""
    seen = [] if seen is None else seen
    path = path.resolve()
    if path in seen:
        return seen
    seen.append(path)
    for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
        _sources(path.parent / name.decode(), seen)
    return seen


def _library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the flags, the
    source and the local headers it includes, so an edited header is
    rebuilt too."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, [])).encode())
    for path in _sources(PACKAGE_DIR / "csrc" / f"{name}.cu"):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build the named libraries (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns each
    new build's compiler log (``-Xptxas -v``: registers, shared memory,
    spills). Raises with ``nvcc``'s output if a build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), "-o", str(tmp),
               str(PACKAGE_DIR / "csrc" / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use)."""
    build([name])
    return ctypes.CDLL(str(_library_path(name)))


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
