"""Exact brute-force periodic k-NN (counterpart of ``ops/neighbors.py``),
and the CUDA kernel K9 that runs it on the card.

Queries are searched against all N particles under the minimum-image
metric. The result is ascending by distance with the SMALLEST INDEX first
among equal distances — JAX's ``lax.top_k`` order — so the self-loop leads
each self-query row. It is the small-N search, the exact rerun of the
rollout's ``exactness_guard="fallback"``, and (``knn_periodic_reference``,
by name) the yardstick of the cell-list kernel's exactness.

K9 (``csrc/knn_brute.cu``) replaces no Pallas kernel: the JAX package
computes brute force in XLA and gates the fallback with ``lax.cond``. The
kernel reads that gate, the certificate, on the device, so a gated rerun
costs neither a host sync nor the N^2 search (``knn_periodic(...,
skip_if=exact, out=neighbors)``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import f32, host_f32
from cosmology_gnn_simulation_tpu_torch.ops.periodic import min_image_displacement

# Largest k the kernel's warp queue is built for (as K1's).
MAX_K = 128


def knn_periodic_reference(
    positions: torch.Tensor,
    k: int,
    box_size,
    *,
    queries: torch.Tensor = None,
    query_tile: int = 512,
    return_distances: bool = False,
):
    """Plain PyTorch version of K9: the ``[Q, k]`` int64 indices into the
    ``[N, 3]`` reference set ``positions`` of the k nearest (periodic)
    particles of each of the ``[Q, 3]`` ``queries`` (default: the particles
    themselves, self included); optionally also the ``[Q, k]`` squared
    distances.

    Per axis ``d = q - p`` and ``d - box * rint(d / box)`` (a true
    division, half-to-even rounding), then ``d2 = dx*dx``, ``+ dy*dy``,
    ``+ dz*dz`` in that order, each product and sum rounded to float32 (the
    order of K1's plain version). The k smallest of the keys
    ``bits(d2) << 32 | index`` (d2 >= +0, so its bits order as the floats
    do; the keys are distinct) are the k smallest in (d2, index) order, the
    order of a stable sort by d2, ties included. ``query_tile`` queries are
    searched at a time: peak temporary memory is ``query_tile * N * 8``
    bytes x a few."""
    n = positions.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds particle count {n}")
    positions = positions.float()
    queries = positions if queries is None else queries.float()
    box = (box_size.float().to(positions.device) if isinstance(box_size, torch.Tensor)
           else f32(box_size, positions.device))
    index = torch.arange(n, device=positions.device)
    keys = []
    for start in range(0, queries.shape[0], query_tile):
        q = queries[start:start + query_tile]
        d2 = None
        for d in range(3):
            delta = min_image_displacement(q[:, d:d + 1] - positions[None, :, d], box)
            d2 = delta * delta if d2 is None else d2 + delta * delta
        key = (d2.view(torch.int32).long() << 32) | index
        keys.append(torch.topk(key, k, dim=1, largest=False, sorted=True).values)
    key = torch.cat(keys)
    idx = key & 0xFFFFFFFF
    if return_distances:
        return idx, (key >> 32).int().view(torch.float32)
    return idx


@functools.cache
def _lib():
    lib = kernels.library("knn_brute")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.knn_brute_launch.argtypes = [p, i, p, i, i, ctypes.c_float, p, p, p, p]
    lib.knn_brute_launch.restype = i
    return lib


def knn_brute(positions: torch.Tensor, k: int, box_size, *, queries=None, skip_if=None,
              out_ids: torch.Tensor, out_d2: torch.Tensor = None) -> None:
    """Launch K9 (``csrc/knn_brute.cu``) on CUDA tensors: write the exact
    k-NN of ``knn_periodic_reference`` into ``out_ids`` ``[Q, k]`` int64
    (and the squared distances into ``out_d2`` ``[Q, k]`` float32 where
    given), unless ``skip_if``, a 0-d bool tensor on the card, is true: then
    every block returns at once and the buffers keep what they held.
    ``box_size`` is a host number (``cell_list.host_f32``)."""
    queries = positions if queries is None else queries
    n, q = positions.shape[0], queries.shape[0]
    dev = positions.device
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"knn_brute: needs 1 <= k <= min({MAX_K}, N={n}), got {k}")
    checks = [("positions", positions, (n, 3), torch.float32),
              ("queries", queries, (q, 3), torch.float32),
              ("out_ids", out_ids, (q, k), torch.int64)]
    if out_d2 is not None:
        checks.append(("out_d2", out_d2, (q, k), torch.float32))
    if skip_if is not None:
        checks.append(("skip_if", skip_if, (), torch.bool))
    for label, t, shape, dtype in checks:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"knn_brute: {label} must be a contiguous {dtype} {shape} tensor "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    err = _lib().knn_brute_launch(
        kernels.ptr(positions), n, kernels.ptr(queries), q, k,
        ctypes.c_float(host_f32(box_size)), kernels.ptr(skip_if), kernels.ptr(out_ids),
        kernels.ptr(out_d2), kernels.stream_handle(dev))
    kernels.check("knn_brute", err)
    kernels.launches["knn_brute"] += 1


def knn_periodic(
    positions: torch.Tensor,
    k: int,
    box_size,
    *,
    queries: torch.Tensor = None,
    query_tile: int = 512,
    return_distances: bool = False,
    skip_if: torch.Tensor = None,
    out=None,
):
    """Exact periodic k-NN (see ``knn_periodic_reference``): ``[Q, k]``
    int64 indices, and the squared distances with ``return_distances``.

    CPU tensors take the plain version (``query_tile`` queries at a time);
    CUDA tensors launch K9 or raise. ``out`` is the caller's buffer (ids,
    or ``(ids, d2)`` with ``return_distances``), written in place and
    returned. ``skip_if``, a 0-d bool tensor (the rollout passes the search's
    certificate), needs ``out``: where it is true ``out`` is left as it is,
    where false it is overwritten with the exact k-NN. On the card the
    kernel reads the flag itself (no host sync); on the CPU it is read
    here, which costs nothing."""
    if skip_if is not None and out is None:
        raise ValueError("skip_if needs the buffer out that it may leave as it is")
    if positions.device.type == "cpu":
        if skip_if is not None and bool(skip_if):
            return out
        found = knn_periodic_reference(positions, k, box_size, queries=queries,
                                       query_tile=query_tile, return_distances=return_distances)
        if out is None:
            return found
        for dst, src in zip(out if return_distances else (out,),
                            found if return_distances else (found,)):
            dst.copy_(src)
        return out
    positions = positions.float().contiguous()
    queries = None if queries is None else queries.float().contiguous()
    q = positions.shape[0] if queries is None else queries.shape[0]
    if out is None:
        out_ids = torch.empty((q, k), dtype=torch.int64, device=positions.device)
        out_d2 = (torch.empty((q, k), dtype=torch.float32, device=positions.device)
                  if return_distances else None)
        out = (out_ids, out_d2) if return_distances else out_ids
    else:
        out_ids, out_d2 = out if return_distances else (out, None)
    knn_brute(positions, k, box_size, queries=queries, skip_if=skip_if,
              out_ids=out_ids, out_d2=out_d2)
    return out
