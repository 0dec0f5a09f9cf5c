"""Exact cell-list periodic k-NN around the CUDA kernel K1 (counterpart of
``ops/pallas_knn.py``; the Pallas kernel ``_select_kernel`` becomes
``csrc/knn_select.cu``: ids mode, and the codes mode K1' that the cell-block
plan build decodes).

Pipeline of ``pallas_cell_list_knn``:
  1. [torch] bin particles into a G^3 grid (stable sort by cell id) and
     scatter dense ``[G^3, cap]`` tables of x, y, z and particle id. ``cap``
     holds the common case (lam + 4.5 sigma); particles past it go to a
     static global SPILL block that every query also scans.
  2. [kernel ``knn_select`` / ``knn_codes``] per cell: candidates = the 27
     neighbor cells' table rows, pre-shifted by +-box where the neighbor
     index wraps, then the spill lanes; plain-difference d^2 (min-imaged in
     the trailing lanes that hold the spill block); the exact k smallest in
     (d^2, id) order — smallest particle id wins exact ties — or, in codes
     mode, in (d^2, lane) order with the candidate lane as the payload; and
     the k-th d^2.
  3. [torch] reorder to particle order via each particle's (cell, rank);
     solve the spilled particles exactly against their own cell's
     candidate row; reduce the exactness certificate.

The candidate lane order, the pre-shift and the min-imaged lane range are
the JAX wrapper's (lane ``j27 * cap + rank``, then the spill block; lanes
from ``(27 * cap) // 128 * 128`` on are min-imaged when the spill block is
active), so every d^2 is the same float32 sum ``(dx^2 + dy^2) + dz^2``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.ops.binning import bin_by_key, scatter_to_table
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import (
    CellGrid,
    cell_coords,
    f32,
    poisson_occupancy_capacity,
    window_margin_sq,
)
from cosmology_gnn_simulation_tpu_torch.ops.periodic import min_image_displacement

_BIG = 1e30
_LANE = 128
# Largest k the kernel's top-k list is built for (the JAX kernel's limit).
MAX_K = 128

# The 27 neighbor-cell offsets in lane order: dx slowest, dz fastest.
_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int64,
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def spill_layout(n: int, k: int, grid: CellGrid):
    """The static candidate-row layout ``(cap, num_cand, spill_cap)``.

    The spill block is active when the grid keeps the uniform-default
    capacity: the table then holds lam + 4.5 sigma per cell and the rare
    overflow rides ``spill_cap`` extra lanes (the JAX kernel's 128-lane
    padding). A raised capacity gets the spill-less layout.
    """
    g = grid.grid_size
    lam = n / g**3
    use_spill = grid.cell_capacity <= max(k, poisson_occupancy_capacity(lam, g**3))
    if use_spill:
        cap = _round_up(
            min(grid.cell_capacity, max(8, int(np.ceil(lam + 4.5 * np.sqrt(lam))))), 8
        )
        num_cand = _round_up(27 * cap, _LANE)
        spill_cap = num_cand - 27 * cap
        if spill_cap < 32:
            num_cand += _LANE
            spill_cap += _LANE
    else:
        cap = _round_up(grid.cell_capacity, 8)
        num_cand = _round_up(27 * cap, _LANE)
        spill_cap = 0
    return cap, num_cand, spill_cap


def codes_packing_cap(n: int, k: int, grid: CellGrid) -> int:
    """The per-cell capacity of the codes' lane packing ``j27 * cap + rank``
    (the ``codes_cap`` to hand ``build_cellblock``)."""
    return spill_layout(n, k, grid)[0]


def min_image_start(cap: int, spill_cap: int) -> int:
    """First min-imaged candidate lane: the 128-lane tile holding the start
    of the spill block (a few ring lanes share it; min-imaging a pre-shifted
    ring displacement is exact). No lane is min-imaged without spill."""
    return (27 * cap) // _LANE * _LANE if spill_cap else 27 * cap


class CellTable(NamedTuple):
    """Dense per-cell tables ``[G^3, cap]`` plus per-particle bookkeeping."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    ids: torch.Tensor  # int32, n marks an empty slot
    cell_id: torch.Tensor  # [N] flat cell of each particle
    particle_rank: torch.Tensor  # [N] stable rank within its cell
    overflow: torch.Tensor  # particles past cap in their cell


def build_table(positions: torch.Tensor, g: int, cap: int, box: torch.Tensor) -> CellTable:
    n = positions.shape[0]
    c = cell_coords(positions, g, box)
    cell_id = (c[:, 0] * g + c[:, 1]) * g + c[:, 2]
    b = bin_by_key(cell_id, g**3, cap, payload=(positions,))
    (sorted_pos,) = b.payload
    planes = [
        scatter_to_table(b, sorted_pos[:, d], g**3, cap, 0.0, torch.float32)
        for d in range(3)
    ]
    ids = scatter_to_table(b, b.order, g**3, cap, n, torch.int32)
    particle_rank = torch.empty_like(b.rank)
    particle_rank[b.order] = b.rank
    return CellTable(*planes, ids, cell_id, particle_rank, b.overflow)


def build_spill(positions: torch.Tensor, particle_rank: torch.Tensor, cap: int,
                spill_cap: int, cell_id=None):
    """The spill block's ``[spill_cap]`` x, y, z and id planes: the particles
    past ``cap`` in their cell, in particle order. Unused slots hold id
    ``n``; particles past ``spill_cap`` are dropped (counted as overflow).

    With ``cell_id`` it also returns the codes' spill resolution tables
    ``(spill_cells, spill_ranks)``: each spilled particle's cell and its
    stable-sort rank within that cell (unused slots: cell 0, rank 2**20,
    past any column capacity)."""
    n, dev = positions.shape[0], positions.device
    spilled = particle_rank >= cap
    slot = torch.where(spilled, torch.cumsum(spilled, 0) - 1, spill_cap)
    slot = slot.clamp(max=spill_cap)

    def plane(v, fill, dtype):
        out = torch.full((spill_cap + 1,), fill, dtype=dtype, device=dev)
        out[slot] = v.to(dtype)
        return out[:-1]

    planes = (
        plane(positions[:, 0], 0.0, torch.float32),
        plane(positions[:, 1], 0.0, torch.float32),
        plane(positions[:, 2], 0.0, torch.float32),
        plane(torch.arange(n, device=dev), n, torch.int32),
    )
    if cell_id is None:
        return planes
    return planes, (plane(cell_id, 0, torch.int32),
                    plane(particle_rank, 2**20, torch.int32))


def candidate_rows(table, spill, cells: torch.Tensor, g: int, box: torch.Tensor):
    """``(cx, cy, cz, cid)``, each ``[M, 27 * cap + spill_cap]``: the
    candidate rows of ``cells`` in lane order. A neighbor cell reached
    across the periodic boundary has its coordinate pre-shifted by +-box
    along that axis (``c + (+-box)``, as the JAX roll-and-add), so the plain
    difference ``q - c`` is a valid periodic displacement."""
    tx, ty, tz, tids = table
    dev = cells.device
    offsets = torch.as_tensor(_OFFSETS, device=dev)
    coords = torch.stack([cells // (g * g), (cells // g) % g, cells % g], dim=-1)
    raw = coords[:, None, :] + offsets[None, :, :]  # [M, 27, 3]
    wrapped = torch.remainder(raw, g)
    shift = (raw - wrapped) // g  # +1: crossed the top edge, -1: the bottom
    ncell = (wrapped[..., 0] * g + wrapped[..., 1]) * g + wrapped[..., 2]
    m = cells.shape[0]
    rows = []
    for d, plane in enumerate((tx, ty, tz)):
        c = plane[ncell]  # [M, 27, cap]
        s = shift[..., d:d + 1].expand_as(c)
        c = torch.where(s != 0, c + s.float() * box, c)
        rows.append(c.reshape(m, -1))
    rows.append(tids[ncell].reshape(m, -1))
    return tuple(
        torch.cat([r, sp[None, :].expand(m, -1)], dim=1) for r, sp in zip(rows, spill)
    )


def _lex_smallest(d2: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest (d2, id) pairs per row in lexicographic order — the
    pick order of the TPU kernel's masked re-min loop (ids are unique per
    row). Returns ``(d2_sorted[..., :k], ids_sorted[..., :k])``."""
    by_id = torch.argsort(ids, dim=-1, stable=True)
    d2 = torch.gather(d2, -1, by_id)
    ids = torch.gather(ids, -1, by_id)
    d2_sorted, order = torch.sort(d2, dim=-1, stable=True)
    return d2_sorted[..., :k], torch.gather(ids, -1, order[..., :k])


def _select_reference(table, spill, *, k, n, g, box, mi_start, codes):
    tx, ty, tz, tids = table
    num_cells, cap = tx.shape
    dev = tx.device
    big = f32(_BIG, dev)
    # Bound the [cells, cap, num_cand] d^2 temporary at ~2^24 elements.
    num_cand = 27 * cap + spill[0].shape[0]
    chunk = max(1, (1 << 24) // (cap * num_cand))
    lanes = torch.arange(num_cand, device=dev)
    lane_mi = lanes >= mi_start
    sentinel = num_cand if codes else n
    out_ids, out_kth = [], []
    for start in range(0, num_cells, chunk):
        cells = torch.arange(start, min(start + chunk, num_cells), device=dev)
        cx, cy, cz, cid = candidate_rows(table, spill, cells, g, box)
        d2 = None
        for q, c in ((tx, cx), (ty, cy), (tz, cz)):
            delta = q[cells][:, :, None] - c[:, None, :]
            mi = torch.where(delta > 0.5 * box, delta - box, delta)
            mi = torch.where(mi < -0.5 * box, mi + box, mi)
            delta = torch.where(lane_mi, mi, delta)
            d2 = delta * delta if d2 is None else d2 + delta * delta
        ids = cid[:, None, :].expand_as(d2)
        d2 = torch.where(ids >= n, big, d2)
        if codes:
            # Lanes ascend along each row: a stable sort by d^2 is the
            # (d^2, lane) order.
            d2_sorted, order = torch.sort(d2, dim=-1, stable=True)
            d2_k, payload_k = d2_sorted[..., :k], order[..., :k]
        else:
            d2_k, payload_k = _lex_smallest(d2, ids, k)
        picks = torch.where(d2_k < 0.5 * big, payload_k, sentinel)
        kth = d2_k[..., k - 1]
        empty = tids[cells] >= n  # [M, cap]
        picks = torch.where(empty[..., None], sentinel, picks)
        kth = torch.where(empty, big, kth)
        out_ids.append(picks.reshape(-1, k).to(torch.int32))
        out_kth.append(kth.reshape(-1))
    return torch.cat(out_ids), torch.cat(out_kth)


def knn_select_reference(table, spill, *, k: int, n: int, g: int, box: torch.Tensor,
                         mi_start: int):
    """Plain PyTorch version of the ``knn_select`` kernel (K1).

    ``table`` = ``(x, y, z, ids)`` ``[G^3, cap]`` (float32 x3, int32; id
    ``n`` = empty), ``spill`` = the same four ``[spill_cap]`` planes.
    Returns ``(ids [G^3 * cap, k] int32, kth [G^3 * cap] float32)``: per table
    row, the k nearest candidates in (d^2, id) order and the k-th d^2.
    Picks past the row's valid candidates are the sentinel ``n`` with kth
    1e30; empty table rows are all-sentinel rows.
    """
    return _select_reference(table, spill, k=k, n=n, g=g, box=box,
                             mi_start=mi_start, codes=False)


def knn_codes_reference(table, spill, *, k: int, n: int, g: int, box: torch.Tensor,
                        mi_start: int):
    """Plain PyTorch version of the ``knn_codes`` kernel (K1', codes mode).

    The same selection as ``knn_select_reference`` with the candidate LANE
    (``j27 * cap + rank``, then ``27 * cap + s`` for spill slot ``s``) as the
    payload: the k nearest in (d^2, lane) order, so the smallest lane wins
    exact ties. Exhausted picks and empty table rows carry the sentinel lane
    ``27 * cap + spill_cap``."""
    return _select_reference(table, spill, k=k, n=n, g=g, box=box,
                             mi_start=mi_start, codes=True)


@functools.cache
def _lib():
    lib = kernels.library("knn_select")
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry in (lib.knn_select_launch, lib.knn_codes_launch):
        entry.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, i, p, p, p]
        entry.restype = i
    return lib


def _launch(name: str, table, spill, *, k, n, g, box, mi_start):
    tx = table[0]
    num_cells, cap = tx.shape
    spill_cap = spill[0].shape[0]
    if num_cells != g**3:
        raise ValueError(f"table has {num_cells} cells, grid {g}^3 = {g**3}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name} kernel supports 1 <= k <= {MAX_K}, got {k}")
    dtypes = (torch.float32,) * 3 + (torch.int32,)
    checks = [("table", t, (num_cells, cap), dt) for t, dt in zip(table, dtypes)]
    checks += [("spill", t, (spill_cap,), dt) for t, dt in zip(spill, dtypes)]
    for label, t, shape, dtype in checks:
        if (t.device != tx.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {label} plane must be a contiguous {dtype} {shape} "
                f"tensor on {tx.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    out = torch.empty((num_cells * cap, k), dtype=torch.int32, device=tx.device)
    out_kth = torch.empty((num_cells * cap,), dtype=torch.float32, device=tx.device)
    entry = getattr(_lib(), f"{name}_launch")
    err = entry(
        *[kernels.ptr(t) for t in table], *[kernels.ptr(t) for t in spill],
        num_cells, g, cap, spill_cap, k, n, ctypes.c_float(float(box)), mi_start,
        kernels.ptr(out), kernels.ptr(out_kth), kernels.stream_handle(tx.device),
    )
    kernels.check(name, err)
    kernels.launches[name] += 1
    return out, out_kth


def knn_select(table, spill, *, k: int, n: int, g: int, box: torch.Tensor,
               mi_start: int):
    """K1: per-cell exact k-NN selection (see ``knn_select_reference``).

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/knn_select.cu`` or raise."""
    if table[0].device.type == "cpu":
        return knn_select_reference(table, spill, k=k, n=n, g=g, box=box,
                                    mi_start=mi_start)
    return _launch("knn_select", table, spill, k=k, n=n, g=g, box=box,
                   mi_start=mi_start)


def knn_codes(table, spill, *, k: int, n: int, g: int, box: torch.Tensor,
              mi_start: int):
    """K1': per-cell exact k-NN selection emitting candidate lanes (see
    ``knn_codes_reference``). CPU tensors take the plain version; CUDA
    tensors launch the codes mode of ``csrc/knn_select.cu`` or raise."""
    if table[0].device.type == "cpu":
        return knn_codes_reference(table, spill, k=k, n=n, g=g, box=box,
                                   mi_start=mi_start)
    return _launch("knn_codes", table, spill, k=k, n=n, g=g, box=box,
                   mi_start=mi_start)


def pallas_cell_list_knn(
    positions: torch.Tensor,
    k: int,
    box_size,
    grid: CellGrid,
    *,
    return_diagnostics: bool = False,
    with_codes: bool = False,
    codes_only: bool = False,
):
    """Exact periodic k-NN (self-query) through the cell-list kernel K1.

    Returns ``[N, k]`` int64 neighbor indices (ascending distance, min-id
    ties), plus ``(overflow, max_d2, max_excess)`` if requested: the result
    is provably exact iff ``overflow == 0`` (no spill-block exhaustion) and
    ``max_excess <= 0`` (every query's k-th neighbor within its window
    margin, ``cell_list.window_margin_sq``). All three stay on the device.

    ``codes_only=True`` runs the codes mode K1' instead and returns
    ``(None, codes, spill)`` (then the diagnostics): ``codes [N, k]`` int32
    holds each neighbor's candidate lane ``j27 * cap + rank`` (``cap`` =
    ``codes_packing_cap``; ``j27`` the neighbor cell's offset, dx slowest)
    or ``27 * cap + s`` for spill slot ``s``, in (d^2, lane) order — the
    smallest lane wins exact ties. Exhausted picks repeat the row's first
    code. ``spill`` is ``None`` without a spill block, else the resolution
    tables ``(spill_cells, spill_ranks)`` of ``build_spill``. Asking for
    ids and codes together (``with_codes`` alone) is not ported.
    """
    if with_codes and not codes_only:
        raise NotImplementedError(
            "pallas_cell_list_knn(with_codes=True) without codes_only (ids and "
            "codes together) is not ported; pass codes_only=True"
        )
    g = grid.grid_size
    if g < 3:
        raise ValueError("grid_size must be >= 3")
    n = positions.shape[0]
    dev = positions.device
    box = f32(box_size, dev)
    pos = positions.float()
    cap, _, spill_cap = spill_layout(n, k, grid)
    table = build_table(pos, g, cap, box)
    overflow = table.overflow
    spill, spill_info = build_spill(pos, table.particle_rank, cap, spill_cap,
                                    cell_id=table.cell_id)
    if spill_cap:
        overflow = torch.clamp(overflow - spill_cap, min=0)
    planes = (table.x, table.y, table.z, table.ids)
    select = knn_codes if codes_only else knn_select
    picked, kth = select(planes, spill, k=k, n=n, g=g, box=box,
                         mi_start=min_image_start(cap, spill_cap))

    # Back to particle order. A particle past `cap` has no table row: it
    # reads its cell's last row, then the spill solve overwrites it.
    table_row = table.cell_id * cap + torch.clamp(table.particle_rank, max=cap - 1)
    out = picked[table_row]
    if codes_only:
        # Exhausted picks (uncertified regime only) repeat the row's first
        # code; the kth keeps 1e30, so the certificate fails on such rows.
        out = torch.where(out >= 27 * cap + spill_cap, out[:, :1], out)
    else:
        out = out.long()
        # Exhausted picks (uncertified regime only) repeat the row's first pick.
        out = torch.where(out == n, out[:, :1], out)

    if spill_cap:
        # Spilled queries: exact solve against their own cell's candidate
        # row (the same set a table row of that cell scans), min-imaging
        # every lane. Unused spill slots have id n and are dropped.
        sp_pos = torch.stack(spill[:3], dim=1)
        spill_valid = spill[3] != n
        sc = cell_coords(sp_pos, g, box)
        sp_cell = (sc[:, 0] * g + sc[:, 1]) * g + sc[:, 2]
        cand = candidate_rows(planes, spill, sp_cell, g, box)
        d2s = None
        for d in range(3):
            dd = min_image_displacement(sp_pos[:, d:d + 1] - cand[d], box)
            d2s = dd * dd if d2s is None else d2s + dd * dd
        sp_ids = cand[3].long()
        d2s = torch.where(sp_ids >= n, f32(_BIG, dev), d2s)
        if codes_only:
            # (d2, lane) order: lanes ascend along the row, so a stable sort
            # by d2 ties on the smallest lane, as the codes kernel does.
            d2_sorted, lane_sorted = torch.sort(d2s, dim=1, stable=True)
            d2_k = d2_sorted[:, :k]
            picks = torch.where(d2_k >= 0.5 * _BIG, lane_sorted[:, :1],
                                lane_sorted[:, :k])
        else:
            d2_k, picks = _lex_smallest(d2s, sp_ids, k)
            picks = torch.where(picks == n, picks[:, :1], picks)
            picks = torch.where(picks == n, 0, picks)
        spill_kth = d2_k[:, k - 1]
        scatter = torch.where(spill_valid, spill[3].long(), n)
        out_ext = torch.cat([out, out.new_zeros((1, k))])
        out_ext[scatter] = picks.to(out.dtype)
        out = out_ext[:n]

    if codes_only:
        out = (None, out, spill_info if spill_cap else None)
    if not return_diagnostics:
        return out
    # Certificate: per occupied table slot, its k-th d^2 against the window
    # margin from its cell index and table coordinate (the binning the
    # kernel searched); spilled queries fold in with their own margins.
    valid_slot = table.ids.reshape(-1) != n
    max_d2 = torch.where(valid_slot, kth, 0.0).max()
    edge = box / g
    cell = torch.arange(g**3 * cap, device=dev) // cap
    fx = table.x.reshape(-1) - (cell // (g * g)).float() * edge
    fy = table.y.reshape(-1) - ((cell // g) % g).float() * edge
    fz = table.z.reshape(-1) - (cell % g).float() * edge
    m = edge + torch.minimum(
        torch.minimum(torch.minimum(fx, edge - fx), torch.minimum(fy, edge - fy)),
        torch.minimum(fz, edge - fz),
    )
    max_excess = torch.where(valid_slot, kth - m * m, -_BIG).max()
    if spill_cap:
        sp_excess = torch.where(spill_valid, spill_kth - window_margin_sq(sp_pos, box, grid), -_BIG)
        max_d2 = torch.maximum(max_d2, torch.where(spill_valid, spill_kth, 0.0).max())
        max_excess = torch.maximum(max_excess, sp_excess.max())
    diagnostics = (overflow, max_d2, max_excess)
    return (*out, diagnostics) if codes_only else (out, diagnostics)
