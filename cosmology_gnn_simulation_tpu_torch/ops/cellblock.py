"""Cell-block neighbor aggregation (counterpart of ``ops/cellblock.py``):
the aggregation ``agg[i] = sum_j z[neighbors[i, j]]`` as selection-matrix
products over a periodic cell decomposition, around six CUDA kernels:

* K2 ``s_decode`` (``csrc/s_decode.cu``, the Pallas ``_s_from_codes_fused``):
  the k-NN kernel's candidate codes -> per-edge S-lane offsets;
* K8 ``dense_select`` (``csrc/dense_select.cu``, the Pallas
  ``_dense_select_kernel``): the fused dense-query search, whose window
  lanes rebase into S-lane offsets without a separate k-NN round;
* K3 ``s_onehot`` (``csrc/s_onehot.cu``, the Pallas ``_s_from_offsets``):
  offsets -> int8 S rows of multiplicity counts;
* K7 ``reverse_table`` (``csrc/reverse_table.cu``, the Pallas
  ``_reverse_table_kernel``): the transpose table S_rev for training;
* K4 ``window_matmul`` (``csrc/window_matmul.cu``, the Pallas
  ``_window_kernel``): per query tile ``out = sum_j S_j @ window_j``, and
  its S^T mode K4^T ``window_matmul_t`` (the Pallas kernel's ``s_rev3``),
  the aggregation's backward ``dz = sum_j S_rev_j^T @ window_j(g)``.

Layout (the JAX package's, kept exactly so the S table is bit-equal):
particles sort by cell id and pack per (gx, gy) COLUMN, column ``col``
owning slot rows ``[col * CC, col * CC + count)`` in z-cell order. Each
column's padded image is ``[cP | main | cA]``: up to ``wrap_cap`` copies of
its last z-cell's rows, its rows, up to ``wrap_cap`` copies of its first
z-cell's rows (the ``pad_src`` gather map). A query tile of QB slots reads,
for each of the 9 columns of its 3x3 ring, one contiguous window of W
padded rows starting at ``window_starts[t, j]`` (floored to 16 rows, as the
TPU's sublane tiling wanted; the S lane offsets depend on it). S row ``q``
holds, at lane ``j * W + off``, how many of q's k neighbors sit at offset
``off`` of window ``j``. S_rev holds, per SENDER tile, how many edges each
of its slots sends to each row of its 9 windows.

Exact (gather-sum up to summation order) whenever ``overflow == 0`` and
``dropped_edges == 0``; both are counted, never silent. The backward is
exact when ``reverse_mismatch == 0`` too. The dense search adds
``search_window_overflow == 0`` and ``search_excess <= 0``.

Variable capacities (``slot_budget > 0``): column ``col`` owns the
QB-rounded count of its particles (clamped by CC) at a data-dependent
QB-aligned prefix of the slot rows, within a static ``slot_budget``; its
padded image spans ``round_up(cP + m + cA, 16)`` rows at a prefix of its
own. Tiles stay single-column, so every per-tile structure carries over;
the sender decode keeps the PACK ids ``col * CC + rank`` (``pack_slots``),
from which slots follow by the prefixes. Exceeding the budget counts in
``overflow``.

Halo slabs (``grid_x``, ``periodic_x=False``; ``choose_cellblock_spec_halo``):
one shard's local plan over an open slab of ``gx`` x-layers by the full
periodic ``G x G`` (y, z) cross-section, binned over a per-dimension box;
the 3x3 ring clamps in x instead of wrapping. A validity mask (``valid``)
bins its False rows past every real cell: they take no slot, sit in no
window and do not count as overflow.

Ported: the uniform and the variable cubic layouts and the uniform slab
layout, with or without a validity mask; the plan build from the k-NN codes
in the particle and the table codes layouts (cubic periodic grids only, as
in JAX), from neighbor ids (the aux path, every layout) and (uniform cubic
only, as in JAX) by the dense search, each with the reverse table; the
hybrid and slot-space aggregations with their backward (expand and compact
as monotone gathers both ways).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.ops.binning import bucket_boundaries
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import (
    NEIGHBOR_OFFSETS,
    CellGrid,
    choose_cell_grid,
    f32,
    host_f32,
    window_margin_sq,
)

_LANE = 128


def _round_up(x, m: int) -> int:
    return -(-int(x) // m) * m


class CellBlockSpec(NamedTuple):
    """Static cell-block configuration (the JAX ``CellBlockSpec``).

    Attributes:
      grid_size:    G — cells per (y, z) box edge, and per x edge on the
                    cubic grid (``gx * G`` columns of G z-cells).
      col_capacity: CC — slot rows per column (multiple of ``query_block``).
      query_block:  QB — query rows per tile.
      window:       W — candidate rows per neighbor column per tile.
      wrap_cap:     max rows copied per z-wrap segment.
      h_block:      the TPU kernel's latent tile (kept for spec equality).
      grid_x:       x-cells of a non-cubic grid (0 = cubic, ``G``): a halo
                    shard's slab of ``slab_layers + 2 * halo_layers``
                    x-layers over the full ``G x G`` (y, z) cross-section.
      periodic_x:   the x ring wraps; False on halo slabs, whose queries sit
                    at least one x-layer inside, so the ring's x index is a
                    plain difference (clamped at the slab's edges).
      slot_budget:  0 = the uniform layout (every column owns CC slot rows);
                    > 0 = variable capacities: the static total of slot rows
                    (a QB multiple), CC only the per-column clamp.
    """

    grid_size: int
    col_capacity: int
    query_block: int
    window: int
    wrap_cap: int
    h_block: int = 256
    grid_x: int = 0
    periodic_x: bool = True
    slot_budget: int = 0

    @property
    def gx(self) -> int:
        return self.grid_x or self.grid_size

    @property
    def variable(self) -> bool:
        return self.slot_budget > 0

    @property
    def num_columns(self) -> int:
        return self.gx * self.grid_size

    @property
    def tiles_per_col(self) -> int:
        return self.col_capacity // self.query_block

    @property
    def num_tiles(self) -> int:
        return self.num_slots // self.query_block

    @property
    def num_slots(self) -> int:
        if self.variable:
            return self.slot_budget
        return self.num_columns * self.col_capacity

    @property
    def pack_slots(self) -> int:
        """Size of the PACK encoding ``col * CC + rank`` that sender decodes
        use (``num_slots`` in the uniform layout, where pack ids are slot
        ids); also the no-sender sentinel of a pack table."""
        return self.num_columns * self.col_capacity

    @property
    def padded_col(self) -> int:  # rows per column in the (uniform) padded image
        return self.col_capacity + 2 * self.wrap_cap

    @property
    def num_padded(self) -> int:
        if self.variable:
            # The budget, each column's worst wrap and 16-rounding, and one
            # trailing window so the window clamp never reads past the image.
            return _round_up(self.slot_budget + self.num_columns * (2 * self.wrap_cap + 16)
                             + max(self.window, 16), 16)
        return self.num_columns * self.padded_col

    @property
    def s_width(self) -> int:
        return 9 * self.window

    @property
    def rev_lanes(self) -> int:
        """The reverse table's minor dimension: QB rounded up to 128 (the TPU
        kernel's lane padding, kept so the table is bit-equal); lanes past QB
        are never set."""
        return _round_up(self.query_block, _LANE)

    def validate(self) -> None:
        """The JAX spec checks (the window and wrap alignments also fix the
        S lane offsets, so they stay)."""
        g, cc, qb, w, ec = (self.grid_size, self.col_capacity,
                            self.query_block, self.window, self.wrap_cap)
        if g < 3:
            raise ValueError(f"grid_size {g} must be >= 3")
        if self.gx < 3:
            raise ValueError(f"grid_x {self.gx} must be >= 3")
        if not self.periodic_x and self.grid_x == 0:
            raise ValueError("periodic_x=False requires an explicit grid_x")
        if self.variable:
            if self.slot_budget % qb:
                raise ValueError(f"slot_budget {self.slot_budget} not a multiple of "
                                 f"query_block {qb}")
            if self.grid_x or not self.periodic_x:
                raise ValueError("variable capacities are cubic-periodic only (halo slabs use "
                                 "the uniform layout)")
            if w % 16:
                raise ValueError(f"window {w} must be a 16-multiple in variable mode (the "
                                 "padded-image clamp must stay 16-aligned)")
        if cc % qb:
            raise ValueError(f"col_capacity {cc} not a multiple of query_block {qb}")
        if qb % 32:
            raise ValueError(f"query_block {qb} must be a multiple of 32")
        if w % 8 or ec % 16:
            raise ValueError(
                f"window/wrap_cap ({w}/{ec}) must be multiples of 8/16"
            )
        if w >= _LANE and w % _LANE:
            raise ValueError(f"window {w} >= 128 must be a multiple of 128")
        if w > self.padded_col:
            raise ValueError(f"window {w} exceeds padded column {self.padded_col}")
        if max(self.num_slots, self.pack_slots) * g >= 2**31:
            raise ValueError("num_slots * grid_size overflows int32 packing")


def choose_cellblock_spec(
    num_particles: int,
    k: Optional[int] = None,
    *,
    h_block: int = 256,
    query_block: Optional[int] = None,
    variable: bool = False,
) -> CellBlockSpec:
    """Pick (G, CC, QB, W, wrap_cap) for a roughly uniform distribution —
    the JAX chooser's arithmetic, unchanged (QB, W and CC are still the
    TPU-tuned choice). G is the k-NN exactness grid when ``k`` is known.
    ``variable=True``: variable capacities, ``slot_budget`` the QB-rounding
    floor plus a 6-sigma margin on the total, CC an 8-sigma per-column
    clamp."""
    if k is not None:
        g = choose_cell_grid(num_particles, k).grid_size
    else:
        g = max(3, int(round((num_particles / 24.0) ** (1.0 / 3.0))))
    mean_col = num_particles / g**2
    mean_cell = num_particles / g**3
    return _plan_spec(g, mean_col, mean_cell, h_block, query_block, variable=variable)


def _plan_spec(g, mean_col, mean_cell, h_block, query_block, num_columns=None, grid_x=0,
               periodic_x=True, variable=False):
    """Capacity planning of the cubic and the halo-slab choosers: CC covers
    the per-column Poisson tail, W a QB tile's z-extent plus one cell each
    side with a 5-sigma margin; QB minimizes the TPU kernel's per-step
    traffic (S table plus re-streamed windows)."""
    if num_columns is None:
        num_columns = g * g
    wrap = _round_up(mean_cell + 6.0 * math.sqrt(mean_cell) + 4.0, 16)

    def plan(qb):
        sigmas = 8.0 if variable else 5.0  # variable: CC is only the clamp
        cc = _round_up(max(mean_col + sigmas * math.sqrt(mean_col), qb), qb)
        need = qb + 3.0 * mean_cell + 5.0 * math.sqrt(qb + 3.0 * mean_cell)
        w = _round_up(need, _LANE)
        padded = cc + 2 * wrap
        if w > padded:
            # Tiny columns: one window covers the whole padded column.
            w = padded if padded < _LANE else padded // _LANE * _LANE
        if variable and w % 16:
            w = _round_up(w, 16)
        return cc, w

    def budget(qb):
        # E[round_up(cnt, QB)] ~ mean + QB / 2 a column, plus 6 sigma on the
        # total (Poisson counts, rounding jitter ~ QB^2 / 12).
        sigma = math.sqrt(num_columns * mean_col + num_columns * qb * qb / 12.0)
        return _round_up(num_columns * (mean_col + qb / 2.0) + 6.0 * sigma, qb)

    if query_block is not None:
        qb = query_block
        cc, w = plan(qb)
    else:
        best = None
        for qb_c in range(32, 257, 32):
            cc_c, w_c = plan(qb_c)
            slots_c = budget(qb_c) if variable else num_columns * cc_c
            s_bytes = slots_c * 9 * w_c
            win_bytes = (slots_c // qb_c) * 9 * w_c * h_block * 2
            score = (s_bytes + win_bytes, -qb_c)
            if best is None or score < best[0]:
                best = (score, qb_c, cc_c, w_c)
        _, qb, cc, w = best
    return CellBlockSpec(grid_size=g, col_capacity=cc, query_block=qb, window=w,
                         wrap_cap=wrap, h_block=h_block, grid_x=grid_x, periodic_x=periodic_x,
                         slot_budget=budget(qb) if variable else 0)


def choose_cellblock_spec_halo(
    num_particles: int,
    grid_size: int,
    slab_layers: int,
    halo_layers: int,
    num_shards: int,
    *,
    h_block: int = 256,
    query_block: Optional[int] = None,
) -> CellBlockSpec:
    """The spec of one halo shard's LOCAL plan (the JAX chooser): an open
    slab of ``slab_layers + 2 * halo_layers`` x-layers over the full
    periodic ``grid_size x grid_size`` (y, z) cross-section, with the halo
    decomposition's cell edge (``parallel.halo.choose_halo_config``).
    ``num_particles`` is the GLOBAL count; capacities assume about uniform
    occupancy (clustered data trips the plan's overflow and dropped-edge
    counts). ``num_shards`` is the JAX signature's; the slab's width fixes
    the plan."""
    g = grid_size
    gxl = slab_layers + 2 * halo_layers
    mean_cell = num_particles / g**3
    mean_col = mean_cell * g  # one (x, y) column spans all G z-cells
    return _plan_spec(g, mean_col, mean_cell, h_block, query_block, num_columns=gxl * g,
                      grid_x=gxl, periodic_x=False)


class CellBlockGraph(NamedTuple):
    """Per-graph cell-block plan (the JAX ``CellBlockGraph``, forward fields).

    Particle indexing is in cell-sorted order (the caller permutes the model
    state by ``order``).

    Attributes:
      order:           ``[N]`` int64 — ``x_sorted = x[order]``.
      slot_of_sorted:  ``[N]`` int64 — slot of each sorted particle
                       (``col * CC + rank``; ``num_slots`` on column overflow).
      particle_of_slot: ``[num_slots]`` int64 — sorted particle of each slot
                       (``N`` for empty slots).
      pad_src:         ``[num_padded]`` int64 — padded-image row -> source
                       slot (``num_slots`` for unused rows).
      window_starts:   ``[num_tiles, 9]`` int32 — flat padded-image row of
                       each tile's window per ring column.
      s_table:         ``[num_slots, 9W]`` int8 — selection matrices.
      overflow:        scalar — particles beyond CC in their column.
      dropped_edges:   scalar — edges S cannot represent although their
                       receiver has a slot.
      window_overflow: scalar — most rows a tile's needed range exceeds W by.
      s_rev_table:     ``[num_tiles, 9W, rev_lanes]`` int8 or None — the
                       transpose selection matrices (``with_reverse=True``),
                       read by the aggregation's backward.
      reverse_mismatch: scalar or None — (edges in S) - (edges in S_rev);
                       0 certifies S_rev as the exact transpose of S.
      search_excess:   scalar or None (the dense search only) — the largest
                       k-th squared distance less the query's window margin
                       (``window_margin_sq``); <= 0 certifies every query's
                       k-th neighbor inside its provable window.
      search_window_overflow: scalar or None (the dense search only) — rows
                       the search windows truncated plus z-wrap copies past
                       ``wrap_cap``; either can hide a true neighbor, so 0
                       is part of the certificate.
    """

    order: torch.Tensor
    slot_of_sorted: torch.Tensor
    particle_of_slot: torch.Tensor
    pad_src: torch.Tensor
    window_starts: torch.Tensor
    s_table: torch.Tensor
    overflow: torch.Tensor
    dropped_edges: torch.Tensor
    window_overflow: torch.Tensor
    s_rev_table: Optional[torch.Tensor] = None
    reverse_mismatch: Optional[torch.Tensor] = None
    search_excess: Optional[torch.Tensor] = None
    search_window_overflow: Optional[torch.Tensor] = None


class CellBlockLayout(NamedTuple):
    """The data-dependent slot and window layout of a plan (everything but
    the S table): the ``CellBlockGraph`` fields of the same names, plus what
    the codes decode reads — each sorted particle's z-cell, the clipped
    compact start of every cell within its column ``cstart_rel [C, G]``,
    and the per-(tile, ring column) window constants ``tile_const
    [T, 45]`` int32 (``[w_loc, cP, m, cA, cstart_g1]`` at ``j * 5 + i``) —
    each column's count of wrap rows before its main rows ``c_pre [C]``
    (the reverse table's main-image positions) and after them ``c_app
    [C]``, its used rows ``used [C]``, and the sorted stream's cells
    ``sorted_cell [N]`` with their boundaries ``gstart [G^3 + 1]`` (what
    the dense search reads).

    Both layouts give the slot and tile maps that the variable one cannot
    derive from the CC and CCp strides: ``slot_col [num_slots]`` int64, each
    slot's column (the variable layout's reserve slots past the last prefix
    clamp to the last column); ``pack_of_sorted [N]`` int64, each sorted
    particle's pack id ``col * CC + rank`` (``pack_slots`` without a slot);
    per tile ``tile_col [T]`` (clamped) and ``tile_pack_base [T]`` (its
    first pack id; ``pack_slots + QB`` for reserve tiles, which match no
    sender), int32; per window ``window_lims [T, 9]`` (its rows inside the
    ring column's span: a variable window can reach into the next column's
    rows, which no S entry names) and ``main_base [T, 9]`` (the main-image
    row of slot s of that column is ``main_base + s``), int32; and
    ``main_pos [num_slots]`` int64, each slot's main-image row."""

    order: torch.Tensor
    slot_of_sorted: torch.Tensor
    particle_of_slot: torch.Tensor
    pad_src: torch.Tensor
    window_starts: torch.Tensor
    overflow: torch.Tensor
    window_overflow: torch.Tensor
    sorted_cz: torch.Tensor
    cstart_rel: torch.Tensor
    tile_const: torch.Tensor
    c_pre: torch.Tensor
    c_app: torch.Tensor
    used: torch.Tensor
    sorted_cell: torch.Tensor
    gstart: torch.Tensor
    slot_col: torch.Tensor
    pack_of_sorted: torch.Tensor
    tile_col: torch.Tensor
    tile_pack_base: torch.Tensor
    window_lims: torch.Tensor
    main_base: torch.Tensor
    main_pos: torch.Tensor


def _box(box_size, dev) -> torch.Tensor:
    """The box as float32 on ``dev``: a scalar edge, or a per-dimension
    ``[3]`` extent (a tensor, array or sequence)."""
    if isinstance(box_size, torch.Tensor):
        return box_size.to(device=dev, dtype=torch.float32)
    if isinstance(box_size, (int, float)) or np.ndim(box_size) == 0:
        return f32(float(box_size), dev)
    return torch.as_tensor(np.asarray(box_size, dtype=np.float32), device=dev)


def _grid_coords(positions: torch.Tensor, box_size, spec: CellBlockSpec) -> torch.Tensor:
    """``[N, 3]`` int64 cell coordinates on the spec's ``[gx, G, G]`` grid:
    ``clip(floor(p * (dims / box)))`` per dimension, the box a scalar or a
    per-dimension ``[3]`` extent (on the cubic grid with a scalar box, the
    ``cell_coords`` of every other search)."""
    g, dev = spec.grid_size, positions.device
    dims = torch.full((3,), float(g), device=dev)
    if spec.gx != g:
        dims[0] = float(spec.gx)
    scaled = torch.floor(positions.float() * (dims / _box(box_size, dev))).long()
    return torch.stack([torch.clamp(scaled[:, 0], 0, spec.gx - 1),
                        torch.clamp(scaled[:, 1], 0, g - 1),
                        torch.clamp(scaled[:, 2], 0, g - 1)], dim=1)


def cellblock_layout(positions: torch.Tensor, box_size, spec: CellBlockSpec,
                     valid: Optional[torch.Tensor] = None) -> CellBlockLayout:
    """Bin wrapped ``[N, 3]`` positions into the spec's columns: the sort
    order, slot maps, z-wrap image map, window placement and the overflow
    counts (the JAX ``build_cellblock`` up to its S build), in the uniform
    or the variable layout, on the cubic grid or a halo slab (``box_size``
    then a per-dimension ``[3]`` extent, positions in the slab's local
    frame). Rows where ``valid`` is False bin past every real cell: no slot,
    no window row, no overflow."""
    spec.validate()
    g = spec.grid_size
    cc, qb, w_cap, wrap = (spec.col_capacity, spec.query_block, spec.window,
                           spec.wrap_cap)
    tpc, ccp = spec.tiles_per_col, spec.padded_col
    num_cols, num_slots, num_tiles = spec.num_columns, spec.num_slots, spec.num_tiles
    num_cells = num_cols * g
    n = positions.shape[0]
    dev = positions.device

    coords = _grid_coords(positions, box_size, spec)
    cell_id = (coords[:, 0] * g + coords[:, 1]) * g + coords[:, 2]
    if valid is not None:
        cell_id = torch.where(valid.to(dev), cell_id, num_cells)
    sorted_cell, order = torch.sort(cell_id, stable=True)
    sorted_col = sorted_cell // g
    sorted_cz = sorted_cell % g

    # Per-cell / per-column boundaries of the sorted stream (invalid rows
    # trail the last cell: gstart[num_cells] is the valid count).
    gstart = bucket_boundaries(sorted_cell, num_cells)  # [cells + 1]
    col_start = gstart[::g]  # [cols + 1]
    counts = (gstart[1:] - gstart[:-1]).reshape(num_cols, g)
    col_cnt = col_start[1:] - col_start[:-1]

    # Compact per-column rank (z-ordered) and the slot maps.
    real_row = sorted_col < num_cols  # False only for invalid rows
    r = torch.arange(n, device=dev) - col_start[sorted_col]
    slot_ids = torch.arange(num_slots, device=dev)
    if spec.variable:
        # Column col owns slots [prefix[col], prefix[col] + cap_col[col]):
        # its count clamped by CC, rounded up to QB, cut by the budget.
        used_raw = torch.clamp(col_cnt, max=cc)
        alloc = -(-used_raw // qb) * qb
        prefix = torch.clamp(torch.cat([alloc.new_zeros(1), torch.cumsum(alloc, 0)]),
                             max=num_slots)
        cap_col = prefix[1:] - prefix[:-1]
        m = torch.minimum(used_raw, cap_col)  # used main rows
        col_clamped = torch.clamp(sorted_col, max=num_cols - 1)
        q_ok = real_row & (r < cap_col[col_clamped])
        slot_of_sorted = torch.where(q_ok, prefix[col_clamped] + r, num_slots)
        pack_of_sorted = torch.where(q_ok, sorted_col * cc + r, spec.pack_slots)
        # slot -> column: #{col : prefix[col + 1] <= slot}; reserve slots past
        # the last prefix get num_cols (clamped where a column is read).
        col_of_slot = torch.searchsorted(prefix[1:].contiguous(), slot_ids, right=True)
        slot_col = torch.clamp(col_of_slot, max=num_cols - 1)
        slot_r = slot_ids - prefix[slot_col]
        in_use = (col_of_slot < num_cols) & (slot_r < m[slot_col])
        particle_of_slot = torch.where(in_use, col_start[:-1][slot_col] + slot_r, n)
    else:
        q_ok = real_row & (r < cc)
        slot_of_sorted = pack_of_sorted = torch.where(q_ok, sorted_col * cc + r, num_slots)
        slot_col, slot_r = slot_ids // cc, slot_ids % cc
        particle_of_slot = torch.where(slot_r < col_cnt[slot_col],
                                       col_start[:-1][slot_col] + slot_r, n)
        m = torch.clamp(col_cnt, max=cc)  # used main rows
    overflow = (real_row & ~q_ok).sum()

    # Per-column z-wrap layout [cP | main | cA], tightly packed.
    c_pre = torch.clamp(counts[:, g - 1], max=wrap)
    c_app = torch.clamp(counts[:, 0], max=wrap)
    # Compact start of each z-cell within its column, clipped by capacity;
    # extended so index G reads the used-row count.
    rel = gstart[:num_cells].reshape(num_cols, g) - col_start[:-1, None]
    cstart_rel = (torch.minimum(torch.clamp(rel, min=0), cap_col[:, None]) if spec.variable
                  else torch.clamp(rel, 0, cc))
    cstart_ext = torch.cat([cstart_rel, m[:, None]], dim=1)  # [C, G + 1]
    cstart_g1 = cstart_rel[:, g - 1]

    if spec.variable:
        # Column col spans padded rows [pprefix[col], + span[col]), span
        # 16-aligned; row -> column as slot -> column above.
        span = -(-(c_pre + m + c_app) // 16) * 16
        num_pad = spec.num_padded
        pprefix = torch.cat([span.new_zeros(1), torch.cumsum(span, 0)])
        rows_p = torch.arange(num_pad, device=dev)
        pcol = torch.searchsorted(pprefix[1:].contiguous(), rows_p, right=True)
        pcsl = torch.clamp(pcol, max=num_cols - 1)
        t_rel = rows_p - pprefix[pcsl]
        cpre_r, m_r, capp_r, cap_r = c_pre[pcsl], m[pcsl], c_app[pcsl], cap_col[pcsl]
        src = torch.where(
            t_rel < cpre_r, cstart_g1[pcsl] + t_rel,
            torch.where(t_rel < cpre_r + m_r, t_rel - cpre_r,
                        torch.where(t_rel < cpre_r + m_r + capp_r, t_rel - cpre_r - m_r,
                                    cap_r)))
        ok_src = (pcol < num_cols) & (src < cap_r) & (src >= 0)
        pad_src = torch.where(ok_src, prefix[pcsl] + src, num_slots)
        main_pos = pprefix[slot_col] + c_pre[slot_col] + slot_r
    else:
        t_pad = torch.arange(ccp, device=dev)[None, :]
        src = torch.where(
            t_pad < c_pre[:, None], cstart_g1[:, None] + t_pad,
            torch.where(t_pad < (c_pre + m)[:, None], t_pad - c_pre[:, None],
                        torch.where(t_pad < (c_pre + m + c_app)[:, None],
                                    t_pad - (c_pre + m)[:, None], cc)))
        cols = torch.arange(num_cols, device=dev)[:, None]
        pad_src = torch.where(src < cc, cols * cc + src, num_slots).reshape(-1)
        main_pos = slot_col * ccp + c_pre[slot_col] + slot_r

    # Per-tile z extents (first/last valid query row of the tile).
    tiles = torch.arange(num_tiles, device=dev)
    if spec.variable:
        # Tiles are single-column by the QB-aligned prefixes; reserve tiles
        # past the used prefix have no rows.
        tile_col_raw = col_of_slot[::qb]
        tile_col = torch.clamp(tile_col_raw, max=num_cols - 1)
        a_row = tiles * qb - prefix[tile_col]
        m_tile = m[tile_col]
        has_rows = (tile_col_raw < num_cols) & (a_row < m_tile)
        b_row = torch.maximum(torch.minimum(a_row + qb, m_tile) - 1, a_row)
        tile_pack_base = torch.where(tile_col_raw < num_cols, tile_col * cc + a_row,
                                     spec.pack_slots + qb)
    else:
        tile_col, tile_qt = tiles // tpc, tiles % tpc
        a_row = tile_qt * qb
        m_tile = m[tile_col]
        has_rows = a_row < m_tile
        b_row = torch.maximum(torch.minimum((tile_qt + 1) * qb, m_tile) - 1, a_row)
        tile_pack_base = tiles * qb
    base = col_start[tile_col]
    z_lo = torch.where(has_rows, sorted_cz[torch.clamp(base + a_row, 0, n - 1)], 0)
    z_hi = torch.where(has_rows, sorted_cz[torch.clamp(base + b_row, 0, n - 1)], 0)

    # The 3x3 ring columns of each tile and their window placement; x open
    # on halo slabs (the edge clamps name no real edge: queries sit at least
    # one x-layer inside).
    dxy = torch.arange(9, device=dev)
    colx_j = (tile_col // g)[:, None] + dxy // 3 - 1
    colx_j = colx_j % spec.gx if spec.periodic_x else torch.clamp(colx_j, 0, spec.gx - 1)
    col_j = colx_j * g + ((tile_col % g)[:, None] + dxy % 3 - 1) % g  # [T, 9]
    cp_j, m_j, ca_j, cg1_j = c_pre[col_j], m[col_j], c_app[col_j], cstart_g1[col_j]
    start_lo = cstart_ext[col_j, torch.clamp(z_lo - 1, 0, g)[:, None]]
    w_loc = torch.where(z_lo[:, None] >= 1, cp_j + start_lo, 0)
    end_hi = cstart_ext[col_j, torch.clamp(z_hi + 2, 0, g)[:, None]]
    end = torch.where(z_hi[:, None] <= g - 2, cp_j + end_hi, cp_j + m_j + ca_j)
    # Starts floored to 16 rows (the TPU sublane tiling; the S offsets
    # depend on it, so it stays), clamped inside the column's padded rows.
    if spec.variable:
        span_j = span[col_j]
        w_loc = torch.minimum(torch.clamp(w_loc // 16 * 16, min=0),
                              torch.clamp(span_j - w_cap, min=0))
        window_starts = pprefix[col_j] + w_loc
        window_lims = torch.clamp(span_j - w_loc, 0, w_cap)
        main_base = pprefix[col_j] + c_pre[col_j] - prefix[col_j]
    else:
        w_loc = torch.clamp(w_loc // 16 * 16, 0, ccp - w_cap)
        window_starts = col_j * ccp + w_loc
        window_lims = torch.full_like(w_loc, w_cap)
        main_base = col_j * ccp + c_pre[col_j] - col_j * cc
    window_overflow = torch.clamp(
        torch.where(has_rows[:, None], end - w_loc - w_cap, 0).max(), min=0)
    tile_const = torch.stack([w_loc, cp_j, m_j, ca_j, cg1_j], dim=2).reshape(
        num_tiles, 45).to(torch.int32).contiguous()
    i32 = torch.int32
    return CellBlockLayout(
        order=order, slot_of_sorted=slot_of_sorted, particle_of_slot=particle_of_slot,
        pad_src=pad_src, window_starts=window_starts.to(i32), overflow=overflow,
        window_overflow=window_overflow, sorted_cz=sorted_cz, cstart_rel=cstart_rel,
        tile_const=tile_const, c_pre=c_pre, c_app=c_app, used=m, sorted_cell=sorted_cell,
        gstart=gstart, slot_col=slot_col.contiguous(), pack_of_sorted=pack_of_sorted,
        tile_col=tile_col.to(i32), tile_pack_base=tile_pack_base.to(i32),
        window_lims=window_lims.to(i32).contiguous(), main_base=main_base.to(i32).contiguous(),
        main_pos=main_pos,
    )


class SlotCodes(NamedTuple):
    """The k-NN codes moved to their query's slot: ``codes [num_slots, k]``
    int32 (empty slots and slotless particles' rows hold an always-invalid
    sentinel), the slot's query z-cell ``qz_slot [num_slots]``, and each
    spill candidate's packed sender ``pack * G + cz`` (``sp_aux
    [spill_len]``, the sentinel ``pack_slots * G`` past capacity; None
    without a spill block). The plain path of K2 and the train path's
    sender packs read it; K2 on the card gathers its codes itself."""

    codes: torch.Tensor
    qz_slot: torch.Tensor
    sp_aux: Optional[torch.Tensor]


def codes_rows(layout: CellBlockLayout, codes_spill, codes_cap: int, spec: CellBlockSpec,
               codes_layout: str = "particle") -> torch.Tensor:
    """Each sorted particle's row of the k-NN codes, ``[N]`` int64 (what K2
    reads a slot's codes through). ``"particle"``: its particle, ``order``.
    ``"table"``: the row ``cell * cap + rank`` of K1''s cell-table output
    (the plan bins by the k-NN's own key, so slots visit these rows in
    ascending order: a quasi-monotone row map; a particle past ``cap`` reads
    its cell's last row, as the particle layout's re-order gather does), and
    for spilled particle ``i`` of the spill tables the row ``G^3 * cap + i``
    of the spill picks that follow the table."""
    if codes_layout == "particle":
        return layout.order
    n = layout.order.shape[0]
    gstart, sorted_cell = layout.gstart, layout.sorted_cell
    rank = torch.arange(n, device=sorted_cell.device) - gstart[sorted_cell]
    rows = sorted_cell * codes_cap + torch.clamp(rank, max=codes_cap - 1)
    if codes_spill is not None:
        cells = torch.clamp(codes_spill[0].long(), 0, spec.num_columns * spec.grid_size - 1)
        ranks, start = codes_spill[1].long(), gstart[cells]
        # Unused spill slots (rank 2**20) name no particle: dropped.
        p = torch.where(ranks < gstart[cells + 1] - start, start + ranks, n)
        rows = torch.cat([rows, rows.new_zeros(1)])
        rows[p] = spec.num_columns * spec.grid_size * codes_cap + torch.arange(
            cells.shape[0], device=rows.device)
        rows = rows[:n]
    return rows


def slot_codes(layout: CellBlockLayout, neighbor_codes: torch.Tensor, codes_cap: int,
               codes_spill, spec: CellBlockSpec, codes_layout: str = "particle") -> SlotCodes:
    """Move the k-NN codes to their query's slot (the JAX plan build's codes
    path up to its decode): one row gather through ``codes_rows`` of the
    particle-order codes ``[N, k]`` or, in the table layout, of K1''s table
    ``[G^3 * cap, k]`` followed by the spill picks (``codes_spill[2]``).
    Picks at or past the valid lanes (``27 * cap + spill_len``: exhausted
    picks) repeat their row's first code, as the k-NN wrapper does in the
    particle layout."""
    g, cc = spec.grid_size, spec.col_capacity
    num_slots = spec.num_slots
    k = neighbor_codes.shape[1]
    dev = neighbor_codes.device
    spill_len = 0 if codes_spill is None else codes_spill[0].shape[0]
    # Always-invalid code for empty slots: past the ring and the spill block.
    code_sentinel = 27 * codes_cap + spill_len
    num_rows = neighbor_codes.shape[0]
    picks = codes_spill[2] if codes_layout == "table" and spill_len else None
    num_picks = 0 if picks is None else picks.shape[0]
    rows = codes_rows(layout, codes_spill, codes_cap, spec, codes_layout)
    row = torch.cat([rows, rows.new_full((1,), num_rows + num_picks)])[layout.particle_of_slot]
    codes_slots = neighbor_codes[torch.clamp(row, max=num_rows - 1)].to(torch.int32)
    if picks is not None:
        codes_slots = torch.where(
            (row >= num_rows)[:, None],
            picks[torch.clamp(row - num_rows, 0, num_picks - 1)].to(torch.int32), codes_slots)
    codes_slots = torch.where((row >= num_rows + num_picks)[:, None], code_sentinel, codes_slots)
    codes_slots = torch.where(codes_slots >= code_sentinel, codes_slots[:, :1], codes_slots)
    qz_slot = torch.zeros(num_slots + 1, dtype=torch.int32, device=dev)
    qz_slot[layout.slot_of_sorted] = layout.sorted_cz.to(torch.int32)
    sp_aux = None
    if spill_len:
        sp_cells = torch.clamp(codes_spill[0].long(), 0, g**3 - 1)
        sp_col, sp_cz = sp_cells // g, sp_cells % g
        sp_rs = layout.cstart_rel.reshape(-1)[sp_cells] + codes_spill[1].long()
        sp_in = sp_rs < cc
        sp_slot = torch.where(sp_in, sp_col * cc + sp_rs, spec.pack_slots)
        sp_aux = sp_slot * g + torch.where(sp_in, sp_cz, 0)
    return SlotCodes(codes=codes_slots.contiguous(), qz_slot=qz_slot[:num_slots],
                     sp_aux=sp_aux)


def neighbor_starts27(cstart_rel: torch.Tensor, g: int) -> torch.Tensor:
    """The compact starts of each cell's 27 neighbor cells in code order,
    ``[G^3, 27]`` int32, by 27 rolls of ``cstart_rel [C, G]`` (the plain
    path of K2; ``neighbor_cell`` finds the same entry by arithmetic)."""
    cstart3 = cstart_rel.reshape(g, g, g)
    return torch.stack(
        [torch.roll(cstart3, (-dx, -dy, -dz), dims=(0, 1, 2)) for dx, dy, dz in NEIGHBOR_OFFSETS],
        dim=-1,
    ).reshape(g**3, 27).to(torch.int32).contiguous()


def neighbor_cell(col: torch.Tensor, qz: torch.Tensor, j27: torch.Tensor, g: int):
    """Neighbor cell ``j27 = (dx+1) * 9 + (dy+1) * 3 + (dz+1)`` of the cell
    at column ``col``, z-cell ``qz``: its column ``((cx + dx) mod G, (cy +
    dy) mod G)`` and z-cell ``(qz + dz) mod G``, as K2 computes them
    (``cstart_rel[neighbor_cell(...)]`` is the 27-roll table's entry)."""
    ncol = ((col // g + j27 // 9 - 1) % g) * g + (col % g + (j27 // 3) % 3 - 1) % g
    return ncol, (qz + j27 % 3 - 1) % g


def _normalized_codes(sc: SlotCodes, codes_cap: int, spec: CellBlockSpec,
                      slot_col: torch.Tensor) -> torch.Tensor:
    """K2's pre-normalized codes (the JAX ``_invalidate`` / ``_resolve``):
    ring picks stay ``j27 * cap + rank``; resolved spill senders become
    ``27 * cap + jring * (CC * G) + r * G + cz``; real spill senders outside
    the 3x3 ring ``DROP_MARK``; everything else ``INVALID``."""
    g, cc = spec.grid_size, spec.col_capacity
    codes_slots = sc.codes
    res_base = 27 * codes_cap
    ccg = cc * g
    drop_mark = res_base + 9 * ccg
    invalid = drop_mark + 1
    normalized = torch.where(codes_slots >= res_base, invalid, codes_slots)
    if sc.sp_aux is not None:
        # Branch-free: without live spill codes this reduces to the plain
        # invalidation above, as the two arms of the JAX lax.cond do.
        spill_len = sc.sp_aux.shape[0]
        sp_idx = codes_slots.long() - res_base
        is_sp = (sp_idx >= 0) & (sp_idx < spill_len)
        aux_sp = sc.sp_aux[torch.clamp(sp_idx, 0, spill_len - 1)]
        slot_sp = aux_sp // g
        real = is_sp & (slot_sp < spec.pack_slots)
        col_sp = slot_sp // cc
        col_q = slot_col[:, None]
        dxm = (col_sp // g - col_q // g + 1 + g) % g
        dym = (col_sp % g - col_q % g + 1 + g) % g
        in3 = real & (dxm < 3) & (dym < 3)
        packed_sp = res_base + (dxm * 3 + dym) * ccg + (slot_sp % cc) * g + aux_sp % g
        v = torch.where(in3, packed_sp, torch.where(real, drop_mark, invalid))
        normalized = torch.where(is_sp, v.to(torch.int32), normalized)
    return normalized.contiguous()


def s_decode_inputs(layout: CellBlockLayout, neighbor_codes: torch.Tensor, codes_cap: int,
                    codes_spill, spec: CellBlockSpec, codes_layout: str = "particle"):
    """The plain version's inputs of K2: ``(codes [num_slots, k], qz_slot
    [num_slots], cstart27 [G^3, 27], tile_const [T, 45])``, all int32, and
    ``layout.slot_col`` — the k-NN codes moved to their query's slot and
    pre-normalized (``slot_codes``, ``_normalized_codes``) and the 27-roll
    start table (``neighbor_starts27``). K2 on the card does all of this
    itself."""
    sc = slot_codes(layout, neighbor_codes, codes_cap, codes_spill, spec, codes_layout)
    return (_normalized_codes(sc, codes_cap, spec, layout.slot_col), sc.qz_slot.contiguous(),
            neighbor_starts27(layout.cstart_rel, spec.grid_size), layout.tile_const,
            layout.slot_col)


def sender_packs(sc: SlotCodes, layout: CellBlockLayout, codes_cap: int,
                 spec: CellBlockSpec) -> torch.Tensor:
    """Each slot's k sender PACK ids ``col * CC + rank`` ``[num_slots, k]``
    int32, ``pack_slots`` where there is no sender (the JAX codes path's
    arithmetic decode, which its reverse build reads): a ring code names
    the neighbor cell ``j27`` of the query's cell (``neighbor_cell``) and
    the sender's rank in it; a spill code reads the spill candidate's
    packed sender."""
    g, cc = spec.grid_size, spec.col_capacity
    codes = sc.codes.long()
    col_q = layout.slot_col[:, None]
    j27 = codes // codes_cap
    rank = codes - j27 * codes_cap
    valid = j27 < 27
    j27 = torch.where(valid, j27, 0)
    scol, sz = neighbor_cell(col_q, sc.qz_slot.long()[:, None], j27, g)
    sr = layout.cstart_rel[scol, sz] + rank
    pack = torch.where(valid & (sr < cc), scol * cc + sr, spec.pack_slots)
    if sc.sp_aux is not None:
        spill_len = sc.sp_aux.shape[0]
        sp_idx = codes - 27 * codes_cap
        is_sp = (sp_idx >= 0) & (sp_idx < spill_len)
        pack = torch.where(is_sp, sc.sp_aux[torch.clamp(sp_idx, 0, spill_len - 1)] // g, pack)
    return pack.to(torch.int32)


def reverse_candidates(packs: torch.Tensor, layout: CellBlockLayout,
                       spec: CellBlockSpec) -> torch.Tensor:
    """The plain version's input of K7, ``[num_padded, k + 1]`` int32: per
    padded-image row, the sender packs of its particle's neighbor list and,
    last, the padded row of the particle's main image (``pack_slots``
    throughout for unused rows). K7 on the card reads ``packs`` through
    ``pad_src`` and computes the main-image rows itself."""
    packed = torch.cat([packs, layout.main_pos.to(torch.int32)[:, None]], dim=1)
    packed = torch.cat([packed, packed.new_full((1, packed.shape[1]), spec.pack_slots)])
    return packed.index_select(0, layout.pad_src).contiguous()


def aux_slot_senders(layout: CellBlockLayout, neighbors: torch.Tensor,
                     spec: CellBlockSpec) -> torch.Tensor:
    """The aux path's senders per slot (JAX ``build_cellblock`` from
    neighbor ids): ``[num_slots, k]`` int64, each the packed ``pack * G +
    cz`` of the sender's pack id (``col * CC + rank``) and z-cell, and the
    sentinel ``pack_slots * G`` where there is no sender (ids >= N, a sender
    past its column's capacity, an empty slot). The packed aux of every
    particle in original order, one gather through the ``[N, k]`` table,
    the rows permuted by ``order`` and expanded to slots."""
    g = spec.grid_size
    pack_slots = spec.pack_slots
    n, k = neighbors.shape
    pack = torch.empty_like(layout.pack_of_sorted)
    pack[layout.order] = layout.pack_of_sorted
    cz = torch.empty_like(layout.sorted_cz)
    cz[layout.order] = layout.sorted_cz
    aux = pack * g + torch.where(pack < pack_slots, cz, 0)
    aux_ext = torch.cat([aux, aux.new_full((1,), pack_slots * g)])
    nbr = aux_ext[torch.clamp(neighbors.long(), 0, n)][layout.order]
    nbr_ext = torch.cat([nbr, nbr.new_full((1, k), pack_slots * g)])
    return nbr_ext[layout.particle_of_slot]


def aux_offsets(senders: torch.Tensor, layout: CellBlockLayout, spec: CellBlockSpec):
    """S-lane offsets of the aux path's senders (``aux_slot_senders``; the
    JAX ``s_tile``): ``(offsets [num_slots, k] int16, dropped_edges)``. A
    sender in the query column's 3x3 ring lands at the window lane of its
    main image, else of its pre z-wrap image, else of its appended one, in
    that order of priority; a real sender no image places is a dropped
    edge; no edge, or an empty query slot, is the inert lane ``9W``. On a
    halo slab the ring's x index is the plain difference of the x-layers."""
    g, cc, qb, w_cap = spec.grid_size, spec.col_capacity, spec.query_block, spec.window
    gx = spec.gx
    dev = senders.device
    slots = torch.arange(spec.num_slots, device=dev)
    col_q = layout.slot_col[:, None]
    s_slot = senders // g
    s_cz = senders % g
    real = s_slot < spec.pack_slots
    col_s, r_s = s_slot // cc, s_slot % cc
    dx = col_s // g - col_q // g + 1
    if spec.periodic_x:
        dx = (dx + gx) % gx
    dy = (col_s % g - col_q % g + 1 + g) % g
    in3 = (dx >= 0) & (dx < 3) & (dy < 3) & real
    j = torch.where(in3, dx * 3 + dy, 9)
    const = layout.tile_const.long()[slots // qb]  # [S, 45]
    jc = torch.clamp(j, max=8)
    w_s, cp_s, m_s, ca_s, cg1_s = (
        torch.where(in3, torch.gather(const, 1, jc * 5 + i), 0) for i in range(5)
    )
    in3 = in3 & (r_s < m_s)
    rel_main = cp_s + r_s - w_s
    ok_main = in3 & (rel_main >= 0) & (rel_main < w_cap)
    rank_pre = r_s - cg1_s
    rel_pre = rank_pre - w_s
    ok_pre = in3 & (s_cz == g - 1) & (rank_pre < cp_s) & (rel_pre >= 0) & (rel_pre < w_cap)
    rel_app = cp_s + m_s + r_s - w_s
    ok_app = in3 & (s_cz == 0) & (r_s < ca_s) & (rel_app >= 0) & (rel_app < w_cap)
    off = torch.where(ok_main, rel_main, torch.where(ok_pre, rel_pre, rel_app))
    placed = ok_main | ok_pre | ok_app
    occupied = (layout.particle_of_slot < layout.order.shape[0])[:, None]
    offsets = torch.where(occupied & placed, j * w_cap + off, spec.s_width)
    return offsets.to(torch.int16), (occupied & real & ~placed).sum()


class DenseSearchSpec(NamedTuple):
    """The dense-query search's tiling (the JAX ``DenseSearchSpec``):
    ``query_block`` (QB_s) dense cell-sorted query rows per search tile, a
    positive multiple of 8; ``window`` (W_s) candidate rows per ring column
    per tile, a multiple of 128, which must cover a tile's z-extent plus one
    cell each side (truncation is counted and fails the certificate)."""

    query_block: int = 16
    window: int = 128

    def validate(self) -> None:
        if self.query_block % 8 or self.query_block <= 0:
            raise ValueError(f"dense query_block {self.query_block} must be a positive "
                             "multiple of 8")
        if self.window % _LANE:
            raise ValueError(f"dense window {self.window} must be a multiple of {_LANE}")


def choose_dense_search_spec(num_particles: int, spec: CellBlockSpec,
                             query_block: int = 16) -> DenseSearchSpec:
    """The JAX chooser: a QB_s-row tile's window holds about QB_s plus two
    mean cells of rows; 5 sigma on that plus QB_s more for a tile that
    straddles cell boundaries, rounded up to 128."""
    mean_cell = num_particles / spec.grid_size**3
    expect = query_block + 2.0 * mean_cell
    w = expect + 5.0 * math.sqrt(max(expect, 1.0)) + query_block
    return DenseSearchSpec(query_block=query_block,
                           window=max(_round_up(math.ceil(w), _LANE), _LANE))


class DenseSearch(NamedTuple):
    """K8's inputs and what the rebase of its lanes reads (the JAX
    ``_dense_search_offsets`` up to its kernel call).

    Attributes:
      table:    ``[C, 3, ccp]`` float32 — per column its padded image of
                x, y, z (``[cP | main | cA]``, the z-wrap copies' z shifted
                by -+box; unused rows at ``4 * box``), ``ccp`` = the padded
                column rounded up to 128.
      queries:  ``[T * QB_s, 3]`` float32 — the sorted rows in dense tile
                order (column ``col`` packs ``ceil(used / QB_s)`` tiles);
                rows no tile owns are zero.
      windows:  ``[T, 9, 4]`` int32 — per tile and ring column: the column,
                the window's first row (the start floored to 128, clamped so
                ``w_eff`` rows fit), and the x and y periodic shifts (-1, 0,
                1) of its coordinates. ``T = C + ceil(N / QB_s)``.
      tile_col, tile_row0, rows, abs0: ``[T]`` — each tile's column, first
                row in it, live rows (int32, K8's mask; 0 for tiles past
                the used ones) and first sorted row.
      window_overflow: scalar — rows the windows truncated plus z-wrap
                copies past ``wrap_cap`` (``search_window_overflow``).
      w_eff:    rows a window reads, ``min(W_s + 128, ccp)``.
      ccp:      the table's row stride.
    """

    table: torch.Tensor
    queries: torch.Tensor
    windows: torch.Tensor
    tile_col: torch.Tensor
    tile_row0: torch.Tensor
    rows: torch.Tensor
    abs0: torch.Tensor
    window_overflow: torch.Tensor
    w_eff: int
    ccp: int


def dense_search_inputs(layout: CellBlockLayout, sorted_pos: torch.Tensor, box_size,
                        spec: CellBlockSpec, dspec: DenseSearchSpec) -> DenseSearch:
    """Build K8's coordinate table, query tiles and windows from the plan's
    layout and the cell-sorted ``[N, 3]`` positions (the JAX
    ``_dense_search_offsets`` up to its kernel call; ``w_eff``, the
    128-floored starts and the lane numbering are JAX's)."""
    g, cc, wrap = spec.grid_size, spec.col_capacity, spec.wrap_cap
    num_cols = spec.num_columns
    qb_s = dspec.query_block
    ccp_s = _round_up(2 * wrap + cc, _LANE)
    w_eff = min(dspec.window + _LANE, ccp_s)
    n = sorted_pos.shape[0]
    t_bound = num_cols + -(-n // qb_s)
    dev = sorted_pos.device
    box = f32(box_size, dev)
    iota = torch.arange(n, device=dev)
    gstart, used, c_pre, c_app = layout.gstart, layout.used, layout.c_pre, layout.c_app
    col_start = gstart[::g]
    sorted_col, sorted_cz = layout.sorted_cell // g, layout.sorted_cz
    r_col = iota - col_start[sorted_col]
    r_cell = iota - gstart[layout.sorted_cell]
    cstart_ext = torch.cat([layout.cstart_rel, used[:, None]], dim=1)  # [C, G + 1]

    # The padded coordinate table; the z-wrap copies carry pre-shifted z.
    flat = num_cols * ccp_s
    c_pre_i, m_i = c_pre[sorted_col], used[sorted_col]
    dst_main = torch.where(r_col < torch.clamp(m_i, max=cc),
                           sorted_col * ccp_s + c_pre_i + r_col, flat)
    dst_pre = torch.where((sorted_cz == g - 1) & (r_cell < wrap),
                          sorted_col * ccp_s + r_cell, flat)
    dst_app = torch.where((sorted_cz == 0) & (r_cell < wrap) & (r_col < cc),
                          sorted_col * ccp_s + c_pre_i + m_i + r_cell, flat)
    planes = []
    for d in range(3):
        vals = sorted_pos[:, d]
        plane = torch.full((flat + 1,), 4.0, device=dev) * box
        plane[dst_main] = vals
        plane[dst_pre] = vals - box if d == 2 else vals
        plane[dst_app] = vals + box if d == 2 else vals
        planes.append(plane[:flat].reshape(num_cols, ccp_s))
    table = torch.stack(planes, dim=1).contiguous()

    # Dense query tiles: column col packs ceil(used / QB_s) tiles at its
    # prefix offset; tiles past the used ones are dead.
    tiles_per_col = -(-used // qb_s)
    tile_ofs = torch.cat([tiles_per_col.new_zeros(1), torch.cumsum(tiles_per_col, 0)])
    t = torch.arange(t_bound, device=dev)
    live = t < tile_ofs[-1]
    tile_col = torch.where(live, torch.searchsorted(tile_ofs[1:], t, right=True), 0)
    tile_row0 = torch.where(live, (t - tile_ofs[tile_col]) * qb_s, 0)
    abs0 = col_start[tile_col] + tile_row0
    rows_t = torch.where(live, torch.clamp(used[tile_col] - tile_row0, 0, qb_s), 0)
    cz_ext = torch.cat([sorted_cz, sorted_cz.new_zeros(1)])
    has_rows = rows_t > 0
    z_lo = torch.where(has_rows, cz_ext[torch.clamp(abs0, 0, n)], 0)
    z_hi = torch.where(has_rows, cz_ext[torch.clamp(abs0 + torch.clamp(rows_t, min=1) - 1,
                                                    0, n)], 0)
    q_dst = torch.where(r_col < cc,
                        (tile_ofs[sorted_col] + r_col // qb_s) * qb_s + r_col % qb_s,
                        t_bound * qb_s)
    queries = sorted_pos.new_zeros((t_bound * qb_s + 1, 3))
    queries[q_dst] = sorted_pos
    queries = queries[:-1].contiguous()

    # Per (tile, ring column) windows into the padded columns.
    dxy = torch.arange(9, device=dev)
    ax = (tile_col // g)[:, None] + dxy // 3 - 1
    ay = (tile_col % g)[:, None] + dxy % 3 - 1
    cj = (ax % g) * g + ay % g
    sx = torch.where(ax < 0, -1, torch.where(ax >= g, 1, 0))
    sy = torch.where(ay < 0, -1, torch.where(ay >= g, 1, 0))
    cp_j, m_j, ca_j = c_pre[cj], used[cj], c_app[cj]
    ce = cstart_ext[cj]  # [T, 9, G + 1]

    def at(z):
        return torch.gather(ce, 2, z[:, None, None].expand(-1, 9, 1))[..., 0]

    start = torch.where(z_lo[:, None] >= 1, cp_j + at(torch.clamp(z_lo - 1, 0, g)), 0)
    end = torch.where(z_hi[:, None] <= g - 2, cp_j + at(torch.clamp(z_hi + 2, 0, g)),
                      cp_j + m_j + ca_j)
    fl = torch.clamp(start // _LANE * _LANE, 0, ccp_s - w_eff)
    truncated = torch.where(live[:, None], torch.clamp(end - fl - w_eff, min=0), 0).sum()
    cols = torch.arange(num_cols, device=dev)
    wrap_hidden = (torch.clamp(gstart[(cols + 1) * g] - gstart[cols * g + g - 1] - wrap, min=0).sum()
                   + torch.clamp(gstart[cols * g + 1] - gstart[cols * g] - wrap, min=0).sum())
    windows = torch.stack([cj, fl, sx, sy], dim=-1).to(torch.int32).contiguous()
    return DenseSearch(table=table, queries=queries, windows=windows, tile_col=tile_col,
                       tile_row0=tile_row0, rows=rows_t.to(torch.int32), abs0=abs0,
                       window_overflow=truncated + wrap_hidden, w_eff=w_eff, ccp=ccp_s)


_NO_PICK = 2**30


def dense_offsets(lanes: torch.Tensor, kth: torch.Tensor, ds: DenseSearch,
                  layout: CellBlockLayout, spec: CellBlockSpec):
    """Rebase K8's window lanes (the JAX ``_dense_search_offsets`` after its
    kernel call). Returns ``(offsets [num_slots, k] int16, picks
    [num_slots, k] int64, kth_sorted [N] float32)``: each pick's S lane in
    its slot's aggregation tile (``9W + 1`` where that window misses it, a
    dropped edge; ``9W`` for no pick), its absolute padded row
    ``j * ccp + row`` (``2**30`` for none), and each sorted row's k-th
    squared distance (``-1e30`` for rows no search tile holds)."""
    cc, qb, w_cap = spec.col_capacity, spec.query_block, spec.window
    num_slots, width = spec.num_slots, spec.s_width
    t_bound = ds.windows.shape[0]
    k = lanes.shape[1]
    qb_s = lanes.shape[0] // t_bound
    n = layout.order.shape[0]
    dev = lanes.device
    codes = lanes.long().view(t_bound, qb_s * k)
    j_t = codes // ds.w_eff  # 9 for the no-pick sentinel
    fl = torch.gather(ds.windows[..., 1].long(), 1, torch.clamp(j_t, max=8))
    code_abs = torch.where(j_t < 9, j_t * ds.ccp + fl + codes - j_t * ds.w_eff, _NO_PICK)
    row_i = torch.arange(qb_s, device=dev)
    row_ok = row_i < ds.rows[:, None]  # [T, QB_s]
    slot_dst = torch.where(row_ok, ds.tile_col[:, None] * cc + ds.tile_row0[:, None] + row_i,
                           num_slots).reshape(-1)
    picks = torch.full((num_slots + 1, k), _NO_PICK, dtype=torch.int64, device=dev)
    picks[slot_dst] = code_abs.view(-1, k)
    picks = picks[:num_slots]
    sort_dst = torch.where(row_ok, ds.abs0[:, None] + row_i, n).reshape(-1)
    kth_sorted = torch.full((n + 1,), -1e30, dtype=torch.float32, device=dev)
    kth_sorted[sort_dst] = kth
    # Both systems are column-relative padded rows: the S lane is the plain
    # difference against the slot's aggregation-tile window start.
    w_a = layout.tile_const.long().view(-1, 9, 5)[..., 0]
    j2 = torch.clamp(picks // ds.ccp, max=9)
    tile_a = torch.arange(num_slots, device=dev) // qb
    rel = picks - j2 * ds.ccp - torch.gather(w_a[tile_a], 1, torch.clamp(j2, max=8))
    picked = picks < _NO_PICK
    ok = picked & (rel >= 0) & (rel < w_cap)
    offsets = torch.where(ok, j2 * w_cap + rel, torch.where(picked, width + 1, width))
    return offsets.to(torch.int16), picks, kth_sorted[:n]


def dense_sender_packs(offsets: torch.Tensor, picks: torch.Tensor, ccp: int,
                       layout: CellBlockLayout, spec: CellBlockSpec) -> torch.Tensor:
    """Each slot's sender packs ``col * CC + rank`` ``[num_slots, k]`` int32
    on the dense path (``num_slots`` where S holds no edge), by decoding each
    pick's padded row against its sender column's ``[cP | main | cA]``
    segments (JAX ``build_cellblock``'s dense ``with_reverse`` branch)."""
    cc, qb = spec.col_capacity, spec.query_block
    num_slots = spec.num_slots
    tile_a = torch.arange(num_slots, device=picks.device) // qb
    j2 = torch.clamp(picks // ccp, max=9)
    p2 = picks - j2 * ccp
    jc = torch.clamp(j2, max=8)
    const = layout.tile_const.long()[tile_a]  # [S, 45]
    col_j = (layout.window_starts.long() // spec.padded_col)[tile_a]

    def sel(table):
        return torch.where(j2 < 9, torch.gather(table, 1, jc), 0)

    col_s = sel(col_j)
    cp_s, m_s, cg1_s = (sel(const[:, i::5]) for i in (1, 2, 4))
    is_pre = p2 < cp_s
    is_main = ~is_pre & (p2 < cp_s + m_s)
    rank = torch.where(is_pre, cg1_s + p2, torch.where(is_main, p2 - cp_s, p2 - cp_s - m_s))
    ok = (offsets.long() < spec.s_width) & (rank >= 0) & (rank < cc)
    return torch.where(ok, col_s * cc + rank, num_slots).to(torch.int32)


def build_cellblock(
    positions: torch.Tensor,
    neighbors,
    box_size,
    spec: CellBlockSpec,
    with_reverse: bool = False,
    s_build: str = "kernel",
    neighbor_codes: Optional[torch.Tensor] = None,
    codes_cap: Optional[int] = None,
    codes_spill: Optional[tuple] = None,
    valid=None,
    codes_layout: str = "particle",
    dense_search: Optional[DenseSearchSpec] = None,
    num_neighbors: Optional[int] = None,
) -> CellBlockGraph:
    """Build the per-graph plan: layout, S table and, with
    ``with_reverse=True`` (training), the reverse table K7 and
    ``reverse_mismatch``. ``positions`` ``[N, 3]`` are wrapped, in original
    particle order. Three routes to S's offsets, then K3 (the JAX package's
    ``s_build="kernel"``):

    * codes (``neighbor_codes``, ``codes_cap``, ``codes_spill``): what
      ``pallas_cell_list_knn(..., with_codes=True)`` returned on the SAME
      grid size as ``spec.grid_size``, decoded by K2. Wins when ``neighbors``
      is passed too, as in JAX.
    * aux (``neighbors [N, k]`` alone, from any search on any grid): each
      sender's packed slot and z-cell through the neighbor table, placed by
      ``aux_offsets``.
    * dense (``dense_search=DenseSearchSpec``, ``num_neighbors=k``, no
      neighbors or codes): the fused dense-query search K8 over the plan's
      own padded columns; the plan then also carries ``search_excess`` and
      ``search_window_overflow``.

    The cubic layouts, uniform and variable, and the halo slab (the dense
    search takes the uniform cubic layout only, and the codes route the
    cubic periodic grid only, as in JAX). ``valid`` ``[N]`` bool: rows
    marked False (padding rows of a halo shard's candidate set) take no
    slot, sit in no window and are not counted in ``overflow``; senders
    named in ``neighbors`` must be valid rows, and entries ``>= N`` name no
    sender. On a slab (``spec.grid_x``) ``box_size`` may be a per-dimension
    ``[3]`` extent, positions in the local frame ``[0, box_d)``; with
    ``periodic_x=False`` every query (a row with real neighbor entries)
    sits at least one x-layer inside the slab.

    ``codes_layout="table"``: ``neighbor_codes`` is K1''s cell-table output
    ``[G^3 * codes_cap, k]`` (``pallas_cell_list_knn(..., codes_layout=
    "table")``) and ``codes_spill`` its three-element spill info, the
    spilled queries' picks last; K2 reads each slot's row through one
    quasi-monotone row map (``codes_rows``). No entry point takes it (the
    JAX rollout keeps it off, a measured negative on the TPU).
    """
    if (neighbor_codes is None) != (codes_cap is None):
        raise ValueError("neighbor_codes and codes_cap go together")
    if s_build != "kernel":
        raise NotImplementedError(f"s_build={s_build!r} is not ported (only 'kernel')")
    if codes_layout not in ("particle", "table"):
        raise ValueError(f"unknown codes_layout: {codes_layout}")
    if codes_layout == "table":
        if neighbor_codes is None:
            raise ValueError("codes_layout='table' requires neighbor_codes")
        if codes_spill is not None and len(codes_spill) != 3:
            raise ValueError("codes_layout='table' needs the k-NN's 3-element spill info "
                             "(cells, ranks, solved picks)")
        expected_rows = spec.num_columns * spec.grid_size * codes_cap
        if neighbor_codes.shape[0] != expected_rows:
            raise ValueError(f"table-layout codes have {neighbor_codes.shape[0]} rows, "
                             f"expected G^3*cap = {expected_rows}")
    if dense_search is not None:
        dense_search.validate()
        if num_neighbors is None:
            raise ValueError("dense_search requires num_neighbors")
        if neighbors is not None or neighbor_codes is not None:
            raise ValueError("dense_search replaces the neighbor search: pass "
                             "neighbors=None without codes")
        if spec.variable or spec.grid_x or not spec.periodic_x:
            raise ValueError("dense_search requires the uniform cubic periodic layout")
        if valid is not None:
            raise ValueError("dense_search does not support a validity mask")
        if dense_search.window > _round_up(spec.padded_col, _LANE):
            raise ValueError(f"dense window {dense_search.window} exceeds the padded "
                             f"column {_round_up(spec.padded_col, _LANE)}")
        k = num_neighbors
    elif neighbors is None and neighbor_codes is None:
        raise ValueError("neighbors=None requires neighbor_codes")
    else:
        k = (neighbor_codes if neighbor_codes is not None else neighbors).shape[1]
    if k > 127:
        raise ValueError(f"k={k} exceeds 127 — S-table entries are int8 counts")
    if neighbor_codes is not None and (spec.grid_x or not spec.periodic_x):
        raise ValueError("the codes path requires the default cubic periodic grid (the "
                         "k-NN kernel's 27-roll candidate layout is cubic)")
    layout = cellblock_layout(positions, box_size, spec, valid)
    g, width = spec.grid_size, spec.s_width
    search_excess = search_window_overflow = packs = None
    if dense_search is not None:
        sorted_pos = positions.float()[layout.order]
        ds = dense_search_inputs(layout, sorted_pos, box_size, spec, dense_search)
        lanes, kth = dense_select(ds.table, ds.queries, ds.windows, box_size, ds.rows, k=k,
                                  query_block=dense_search.query_block, w_eff=ds.w_eff)
        offsets, picks, kth_sorted = dense_offsets(lanes, kth, ds, layout, spec)
        margin = window_margin_sq(sorted_pos, f32(box_size, positions.device),
                                  CellGrid(grid_size=g, cell_capacity=0))
        search_excess = (kth_sorted - margin).max()
        search_window_overflow = ds.window_overflow
        dropped = (offsets == width + 1).sum()
        if with_reverse:
            packs = dense_sender_packs(offsets, picks, ds.ccp, layout, spec)
    elif neighbor_codes is not None:
        offsets, dropped = s_decode(neighbor_codes, codes_spill, layout, spec, codes_cap,
                                    codes_layout)
        if with_reverse:
            sc = slot_codes(layout, neighbor_codes, codes_cap, codes_spill, spec, codes_layout)
            packs = sender_packs(sc, layout, codes_cap, spec)
    else:
        senders = aux_slot_senders(layout, neighbors, spec)
        offsets, dropped = aux_offsets(senders, layout, spec)
        if with_reverse:
            packs = (senders // g).to(torch.int32)
    s_rev_table = reverse_mismatch = None
    if with_reverse:
        # The certificate from the two kernels' own edge counts.
        s_table, s_total = s_onehot(offsets, width=width, with_total=True)
        s_rev_table, rev_total = reverse_table(packs, layout, spec)
        reverse_mismatch = s_total - rev_total
    else:
        s_table = s_onehot(offsets, width=width)
    return CellBlockGraph(
        order=layout.order,
        slot_of_sorted=layout.slot_of_sorted,
        particle_of_slot=layout.particle_of_slot,
        pad_src=layout.pad_src,
        window_starts=layout.window_starts,
        s_table=s_table,
        overflow=layout.overflow,
        dropped_edges=dropped,
        window_overflow=layout.window_overflow,
        s_rev_table=s_rev_table,
        reverse_mismatch=reverse_mismatch,
        search_excess=search_excess,
        search_window_overflow=search_window_overflow,
    )


# ---------------------------------------------------------------------------
# K2: codes -> S-lane offsets
# ---------------------------------------------------------------------------


def s_decode_reference(codes, qz_slot, cstart27, tile_const, slot_col, *, spec: CellBlockSpec,
                       codes_cap: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (the Pallas ``_s_from_codes_fused``'s
    decode). Per slot ``s`` and pick ``p`` of the pre-normalized
    ``codes [num_slots, k]`` int32, with the slot's query z-cell
    ``qz_slot [num_slots]``, the neighbor-cell start table
    ``cstart27 [G^3, 27]``, the tile constants ``tile_const [T, 45]`` and
    each slot's column ``slot_col [num_slots]`` (``layout.slot_col``):
    the S lane ``j * W + off`` of the sender in the query tile's window, or
    the sentinel ``9W + 1`` for a dropped edge (a real sender S cannot
    represent) and ``9W`` for no edge. Returns ``[num_slots, k]`` int16."""
    g, cc, qb, w_cap = spec.grid_size, spec.col_capacity, spec.query_block, spec.window
    width = spec.s_width
    dev = codes.device
    num_slots = codes.shape[0]
    res_base = 27 * codes_cap
    ccg = cc * g
    drop_mark = res_base + 9 * ccg
    codes = codes.long()
    slots = torch.arange(num_slots, device=dev)
    qz = qz_slot.long()[:, None]
    col_q = slot_col
    s27 = cstart27.long()[col_q * g + qz_slot.long()]  # [S, 27]
    const = tile_const.long()[slots // qb]  # [S, 45]

    is_res = codes >= res_base
    cr = torch.where(is_res, 0, codes)
    j27 = cr // codes_cap
    rank = cr - j27 * codes_cap
    r_ring = torch.gather(s27, 1, j27) + rank
    cz_ring = (qz + j27 % 3 - 1 + g) % g
    j_ring = (j27 // 9) * 3 + (j27 // 3) % 3
    v = torch.where(is_res, codes - res_base, 0)
    jr2 = v // ccg
    rem = v - jr2 * ccg
    r2 = rem // g
    cz2 = rem - r2 * g
    ok2 = jr2 < 9
    is_drop = codes == drop_mark
    r_s = torch.where(is_res, r2, r_ring)
    s_cz = torch.where(is_res, cz2, cz_ring)
    jring = torch.where(is_res, torch.where(ok2, jr2, 9), j_ring)
    ok = (is_res & ok2) | ~is_res
    # The 5 window constants of ring column jring (0 where jring == 9).
    jc = torch.clamp(jring, max=8)
    w_s, cp_s, m_s, ca_s, cg1_s = (
        torch.where(jring < 9, torch.gather(const, 1, jc * 5 + i), 0) for i in range(5)
    )
    ok = ok & (r_s < m_s)
    rel_main = cp_s + r_s - w_s
    ok_main = ok & (rel_main >= 0) & (rel_main < w_cap)
    rank_pre = r_s - cg1_s
    rel_pre = rank_pre - w_s
    ok_pre = ok & (s_cz == g - 1) & (rank_pre < cp_s) & (rel_pre >= 0) & (rel_pre < w_cap)
    rel_app = cp_s + m_s + r_s - w_s
    ok_app = ok & (s_cz == 0) & (r_s < ca_s) & (rel_app >= 0) & (rel_app < w_cap)
    off = torch.where(ok_main, rel_main, torch.where(ok_pre, rel_pre, rel_app))
    valid = ok_main | ok_pre | ok_app
    dropped_e = (ok & ~valid) | is_drop
    out = torch.where(valid, jring * w_cap + off,
                      torch.where(dropped_e, width + 1, width))
    return out.to(torch.int16)


@functools.cache
def _lib(name: str):
    lib = kernels.library(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "s_decode":
        entries = {"s_decode_launch": [p] * 12 + [i] * 11 + [p]}
    elif name == "s_onehot":
        entries = {"s_onehot_launch": [p, p, p, i, i, i, p]}
    elif name == "reverse_table":
        entries = {"reverse_table_launch": [p] * 8 + [i] * 6 + [p]}
    elif name == "dense_select":
        entries = {"dense_select_launch": [p] * 4 + [i] * 5 + [ctypes.c_float] + [p] * 3}
    else:
        entries = {"window_matmul_launch": [p] * 4 + [i] * 7 + [p],
                   "window_matmul_t_launch": [p] * 4 + [i] * 7 + [p]}
    for entry, argtypes in entries.items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = i
    return lib


def _check(name: str, device, tensors) -> None:
    for label, t, shape, dtype in tensors:
        if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {label} must be a contiguous {dtype} {tuple(shape)} tensor "
                f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def s_decode(neighbor_codes: torch.Tensor, codes_spill, layout: CellBlockLayout,
             spec: CellBlockSpec, codes_cap: int, codes_layout: str = "particle"):
    """K2: the k-NN codes -> ``(offsets [num_slots, k] int16, dropped)``:
    each slot's S-lane offsets (``s_decode_reference`` of
    ``s_decode_inputs``) and the int32 count of dropped edges (offsets
    ``9W + 1``). The codes are those of ``pallas_cell_list_knn(...,
    codes_only=True)`` with its spill tables ``codes_spill`` (or None):
    ``[N, k]`` in particle order, or with ``codes_layout="table"`` K1''s
    cell-table output ``[G^3 * cap, k]`` and the spill picks as the tables'
    third element. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/s_decode.cu``, which reads each slot's codes row through the row
    map ``codes_rows`` (table rows, then the spill picks' rows: no copy of
    the two), resolves and normalizes the codes and finds each neighbor
    cell's start itself, or raise."""
    width = spec.s_width
    if neighbor_codes.device.type == "cpu":
        offsets = s_decode_reference(
            *s_decode_inputs(layout, neighbor_codes, codes_cap, codes_spill, spec,
                             codes_layout), spec=spec, codes_cap=codes_cap)
        return offsets, (offsets == width + 1).sum(dtype=torch.int32)
    num_rows, k = neighbor_codes.shape
    n = layout.order.shape[0]
    g, num_slots = spec.grid_size, spec.num_slots
    if width + 2 >= 2**15:
        raise ValueError(f"s_decode writes int16 offsets; S width {width} too wide")
    dev = neighbor_codes.device
    spill_len = 0 if codes_spill is None else codes_spill[0].shape[0]
    picks = codes_spill[2] if codes_layout == "table" and spill_len else None
    num_picks = 0 if picks is None else picks.shape[0]
    rows = codes_rows(layout, codes_spill, codes_cap, spec, codes_layout)
    tensors = [
        ("neighbor_codes", neighbor_codes, (num_rows, k), torch.int32),
        ("particle_of_slot", layout.particle_of_slot, (num_slots,), torch.int64),
        ("codes_rows", rows, (n,), torch.int64),
        ("sorted_cz", layout.sorted_cz, (n,), torch.int64),
        ("cstart_rel", layout.cstart_rel, (spec.num_columns, g), torch.int64),
        ("tile_const", layout.tile_const, (spec.num_tiles, 45), torch.int32),
        ("tile_col", layout.tile_col, (spec.num_tiles,), torch.int32),
    ]
    if spill_len:
        tensors += [("spill_cells", codes_spill[0], (spill_len,), torch.int32),
                    ("spill_ranks", codes_spill[1], (spill_len,), torch.int32)]
    if picks is not None:
        tensors.append(("spill_picks", picks, (num_picks, k), torch.int32))
    _check("s_decode", dev, tensors)
    offsets = torch.empty((num_slots, k), dtype=torch.int16, device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    err = _lib("s_decode").s_decode_launch(
        kernels.ptr(neighbor_codes), kernels.ptr(picks),
        kernels.ptr(codes_spill[0] if spill_len else None),
        kernels.ptr(codes_spill[1] if spill_len else None), kernels.ptr(layout.particle_of_slot),
        kernels.ptr(rows), kernels.ptr(layout.sorted_cz), kernels.ptr(layout.cstart_rel),
        kernels.ptr(layout.tile_const), kernels.ptr(layout.tile_col), kernels.ptr(offsets),
        kernels.ptr(dropped), spec.num_tiles, n, k, num_rows, num_picks, spill_len, g,
        spec.col_capacity, spec.query_block, spec.window, codes_cap, kernels.stream_handle(dev),
    )
    kernels.check("s_decode", err)
    kernels.launches["s_decode"] += 1
    return offsets, dropped


# ---------------------------------------------------------------------------
# K3: offsets -> int8 S rows
# ---------------------------------------------------------------------------


def s_onehot_reference(offsets: torch.Tensor, *, width: int) -> torch.Tensor:
    """Plain PyTorch version of K3 (the Pallas ``_s_from_offsets``):
    ``S[row, lane]`` = how many of the row's offsets equal ``lane``, for
    lanes in ``[0, width)`` (offsets outside it are ignored). int8."""
    rows, k = offsets.shape
    off = offsets.long()
    keep = (off >= 0) & (off < width)
    flat = torch.where(keep, off + width * torch.arange(rows, device=off.device)[:, None],
                       rows * width)
    s = torch.zeros(rows * width + 1, dtype=torch.int32, device=off.device)
    s.index_add_(0, flat.reshape(-1), torch.ones(rows * k, dtype=torch.int32,
                                                 device=off.device))
    return s[:-1].reshape(rows, width).to(torch.int8)


def s_onehot(offsets: torch.Tensor, *, width: int, with_total: bool = False):
    """K3: int8 S rows of multiplicity counts from per-row lane offsets (see
    ``s_onehot_reference``; ``k <= 127``, so counts fit int8). With
    ``with_total`` it returns ``(S, s_total)``, ``s_total`` the int32 count
    of the offsets in ``[0, width)``, which is S's sum (the training path's
    half of ``reverse_mismatch``). CPU tensors take the plain version; CUDA
    tensors launch ``csrc/s_onehot.cu`` (the count inside it) or raise."""
    if offsets.device.type == "cpu":
        s_table = s_onehot_reference(offsets, width=width)
        if not with_total:
            return s_table
        return s_table, ((offsets >= 0) & (offsets < width)).sum(dtype=torch.int32)
    rows, k = offsets.shape
    if k > 127 or width % 8:
        raise ValueError(f"s_onehot kernel takes k <= 127 and width % 8 == 0, "
                         f"got k={k}, width={width}")
    _check("s_onehot", offsets.device, [("offsets", offsets, (rows, k), torch.int16)])
    out = torch.empty((rows, width), dtype=torch.int8, device=offsets.device)
    total = torch.zeros((), dtype=torch.int32, device=offsets.device) if with_total else None
    err = _lib("s_onehot").s_onehot_launch(
        kernels.ptr(offsets), kernels.ptr(out), kernels.ptr(total), rows, k, width,
        kernels.stream_handle(offsets.device),
    )
    kernels.check("s_onehot", err)
    kernels.launches["s_onehot"] += 1
    return (out, total) if with_total else out


# ---------------------------------------------------------------------------
# K7: the reverse table
# ---------------------------------------------------------------------------

# Query tiles per chunk of the plain window matmuls and reverse table
# (bounds their gathered [tiles, W, ...] windows).
_PLAIN_TILES = 64


def reverse_table_reference(packed: torch.Tensor, window_starts: torch.Tensor,
                            tile_pack_base: torch.Tensor, window_lims: torch.Tensor, *,
                            spec: CellBlockSpec) -> torch.Tensor:
    """Plain PyTorch version of K7 (the Pallas ``_reverse_table_kernel``):
    ``S_rev [num_tiles, 9W, rev_lanes]`` int8, where entry ``(t, j*W + p,
    q)`` counts the senders ``base[t] + q`` in the neighbor list of padded
    row ``window_starts[t, j] + p`` of ``packed [num_padded, k + 1]`` (see
    ``reverse_candidates``), if that row speaks for its particle: it is the
    particle's main image, or the main image lies outside the window; and
    ``p < window_lims[t, j]``; ``base`` is ``tile_pack_base`` (the layout's
    ``window_starts``, ``tile_pack_base`` and ``window_lims``)."""
    qb, w, lanes = spec.query_block, spec.window, spec.rev_lanes
    num_tiles = window_starts.shape[0]
    k = packed.shape[1] - 1
    dev = packed.device
    offs = torch.arange(w, device=dev)
    out = torch.empty((num_tiles, 9 * w, lanes), dtype=torch.int8, device=dev)
    for t0 in range(0, num_tiles, _PLAIN_TILES):
        t1 = min(t0 + _PLAIN_TILES, num_tiles)
        starts = window_starts[t0:t1].long()[:, :, None]  # [T, 9, 1]
        rows = starts + offs  # [T, 9, W]
        win = packed[rows].long()  # [T, 9, W, k + 1]
        main = win[..., k]
        canonical = ((main == rows) | (main < starts) | (main >= starts + w)) \
            & (offs < window_lims[t0:t1].long()[:, :, None])
        base = tile_pack_base[t0:t1].long()
        local = win[..., :k] - base[:, None, None, None]
        ok = canonical[..., None] & (local >= 0) & (local < qb)
        row_ids = torch.arange((t1 - t0) * 9 * w, device=dev).view(t1 - t0, 9, w, 1)
        size = (t1 - t0) * 9 * w * lanes
        flat = torch.where(ok, row_ids * lanes + local, size)
        counts = torch.zeros(size + 1, dtype=torch.int32, device=dev)
        counts.index_add_(0, flat.reshape(-1), torch.ones(flat.numel(), dtype=torch.int32,
                                                          device=dev))
        out[t0:t1] = counts[:-1].view(t1 - t0, 9 * w, lanes).to(torch.int8)
    return out


def reverse_table(packs: torch.Tensor, layout: CellBlockLayout, spec: CellBlockSpec):
    """K7: the reverse selection table and its edge total from each slot's
    sender packs ``packs [num_slots, k]`` int32 (``sender_packs``,
    ``dense_sender_packs``, or the aux senders' packs; ``pack_slots`` for no
    sender): ``(S_rev [num_tiles, 9W, rev_lanes] int8, rev_total)``,
    ``reverse_table_reference`` of ``reverse_candidates`` and the int32 sum
    of its counts (``k <= 127``, so counts fit int8). CPU tensors take the
    plain version; CUDA tensors launch ``csrc/reverse_table.cu``, which
    reads ``packs`` through ``layout.pad_src`` and computes the main-image
    rows itself from ``layout.main_base``, with the tiles' pack bases and
    the windows' limits, or raise."""
    num_slots, k = packs.shape
    if packs.device.type == "cpu":
        s_rev = reverse_table_reference(reverse_candidates(packs, layout, spec),
                                        layout.window_starts, layout.tile_pack_base,
                                        layout.window_lims, spec=spec)
        return s_rev, s_rev.sum(dtype=torch.int32)
    lanes = spec.rev_lanes
    if not 1 <= k <= 127:
        raise ValueError(f"reverse_table kernel takes 1 <= k <= 127, got k={k}")
    dev = packs.device
    tensors = [
        ("packs", packs, (spec.num_slots, k), torch.int32),
        ("pad_src", layout.pad_src, (spec.num_padded,), torch.int64),
        ("window_starts", layout.window_starts, (spec.num_tiles, 9), torch.int32),
        ("tile_pack_base", layout.tile_pack_base, (spec.num_tiles,), torch.int32),
        ("window_lims", layout.window_lims, (spec.num_tiles, 9), torch.int32),
        ("main_base", layout.main_base, (spec.num_tiles, 9), torch.int32),
    ]
    _check("reverse_table", dev, tensors)
    out = torch.empty((spec.num_tiles, spec.s_width, lanes), dtype=torch.int8, device=dev)
    total = torch.zeros((), dtype=torch.int32, device=dev)
    err = _lib("reverse_table").reverse_table_launch(
        kernels.ptr(packs), kernels.ptr(layout.pad_src), kernels.ptr(layout.window_starts),
        kernels.ptr(layout.tile_pack_base), kernels.ptr(layout.window_lims),
        kernels.ptr(layout.main_base), kernels.ptr(out), kernels.ptr(total),
        spec.num_tiles, num_slots, spec.query_block, spec.window, k, lanes,
        kernels.stream_handle(dev),
    )
    kernels.check("reverse_table", err)
    kernels.launches["reverse_table"] += 1
    return out, total


# ---------------------------------------------------------------------------
# K8: the dense-query selection
# ---------------------------------------------------------------------------

# Search tiles per chunk of K8's plain version (bounds its [tiles, QB_s,
# 9 * w_eff] distance table).
_DENSE_PLAIN_TILES = 128
# K8's kth for a padding row (no pick).
_DENSE_NO_KTH = 1e30


def dense_select_reference(table, queries, windows, box_size, *, k: int, query_block: int,
                           w_eff: int):
    """Plain PyTorch version of K8 (the Pallas ``_dense_select_kernel``).
    Per tile ``t`` of ``query_block`` rows of ``queries [T * QB_s, 3]``: the
    candidates are the 9 windows of ``w_eff`` rows of ``table [C, 3, ccp]``
    at column ``windows[t, j, 0]`` from row ``windows[t, j, 1]``, x and y
    shifted by ``windows[t, j, 2:4] * box`` (one exact product, one f32
    add), lane ``j * w_eff + row``; ``d^2 = ((dx^2 + dy^2) + dz^2)`` of the
    plain differences. Returns ``(lanes [T * QB_s, k] int32, kth [T * QB_s]
    float32)``: the k smallest ``(d^2, lane)`` pairs in ascending order (the
    smallest lane wins ties) and the k-th ``d^2``."""
    num_tiles = windows.shape[0]
    qb, num_cand = query_block, 9 * w_eff
    dev = table.device
    box = f32(box_size, dev)
    rows = torch.arange(w_eff, device=dev)
    lanes = torch.empty((num_tiles * qb, k), dtype=torch.int32, device=dev)
    kth = torch.empty((num_tiles * qb,), dtype=torch.float32, device=dev)
    for t0 in range(0, num_tiles, _DENSE_PLAIN_TILES):
        t1 = min(t0 + _DENSE_PLAIN_TILES, num_tiles)
        win = windows[t0:t1].long()
        idx = win[..., 1:2] + rows  # [Tc, 9, w_eff]
        col = win[..., 0:1].expand_as(idx)
        cand = [table[col, d, idx] for d in range(3)]
        cand[0] = cand[0] + win[..., 2:3].float() * box
        cand[1] = cand[1] + win[..., 3:4].float() * box
        q = queries[t0 * qb:t1 * qb].view(t1 - t0, qb, 3)
        d2 = None
        for d in range(3):
            delta = q[..., d:d + 1] - cand[d].reshape(t1 - t0, 1, num_cand)
            d2 = delta * delta if d2 is None else d2 + delta * delta
        d2_sorted, order = torch.sort(d2, dim=-1, stable=True)
        lanes[t0 * qb:t1 * qb] = order[..., :k].reshape(-1, k).to(torch.int32)
        kth[t0 * qb:t1 * qb] = d2_sorted[..., k - 1].reshape(-1)
    return lanes, kth


def dense_select(table, queries, windows, box_size, rows, *, k: int, query_block: int,
                 w_eff: int):
    """K8: the dense-query k-selection over 9 column windows (see
    ``dense_select_reference``; ``k <= 9 * w_eff``; ``box_size`` a host
    number) for each tile's live rows: ``rows`` ``[T]`` (the plan's
    ``DenseSearch.rows``) says how many; a tile's rows from ``rows[t]`` on
    are padding, not searched, and get lane ``9 * w_eff`` and kth 1e30.
    The live rows are the plain version's. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/dense_select.cu`` or raise."""
    num_tiles = windows.shape[0]
    if not 1 <= k <= min(9 * w_eff, 128):
        raise ValueError(f"dense_select takes 1 <= k <= min(9 * w_eff, 128), got {k}")
    if table.device.type == "cpu":
        lanes, kth = dense_select_reference(table, queries, windows, box_size, k=k,
                                            query_block=query_block, w_eff=w_eff)
        pad = (torch.arange(query_block) >= rows[:, None]).reshape(-1)
        return (torch.where(pad[:, None], 9 * w_eff, lanes).to(torch.int32),
                torch.where(pad, _DENSE_NO_KTH, kth))
    ccp = table.shape[2]
    _check("dense_select", table.device, [
        ("table", table, (table.shape[0], 3, ccp), torch.float32),
        ("queries", queries, (num_tiles * query_block, 3), torch.float32),
        ("windows", windows, (num_tiles, 9, 4), torch.int32),
        ("rows", rows, (num_tiles,), torch.int32),
    ])
    lanes = torch.empty((num_tiles * query_block, k), dtype=torch.int32, device=table.device)
    kth = torch.empty((num_tiles * query_block,), dtype=torch.float32, device=table.device)
    err = _lib("dense_select").dense_select_launch(
        kernels.ptr(table), kernels.ptr(queries), kernels.ptr(windows), kernels.ptr(rows),
        num_tiles, query_block, w_eff, ccp, k, ctypes.c_float(host_f32(box_size)),
        kernels.ptr(lanes), kernels.ptr(kth), kernels.stream_handle(table.device),
    )
    kernels.check("dense_select", err)
    kernels.launches["dense_select"] += 1
    return lanes, kth


# ---------------------------------------------------------------------------
# Slot space (monotone row gathers both ways) and K4, the window matmul
# ---------------------------------------------------------------------------


class _Expand(torch.autograd.Function):
    """Sorted rows -> slots; the backward gathers by ``slot_of_sorted``."""

    @staticmethod
    def forward(ctx, x_sorted, particle_of_slot, slot_of_sorted):
        ctx.save_for_backward(slot_of_sorted)
        x_ext = torch.cat([x_sorted, x_sorted.new_zeros((1, x_sorted.shape[1]))])
        return x_ext.index_select(0, particle_of_slot)

    @staticmethod
    def backward(ctx, gr):
        (slot_of_sorted,) = ctx.saved_tensors
        g_ext = torch.cat([gr, gr.new_zeros((1, gr.shape[1]))])
        return g_ext.index_select(0, slot_of_sorted), None, None


class _Compact(torch.autograd.Function):
    """Slots -> sorted rows; the backward gathers by ``particle_of_slot``."""

    @staticmethod
    def forward(ctx, x_slots, particle_of_slot, slot_of_sorted):
        ctx.save_for_backward(particle_of_slot)
        idx = torch.clamp(slot_of_sorted, max=x_slots.shape[0] - 1)
        return x_slots.index_select(0, idx)

    @staticmethod
    def backward(ctx, gr):
        (particle_of_slot,) = ctx.saved_tensors
        g_ext = torch.cat([gr, gr.new_zeros((1, gr.shape[1]))])
        return g_ext.index_select(0, particle_of_slot), None, None


def expand_to_slots(x_sorted: torch.Tensor, plan: CellBlockGraph, dtype=None) -> torch.Tensor:
    """``[N, F]`` cell-sorted rows -> ``[num_slots, F]``; empty slots zero.
    A monotone row gather both ways: the backward gathers the slot rows
    back by ``slot_of_sorted`` (never an ``index_add``)."""
    if dtype is not None:
        x_sorted = x_sorted.to(dtype)
    return _Expand.apply(x_sorted, plan.particle_of_slot, plan.slot_of_sorted)


def compact_from_slots(x_slots: torch.Tensor, plan: CellBlockGraph) -> torch.Tensor:
    """``[num_slots, F]`` -> ``[N, F]`` cell-sorted rows (the overflow
    sentinel clamps to the last slot, as JAX's clip gather — flagged by
    ``plan.overflow``); the backward gathers by ``particle_of_slot``."""
    return _Compact.apply(x_slots, plan.particle_of_slot, plan.slot_of_sorted)


def _pad_candidates(z_slots: torch.Tensor, pad_src: torch.Tensor, carry_dtype) -> torch.Tensor:
    """Slot rows -> the z-wrap padded candidate image (one row gather)."""
    z = z_slots.to(carry_dtype)
    z_ext = torch.cat([z, z.new_zeros((1, z.shape[1]))])
    return z_ext.index_select(0, pad_src)


def window_matmul_reference(s_table, z_pad, window_starts, *, spec: CellBlockSpec) -> torch.Tensor:
    """Plain PyTorch version of K4: per query tile ``t``,
    ``out[t*QB:(t+1)*QB] = sum_j S_j @ z_pad[start[t, j] : +W]`` with
    ``S_j = s_table[rows, j*W:(j+1)*W]`` taken in ``z_pad``'s dtype (exact
    for int8 counts) and products and sums in float32. Returns
    ``[num_slots, H]`` float32."""
    qb, w = spec.query_block, spec.window
    s = s_table.view(window_starts.shape[0], qb, 9, w)
    return _window_products(lambda t0, t1, j: s[t0:t1, :, j, :], z_pad, window_starts, spec)


def window_matmul_t_reference(s_rev, g_pad, window_starts, *, spec: CellBlockSpec) -> torch.Tensor:
    """Plain PyTorch version of K4^T (the TPU kernel's ``s_rev3`` mode): per
    tile ``t``, ``out[t*QB:(t+1)*QB] = sum_j S_rev[t, j*W:(j+1)*W, :QB]^T @
    g_pad[start[t, j] : +W]``, products and sums in float32. Returns
    ``[num_slots, H]`` float32."""
    qb, w = spec.query_block, spec.window
    return _window_products(lambda t0, t1, j: s_rev[t0:t1, j * w:(j + 1) * w, :qb].transpose(1, 2),
                            g_pad, window_starts, spec)


def _window_products(s_block, z_pad, window_starts, spec):
    """``sum_j s_block(t0, t1, j) @ window_j`` per chunk of tiles."""
    qb, w = spec.query_block, spec.window
    num_tiles = window_starts.shape[0]
    h = z_pad.shape[1]
    lanes = torch.arange(w, device=z_pad.device)
    out = torch.empty((num_tiles, qb, h), dtype=torch.float32, device=z_pad.device)
    for t0 in range(0, num_tiles, _PLAIN_TILES):
        t1 = min(t0 + _PLAIN_TILES, num_tiles)
        acc = torch.zeros((t1 - t0, qb, h), dtype=torch.float32, device=z_pad.device)
        for j in range(9):
            sj = s_block(t0, t1, j).to(z_pad.dtype).float()
            rows = window_starts[t0:t1, j].long()[:, None] + lanes
            acc += torch.bmm(sj, z_pad[rows].float())
        out[t0:t1] = acc
    return out.reshape(num_tiles * qb, h)


def _window_output(name, s, s_shape, z_pad, window_starts, spec):
    """Check a window matmul's inputs; allocate its ``[num_slots, H]`` f32
    output."""
    h = z_pad.shape[1]
    if z_pad.dtype != torch.bfloat16 or h % 8:
        raise ValueError(f"{name} kernel takes a bf16 candidate table with H % 8 == 0, "
                         f"got {z_pad.dtype} with H = {h}")
    if spec.query_block % 32 or spec.window % 8:
        raise ValueError(f"{name} kernel takes query_block % 32 == 0 and window % 8 == 0, "
                         f"got {spec.query_block} and {spec.window}")
    _check(name, s.device, [
        ("selection table", s, s_shape, torch.int8),
        ("candidates", z_pad, (spec.num_padded, h), torch.bfloat16),
        ("window_starts", window_starts, (spec.num_tiles, 9), torch.int32),
    ])
    return torch.empty((spec.num_slots, h), dtype=torch.float32, device=z_pad.device)


WINDOW_KERNELS = ("tiled", "persistent")


def window_kernel(h: int, w: int) -> str:
    """The CUDA kernel of ``csrc/window_matmul.cu`` that K4 and K4^T take
    for latent width ``h`` and window ``w``, by shape alone:
    ``"persistent"`` (128-row items across up to 256 columns, S read once,
    the windows of chunks with no count never loaded) wherever TMA can
    describe the operands (``w % 16 == 0`` and ``h >= 64``: every spec the
    chooser makes), else ``"tiled"`` (a block a query tile x 128 columns,
    filled by cp.async). The persistent kernel was as fast or faster at
    every measured shape (PERF.md)."""
    return "persistent" if w % 16 == 0 and h >= 64 else "tiled"


def window_matmul_launch(table, pad, window_starts, *, spec: CellBlockSpec, transpose: bool,
                         kernel: str) -> torch.Tensor:
    """Launch one kernel of ``csrc/window_matmul.cu`` (``kernel`` in
    ``WINDOW_KERNELS``) on CUDA tensors: K4 on S, or with ``transpose`` K4^T
    on S_rev. Counts nothing: ``window_matmul`` and ``window_matmul_t`` are
    the wrappers, and a caller timing the two kernels on one shape calls
    this. Raises on a refused shape or a failed launch."""
    if transpose:
        name, s_shape, lanes = "window_matmul_t", (spec.num_tiles, spec.s_width,
                                                   spec.rev_lanes), spec.rev_lanes
    else:
        name, s_shape, lanes = "window_matmul", (spec.num_slots, spec.s_width), spec.s_width
    out = _window_output(name, table, s_shape, pad, window_starts, spec)
    lib = _lib("window_matmul")
    fn = lib.window_matmul_t_launch if transpose else lib.window_matmul_launch
    err = fn(kernels.ptr(table), kernels.ptr(pad), kernels.ptr(window_starts), kernels.ptr(out),
             spec.num_tiles, spec.query_block, spec.window, pad.shape[1], pad.shape[0], lanes,
             WINDOW_KERNELS.index(kernel), kernels.stream_handle(pad.device))
    kernels.check(name, err)
    return out


def window_matmul(s_table, z_pad, window_starts, *, spec: CellBlockSpec) -> torch.Tensor:
    """K4: the cell-block aggregation in slot space (see
    ``window_matmul_reference``). CPU tensors take the plain version; CUDA
    tensors launch ``csrc/window_matmul.cu`` (bf16 ``z_pad`` with
    ``H % 8 == 0``; the kernel ``window_kernel`` picks) or raise."""
    if s_table.device.type == "cpu":
        return window_matmul_reference(s_table, z_pad, window_starts, spec=spec)
    out = window_matmul_launch(s_table, z_pad, window_starts, spec=spec, transpose=False,
                               kernel=window_kernel(z_pad.shape[1], spec.window))
    kernels.launches["window_matmul"] += 1
    return out


def window_matmul_t(s_rev, g_pad, window_starts, *, spec: CellBlockSpec) -> torch.Tensor:
    """K4^T: the aggregation's backward in slot space, ``dz = S^T g`` through
    the reverse table (see ``window_matmul_t_reference``). CPU tensors take
    the plain version; CUDA tensors launch the S^T mode of
    ``csrc/window_matmul.cu`` (bf16 ``g_pad`` with ``H % 8 == 0``; the
    kernel ``window_kernel`` picks) or raise."""
    if s_rev.device.type == "cpu":
        return window_matmul_t_reference(s_rev, g_pad, window_starts, spec=spec)
    out = window_matmul_launch(s_rev, g_pad, window_starts, spec=spec, transpose=True,
                               kernel=window_kernel(g_pad.shape[1], spec.window))
    kernels.launches["window_matmul_t"] += 1
    return out


class _AggregateSlots(torch.autograd.Function):
    """Pad + K4 forward; backward pads the cotangent in the carry dtype and
    runs K4^T over the reverse table (never a scatter through pad_src)."""

    @staticmethod
    def forward(ctx, z_slots, plan, spec, carry_dtype):
        ctx.spec, ctx.carry_dtype, ctx.z_dtype = spec, carry_dtype, z_slots.dtype
        ctx.plan = plan
        z_pad = _pad_candidates(z_slots, plan.pad_src, carry_dtype)
        return window_matmul(plan.s_table, z_pad, plan.window_starts, spec=spec)

    @staticmethod
    def backward(ctx, gr):
        plan = ctx.plan
        if plan.s_rev_table is None:
            raise ValueError(
                "the cell-block aggregation's backward needs the reverse table: "
                "build the plan with build_cellblock(..., with_reverse=True)"
            )
        g_pad = _pad_candidates(gr, plan.pad_src, ctx.carry_dtype)
        dz = window_matmul_t(plan.s_rev_table, g_pad, plan.window_starts, spec=ctx.spec)
        return dz.to(ctx.z_dtype), None, None, None


def cellblock_aggregate_slots(z_slots: torch.Tensor, plan: CellBlockGraph, spec: CellBlockSpec,
                              *, carry_dtype=torch.bfloat16) -> torch.Tensor:
    """Slot-space aggregation ``out[slot q] = sum over q's neighbor slots``,
    float32. Differentiable in ``z_slots`` when the plan carries its reverse
    table: the backward is K4^T, certified by ``plan.reverse_mismatch == 0``."""
    return _AggregateSlots.apply(z_slots, plan, spec, carry_dtype)


def cellblock_aggregate(z_sorted: torch.Tensor, plan: CellBlockGraph, spec: CellBlockSpec,
                        *, carry_dtype=torch.bfloat16) -> torch.Tensor:
    """``agg[i] = sum_j z[neighbors[i, j]]`` for cell-sorted ``[N, H]`` rows:
    expand to slots, pad, K4, compact. ``carry_dtype`` is the candidates'
    precision inside the product (sums are float32); returns float32."""
    z_slots = expand_to_slots(z_sorted, plan, dtype=carry_dtype)
    out = cellblock_aggregate_slots(z_slots, plan, spec, carry_dtype=carry_dtype)
    return compact_from_slots(out, plan)


def reference_cellblock_aggregate(z_sorted: torch.Tensor, neighbors_sorted: torch.Tensor) -> torch.Tensor:
    """Oracle: plain gather + sum over a sorted-order neighbor table."""
    return z_sorted[neighbors_sorted].sum(dim=1)


def sort_neighbors(neighbors: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Re-index a neighbor table from original to sorted particle ids: rows
    permuted by ``order``, values mapped through the inverse."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return inv[neighbors[order]]
