"""Cell-block neighbor aggregation (counterpart of ``ops/cellblock.py``):
the aggregation ``agg[i] = sum_j z[neighbors[i, j]]`` as selection-matrix
products over a periodic cell decomposition, around three CUDA kernels:

* K2 ``s_decode`` (``csrc/s_decode.cu``, the Pallas ``_s_from_codes_fused``):
  the k-NN kernel's candidate codes -> per-edge S-lane offsets;
* K3 ``s_onehot`` (``csrc/s_onehot.cu``, the Pallas ``_s_from_offsets``):
  offsets -> int8 S rows of multiplicity counts;
* K4 ``window_matmul`` (``csrc/window_matmul.cu``, the Pallas
  ``_window_kernel``): per query tile ``out = sum_j S_j @ window_j``.

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
``off`` of window ``j``.

Exact (gather-sum up to summation order) whenever ``overflow == 0`` and
``dropped_edges == 0``; both are counted, never silent.

Ported: the uniform cubic layout, the codes path of the plan build in the
particle codes layout, and the forward aggregation. Not ported (each raises
``NotImplementedError``): plans from neighbor ids (the aux path), the
reverse table and slot-space VJP (training), variable capacities, the table
codes layout, the dense search, non-cubic grids and validity masks.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.ops.binning import bucket_boundaries
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import (
    cell_coords,
    choose_cell_grid,
    f32,
)

_LANE = 128


def _round_up(x, m: int) -> int:
    return -(-int(x) // m) * m


class CellBlockSpec(NamedTuple):
    """Static cell-block configuration (the JAX ``CellBlockSpec``; only the
    uniform cubic periodic layout is ported).

    Attributes:
      grid_size:    G — cells per box edge (G^2 columns of G z-cells).
      col_capacity: CC — slot rows per column (multiple of ``query_block``).
      query_block:  QB — query rows per tile.
      window:       W — candidate rows per neighbor column per tile.
      wrap_cap:     max rows copied per z-wrap segment.
      h_block:      the TPU kernel's latent tile (kept for spec equality).
      grid_x, periodic_x, slot_budget: non-cubic / halo / variable layouts
                    (not ported; must keep their defaults).
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
        return self.num_columns * self.col_capacity

    @property
    def padded_col(self) -> int:  # rows per column in the padded image
        return self.col_capacity + 2 * self.wrap_cap

    @property
    def num_padded(self) -> int:
        return self.num_columns * self.padded_col

    @property
    def s_width(self) -> int:
        return 9 * self.window

    def validate(self) -> None:
        """The JAX spec checks of the uniform layout (the window and wrap
        alignments also fix the S lane offsets, so they stay)."""
        g, cc, qb, w, ec = (self.grid_size, self.col_capacity,
                            self.query_block, self.window, self.wrap_cap)
        if self.variable or self.grid_x or not self.periodic_x:
            raise NotImplementedError(
                "only the uniform cubic periodic cell-block layout is ported "
                "(variable capacities and halo slabs are not)"
            )
        if g < 3:
            raise ValueError(f"grid_size {g} must be >= 3")
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
        if self.num_slots * g >= 2**31:
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
    TPU-tuned choice). G is the k-NN exactness grid when ``k`` is known."""
    if variable:
        raise NotImplementedError("variable cell-block capacities are not ported")
    if k is not None:
        g = choose_cell_grid(num_particles, k).grid_size
    else:
        g = max(3, int(round((num_particles / 24.0) ** (1.0 / 3.0))))
    mean_col = num_particles / g**2
    mean_cell = num_particles / g**3
    return _plan_spec(g, mean_col, mean_cell, h_block, query_block)


def _plan_spec(g, mean_col, mean_cell, h_block, query_block):
    """CC covers the per-column Poisson tail, W a QB tile's z-extent plus one
    cell each side with a 5-sigma margin; QB minimizes the TPU kernel's
    per-step traffic (S table plus re-streamed windows)."""
    num_columns = g * g
    wrap = _round_up(mean_cell + 6.0 * math.sqrt(mean_cell) + 4.0, 16)

    def plan(qb):
        cc = _round_up(max(mean_col + 5.0 * math.sqrt(mean_col), qb), qb)
        need = qb + 3.0 * mean_cell + 5.0 * math.sqrt(qb + 3.0 * mean_cell)
        w = _round_up(need, _LANE)
        padded = cc + 2 * wrap
        if w > padded:
            # Tiny columns: one window covers the whole padded column.
            w = padded if padded < _LANE else padded // _LANE * _LANE
        return cc, w

    if query_block is not None:
        qb = query_block
        cc, w = plan(qb)
    else:
        best = None
        for qb_c in range(32, 257, 32):
            cc_c, w_c = plan(qb_c)
            slots_c = num_columns * cc_c
            s_bytes = slots_c * 9 * w_c
            win_bytes = (slots_c // qb_c) * 9 * w_c * h_block * 2
            score = (s_bytes + win_bytes, -qb_c)
            if best is None or score < best[0]:
                best = (score, qb_c, cc_c, w_c)
        _, qb, cc, w = best
    return CellBlockSpec(grid_size=g, col_capacity=cc, query_block=qb, window=w,
                         wrap_cap=wrap, h_block=h_block)


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


# The 27 neighbor-cell offsets of the k-NN codes, dx slowest.
_OFFSETS27 = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


class CellBlockLayout(NamedTuple):
    """The data-dependent slot and window layout of a plan (everything but
    the S table): the ``CellBlockGraph`` fields of the same names, plus what
    the codes decode reads — each sorted particle's z-cell, the clipped
    compact start of every cell within its column ``cstart_rel [C, G]``,
    and the per-(tile, ring column) window constants ``tile_const
    [T, 45]`` int32 (``[w_loc, cP, m, cA, cstart_g1]`` at ``j * 5 + i``)."""

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


def cellblock_layout(positions: torch.Tensor, box_size, spec: CellBlockSpec) -> CellBlockLayout:
    """Bin wrapped ``[N, 3]`` positions into the spec's columns: the sort
    order, slot maps, z-wrap image map, window placement and the overflow
    counts (the JAX ``build_cellblock`` up to its S build)."""
    spec.validate()
    g = spec.grid_size
    cc, qb, w_cap, wrap = (spec.col_capacity, spec.query_block, spec.window,
                           spec.wrap_cap)
    tpc, ccp = spec.tiles_per_col, spec.padded_col
    num_cols, num_slots, num_tiles = spec.num_columns, spec.num_slots, spec.num_tiles
    num_cells = num_cols * g
    n = positions.shape[0]
    dev = positions.device

    coords = cell_coords(positions.float(), g, f32(box_size, dev))
    cell_id = (coords[:, 0] * g + coords[:, 1]) * g + coords[:, 2]
    sorted_cell, order = torch.sort(cell_id, stable=True)
    sorted_col = sorted_cell // g
    sorted_cz = sorted_cell % g

    # Per-cell / per-column boundaries of the sorted stream.
    gstart = bucket_boundaries(sorted_cell, num_cells)  # [cells + 1]
    col_start = gstart[::g]  # [cols + 1]
    counts = (gstart[1:] - gstart[:-1]).reshape(num_cols, g)
    col_cnt = col_start[1:] - col_start[:-1]

    # Compact per-column rank (z-ordered) and the slot maps.
    r = torch.arange(n, device=dev) - col_start[sorted_col]
    q_ok = r < cc
    slot_of_sorted = torch.where(q_ok, sorted_col * cc + r, num_slots)
    overflow = (~q_ok).sum()
    slot_ids = torch.arange(num_slots, device=dev)
    slot_col, slot_r = slot_ids // cc, slot_ids % cc
    particle_of_slot = torch.where(slot_r < col_cnt[slot_col],
                                   col_start[:-1][slot_col] + slot_r, n)

    # Per-column z-wrap layout [cP | main | cA], tightly packed.
    m = torch.clamp(col_cnt, max=cc)  # used main rows
    c_pre = torch.clamp(counts[:, g - 1], max=wrap)
    c_app = torch.clamp(counts[:, 0], max=wrap)
    # Compact start of each z-cell within its column, clipped by capacity;
    # extended so index G reads the used-row count.
    cstart_rel = torch.clamp(
        gstart[:num_cells].reshape(num_cols, g) - col_start[:-1, None], 0, cc)
    cstart_ext = torch.cat([cstart_rel, m[:, None]], dim=1)  # [C, G + 1]
    cstart_g1 = cstart_rel[:, g - 1]

    t_pad = torch.arange(ccp, device=dev)[None, :]
    src = torch.where(
        t_pad < c_pre[:, None], cstart_g1[:, None] + t_pad,
        torch.where(t_pad < (c_pre + m)[:, None], t_pad - c_pre[:, None],
                    torch.where(t_pad < (c_pre + m + c_app)[:, None],
                                t_pad - (c_pre + m)[:, None], cc)))
    cols = torch.arange(num_cols, device=dev)[:, None]
    pad_src = torch.where(src < cc, cols * cc + src, num_slots).reshape(-1)

    # Per-tile z extents (first/last valid query row of the tile).
    tiles = torch.arange(num_tiles, device=dev)
    tile_col, tile_qt = tiles // tpc, tiles % tpc
    a_row = tile_qt * qb
    m_tile = m[tile_col]
    has_rows = a_row < m_tile
    b_row = torch.maximum(torch.minimum((tile_qt + 1) * qb, m_tile) - 1, a_row)
    base = col_start[tile_col]
    z_lo = torch.where(has_rows, sorted_cz[torch.clamp(base + a_row, 0, n - 1)], 0)
    z_hi = torch.where(has_rows, sorted_cz[torch.clamp(base + b_row, 0, n - 1)], 0)

    # The 3x3 ring columns of each tile and their window placement.
    dxy = torch.arange(9, device=dev)
    col_j = (((tile_col // g)[:, None] + dxy // 3 - 1) % g) * g \
        + ((tile_col % g)[:, None] + dxy % 3 - 1) % g  # [T, 9]
    cp_j, m_j, ca_j, cg1_j = c_pre[col_j], m[col_j], c_app[col_j], cstart_g1[col_j]
    start_lo = cstart_ext[col_j, torch.clamp(z_lo - 1, 0, g)[:, None]]
    w_loc = torch.where(z_lo[:, None] >= 1, cp_j + start_lo, 0)
    end_hi = cstart_ext[col_j, torch.clamp(z_hi + 2, 0, g)[:, None]]
    end = torch.where(z_hi[:, None] <= g - 2, cp_j + end_hi, cp_j + m_j + ca_j)
    # Starts floored to 16 rows (the TPU sublane tiling; the S offsets
    # depend on it, so it stays), clamped inside the padded column.
    w_loc = torch.clamp(w_loc // 16 * 16, 0, ccp - w_cap)
    window_starts = (col_j * ccp + w_loc).to(torch.int32)
    window_overflow = torch.clamp(
        torch.where(has_rows[:, None], end - w_loc - w_cap, 0).max(), min=0)
    tile_const = torch.stack([w_loc, cp_j, m_j, ca_j, cg1_j], dim=2).reshape(
        num_tiles, 45).to(torch.int32).contiguous()
    return CellBlockLayout(
        order=order, slot_of_sorted=slot_of_sorted, particle_of_slot=particle_of_slot,
        pad_src=pad_src, window_starts=window_starts, overflow=overflow,
        window_overflow=window_overflow, sorted_cz=sorted_cz, cstart_rel=cstart_rel,
        tile_const=tile_const,
    )


def s_decode_inputs(layout: CellBlockLayout, neighbor_codes: torch.Tensor, codes_cap: int,
                    codes_spill, spec: CellBlockSpec):
    """K2's inputs: ``(codes [num_slots, k], qz_slot [num_slots],
    cstart27 [G^3, 27], tile_const [T, 45])``, all int32 — the k-NN codes
    moved to their query's slot and pre-normalized (the JAX ``_invalidate``
    / ``_resolve``): ring picks stay ``j27 * cap + rank``; resolved spill
    senders become ``27 * cap + jring * (CC * G) + r * G + cz``; real spill
    senders outside the 3x3 ring ``DROP_MARK``; everything else (empty
    slots, unused spill lanes) ``INVALID``."""
    g, cc = spec.grid_size, spec.col_capacity
    num_slots = spec.num_slots
    n, k = neighbor_codes.shape
    dev = neighbor_codes.device
    codes = neighbor_codes.to(torch.int32)
    spill_len = 0 if codes_spill is None else codes_spill[0].shape[0]
    # Always-invalid code for empty slots: past the ring and the spill block.
    code_sentinel = 27 * codes_cap + spill_len
    # Per-slot codes by a row scatter through each particle's slot; slotless
    # particles (column overflow) land on the cut-off row num_slots.
    order, slot_of_sorted = layout.order, layout.slot_of_sorted
    slot_of_particle = torch.empty_like(slot_of_sorted)
    slot_of_particle[order] = slot_of_sorted
    codes_slots = torch.full((num_slots + 1, k), code_sentinel, dtype=torch.int32,
                             device=dev)
    codes_slots[slot_of_particle] = codes
    codes_slots = codes_slots[:num_slots]
    qz_slot = torch.zeros(num_slots + 1, dtype=torch.int32, device=dev)
    qz_slot[slot_of_sorted] = layout.sorted_cz.to(torch.int32)
    qz_slot = qz_slot[:num_slots]

    res_base = 27 * codes_cap
    ccg = cc * g
    drop_mark = res_base + 9 * ccg
    invalid = drop_mark + 1
    normalized = torch.where(codes_slots >= res_base, invalid, codes_slots)
    if spill_len:
        # Branch-free: without live spill codes this reduces to the plain
        # invalidation above, as the two arms of the JAX lax.cond do.
        sp_cells = torch.clamp(codes_spill[0].long(), 0, g**3 - 1)
        sp_col, sp_cz = sp_cells // g, sp_cells % g
        sp_rs = layout.cstart_rel.reshape(-1)[sp_cells] + codes_spill[1].long()
        sp_in = sp_rs < cc
        sp_slot = torch.where(sp_in, sp_col * cc + sp_rs, num_slots)
        sp_aux = sp_slot * g + torch.where(sp_in, sp_cz, 0)
        sp_idx = codes_slots.long() - res_base
        is_sp = (sp_idx >= 0) & (sp_idx < spill_len)
        aux_sp = sp_aux[torch.clamp(sp_idx, 0, spill_len - 1)]
        slot_sp = aux_sp // g
        real = is_sp & (slot_sp < num_slots)
        col_sp = slot_sp // cc
        col_q = (torch.arange(num_slots, device=dev) // cc)[:, None]
        dxm = (col_sp // g - col_q // g + 1 + g) % g
        dym = (col_sp % g - col_q % g + 1 + g) % g
        in3 = real & (dxm < 3) & (dym < 3)
        packed_sp = res_base + (dxm * 3 + dym) * ccg + (slot_sp % cc) * g + aux_sp % g
        v = torch.where(in3, packed_sp, torch.where(real, drop_mark, invalid))
        normalized = torch.where(is_sp, v.to(torch.int32), normalized)

    # Compact starts of each cell's 27 neighbor cells, in code order.
    cstart3 = layout.cstart_rel.reshape(g, g, g)
    cstart27 = torch.stack(
        [torch.roll(cstart3, (-dx, -dy, -dz), dims=(0, 1, 2)) for dx, dy, dz in _OFFSETS27],
        dim=-1,
    ).reshape(g**3, 27).to(torch.int32).contiguous()
    return normalized.contiguous(), qz_slot.contiguous(), cstart27, layout.tile_const


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
    dense_search=None,
) -> CellBlockGraph:
    """Build the per-graph plan from the k-NN kernel's candidate codes.

    ``positions`` ``[N, 3]`` are wrapped, in original particle order;
    ``neighbor_codes`` ``[N, k]`` and ``codes_spill`` are what
    ``pallas_cell_list_knn(..., codes_only=True)`` returned on the SAME grid
    size as ``spec.grid_size``, ``codes_cap`` its ``codes_packing_cap``.
    The S table is built by K2 then K3 (``s_build="kernel"``, the JAX
    package's kernel route). Every other input form raises
    ``NotImplementedError``.
    """
    if neighbors is not None or neighbor_codes is None:
        raise NotImplementedError(
            "build_cellblock from neighbor ids (the aux path) is not ported; "
            "pass neighbors=None with neighbor_codes"
        )
    if codes_cap is None:
        raise ValueError("neighbor_codes and codes_cap go together")
    if with_reverse:
        raise NotImplementedError("the reverse table (with_reverse) is not ported")
    if s_build != "kernel":
        raise NotImplementedError(f"s_build={s_build!r} is not ported (only 'kernel')")
    if valid is not None:
        raise NotImplementedError("validity masks are not ported")
    if codes_layout != "particle":
        raise NotImplementedError(f"codes_layout={codes_layout!r} is not ported")
    if dense_search is not None:
        raise NotImplementedError("the dense search is not ported")
    if neighbor_codes.shape[1] > 127:
        raise ValueError(f"k={neighbor_codes.shape[1]} exceeds 127 — S-table "
                         "entries are int8 counts")
    layout = cellblock_layout(positions, box_size, spec)
    offsets = s_decode(*s_decode_inputs(layout, neighbor_codes, codes_cap, codes_spill, spec),
                       spec=spec, codes_cap=codes_cap)
    return CellBlockGraph(
        order=layout.order,
        slot_of_sorted=layout.slot_of_sorted,
        particle_of_slot=layout.particle_of_slot,
        pad_src=layout.pad_src,
        window_starts=layout.window_starts,
        s_table=s_onehot(offsets, width=spec.s_width),
        overflow=layout.overflow,
        dropped_edges=(offsets == spec.s_width + 1).sum(),
        window_overflow=layout.window_overflow,
    )


# ---------------------------------------------------------------------------
# K2: codes -> S-lane offsets
# ---------------------------------------------------------------------------


def s_decode_reference(codes, qz_slot, cstart27, tile_const, *, spec: CellBlockSpec,
                       codes_cap: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (the Pallas ``_s_from_codes_fused``'s
    decode). Per slot ``s`` and pick ``p`` of the pre-normalized
    ``codes [num_slots, k]`` int32, with the slot's query z-cell
    ``qz_slot [num_slots]``, the neighbor-cell start table
    ``cstart27 [G^3, 27]`` and the tile constants ``tile_const [T, 45]``:
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
    s27 = cstart27.long()[(slots // cc) * g + qz_slot.long()]  # [S, 27]
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
        lib.s_decode_launch.argtypes = [p] * 5 + [i] * 7 + [p]
    elif name == "s_onehot":
        lib.s_onehot_launch.argtypes = [p, p, i, i, i, p]
    else:
        lib.window_matmul_launch.argtypes = [p] * 4 + [i] * 6 + [p]
    getattr(lib, f"{name}_launch").restype = i
    return lib


def _check(name: str, device, tensors) -> None:
    for label, t, shape, dtype in tensors:
        if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {label} must be a contiguous {dtype} {tuple(shape)} tensor "
                f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def s_decode(codes, qz_slot, cstart27, tile_const, *, spec: CellBlockSpec,
             codes_cap: int) -> torch.Tensor:
    """K2: pre-normalized codes -> int16 S-lane offsets (see
    ``s_decode_reference``). CPU tensors take the plain version; CUDA
    tensors launch ``csrc/s_decode.cu`` or raise."""
    if codes.device.type == "cpu":
        return s_decode_reference(codes, qz_slot, cstart27, tile_const, spec=spec,
                                  codes_cap=codes_cap)
    num_slots, k = codes.shape
    g = spec.grid_size
    if spec.s_width + 2 >= 2**15:
        raise ValueError(f"s_decode writes int16 offsets; S width {spec.s_width} too wide")
    if num_slots != spec.num_slots:
        raise ValueError(f"s_decode: {num_slots} code rows, spec has {spec.num_slots} slots")
    _check("s_decode", codes.device, [
        ("codes", codes, (num_slots, k), torch.int32),
        ("qz_slot", qz_slot, (num_slots,), torch.int32),
        ("cstart27", cstart27, (g**3, 27), torch.int32),
        ("tile_const", tile_const, (spec.num_tiles, 45), torch.int32),
    ])
    out = torch.empty((num_slots, k), dtype=torch.int16, device=codes.device)
    err = _lib("s_decode").s_decode_launch(
        kernels.ptr(codes), kernels.ptr(qz_slot), kernels.ptr(cstart27),
        kernels.ptr(tile_const), kernels.ptr(out), num_slots, k, g,
        spec.col_capacity, spec.query_block, spec.window, codes_cap,
        kernels.stream_handle(codes.device),
    )
    kernels.check("s_decode", err)
    kernels.launches["s_decode"] += 1
    return out


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


def s_onehot(offsets: torch.Tensor, *, width: int) -> torch.Tensor:
    """K3: int8 S rows of multiplicity counts from per-row lane offsets (see
    ``s_onehot_reference``; ``k <= 127``, so counts fit int8). CPU tensors
    take the plain version; CUDA tensors launch ``csrc/s_onehot.cu`` or
    raise."""
    if offsets.device.type == "cpu":
        return s_onehot_reference(offsets, width=width)
    rows, k = offsets.shape
    if k > 127 or width % 8:
        raise ValueError(f"s_onehot kernel takes k <= 127 and width % 8 == 0, "
                         f"got k={k}, width={width}")
    _check("s_onehot", offsets.device, [("offsets", offsets, (rows, k), torch.int16)])
    out = torch.empty((rows, width), dtype=torch.int8, device=offsets.device)
    err = _lib("s_onehot").s_onehot_launch(
        kernels.ptr(offsets), kernels.ptr(out), rows, k, width,
        kernels.stream_handle(offsets.device),
    )
    kernels.check("s_onehot", err)
    kernels.launches["s_onehot"] += 1
    return out


# ---------------------------------------------------------------------------
# Slot space and K4, the window matmul
# ---------------------------------------------------------------------------


def expand_to_slots(x_sorted: torch.Tensor, plan: CellBlockGraph, dtype=None) -> torch.Tensor:
    """``[N, F]`` cell-sorted rows -> ``[num_slots, F]``; empty slots zero."""
    if dtype is not None:
        x_sorted = x_sorted.to(dtype)
    x_ext = torch.cat([x_sorted, x_sorted.new_zeros((1, x_sorted.shape[1]))])
    return x_ext.index_select(0, plan.particle_of_slot)


def compact_from_slots(x_slots: torch.Tensor, plan: CellBlockGraph) -> torch.Tensor:
    """``[num_slots, F]`` -> ``[N, F]`` cell-sorted rows (the overflow
    sentinel clamps to the last slot, as JAX's clip gather — flagged by
    ``plan.overflow``)."""
    idx = torch.clamp(plan.slot_of_sorted, max=x_slots.shape[0] - 1)
    return x_slots.index_select(0, idx)


def _pad_candidates(z_slots: torch.Tensor, pad_src: torch.Tensor, carry_dtype) -> torch.Tensor:
    """Slot rows -> the z-wrap padded candidate image (one row gather)."""
    z = z_slots.to(carry_dtype)
    z_ext = torch.cat([z, z.new_zeros((1, z.shape[1]))])
    return z_ext.index_select(0, pad_src)


# Query tiles per chunk of the plain window matmul (bounds its gathered
# [tiles, W, H] windows on the CPU).
_PLAIN_TILES = 64


def window_matmul_reference(s_table, z_pad, window_starts, *, spec: CellBlockSpec) -> torch.Tensor:
    """Plain PyTorch version of K4: per query tile ``t``,
    ``out[t*QB:(t+1)*QB] = sum_j S_j @ z_pad[start[t, j] : +W]`` with
    ``S_j = s_table[rows, j*W:(j+1)*W]`` taken in ``z_pad``'s dtype (exact
    for int8 counts) and products and sums in float32. Returns
    ``[num_slots, H]`` float32."""
    qb, w = spec.query_block, spec.window
    num_tiles = window_starts.shape[0]
    h = z_pad.shape[1]
    s = s_table.view(num_tiles, qb, 9, w)
    lanes = torch.arange(w, device=z_pad.device)
    out = torch.empty((num_tiles, qb, h), dtype=torch.float32, device=z_pad.device)
    for t0 in range(0, num_tiles, _PLAIN_TILES):
        t1 = min(t0 + _PLAIN_TILES, num_tiles)
        acc = torch.zeros((t1 - t0, qb, h), dtype=torch.float32, device=z_pad.device)
        for j in range(9):
            sj = s[t0:t1, :, j, :].to(z_pad.dtype).float()
            rows = window_starts[t0:t1, j].long()[:, None] + lanes
            acc += torch.bmm(sj, z_pad[rows].float())
        out[t0:t1] = acc
    return out.reshape(num_tiles * qb, h)


def window_matmul(s_table, z_pad, window_starts, *, spec: CellBlockSpec) -> torch.Tensor:
    """K4: the cell-block aggregation in slot space (see
    ``window_matmul_reference``). CPU tensors take the plain version; CUDA
    tensors launch ``csrc/window_matmul.cu`` (bf16 ``z_pad`` with
    ``H % 8 == 0``) or raise."""
    if s_table.device.type == "cpu":
        return window_matmul_reference(s_table, z_pad, window_starts, spec=spec)
    num_pad, h = z_pad.shape
    if z_pad.dtype != torch.bfloat16 or h % 8:
        raise ValueError(f"window_matmul kernel takes a bf16 z_pad with H % 8 == 0, "
                         f"got {z_pad.dtype} with H = {h}")
    _check("window_matmul", s_table.device, [
        ("s_table", s_table, (spec.num_slots, spec.s_width), torch.int8),
        ("z_pad", z_pad, (spec.num_padded, h), torch.bfloat16),
        ("window_starts", window_starts, (spec.num_tiles, 9), torch.int32),
    ])
    out = torch.empty((spec.num_slots, h), dtype=torch.float32, device=z_pad.device)
    err = _lib("window_matmul").window_matmul_launch(
        kernels.ptr(s_table), kernels.ptr(z_pad), kernels.ptr(window_starts),
        kernels.ptr(out), spec.num_tiles, spec.query_block, spec.window, h,
        num_pad, spec.s_width, kernels.stream_handle(z_pad.device),
    )
    kernels.check("window_matmul", err)
    kernels.launches["window_matmul"] += 1
    return out


def cellblock_aggregate(z_sorted: torch.Tensor, plan: CellBlockGraph, spec: CellBlockSpec,
                        *, carry_dtype=torch.bfloat16) -> torch.Tensor:
    """``agg[i] = sum_j z[neighbors[i, j]]`` for cell-sorted ``[N, H]`` rows:
    expand to slots, pad, K4, compact. ``carry_dtype`` is the candidates'
    precision inside the product (sums are float32); returns float32."""
    z_slots = expand_to_slots(z_sorted, plan, dtype=carry_dtype)
    z_pad = _pad_candidates(z_slots, plan.pad_src, carry_dtype)
    out = window_matmul(plan.s_table, z_pad, plan.window_starts, spec=spec)
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
