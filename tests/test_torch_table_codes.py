"""The table codes layout: K1''s cell-table output handed on as the kernel
wrote it (``pallas_cell_list_knn(..., codes_layout="table")``) and the plan
built from it (``build_cellblock(codes_layout="table")``, K2 reading each
slot's codes row through the row map ``codes_rows``), held against the
port's particle layout on the same frame and against the JAX package's
table route on identical numpy inputs.

Frames: the uniform and the spill frames of ``tests/test_torch_cellblock.py``
(k = 4; in the spill frame 60 particles crammed into one cell reach the
spill block and drop an edge) and the variable-layout frame of
``tests/test_torch_cellblock_variable.py`` (N = 4,096, k = 16), so the JAX
k-NN kernel runs (in interpret mode) at shapes those files compile too.
Everything is integer arithmetic: codes, offsets, S, S_rev and every count
must be bit-equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu.ops import cellblock as jcb
from cosmology_gnn_simulation_tpu.ops.cell_list import CellGrid as JaxCellGrid
from cosmology_gnn_simulation_tpu.ops.pallas_knn import (
    pallas_cell_list_knn as jax_pallas_cell_list_knn,
)
from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.featurize import neighbor_search_certified
from cosmology_gnn_simulation_tpu_torch.ops import cellblock
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import CellGrid
from cosmology_gnn_simulation_tpu_torch.ops.pallas_knn import (
    codes_packing_cap,
    pallas_cell_list_knn,
)

SPEC_TILED = dict(grid_size=6, col_capacity=160, query_block=32, window=128,
                  wrap_cap=48, h_block=128)
# name: (spec or "variable", n, k, crammed particles, table capacity
# multiplier, seed)
FRAMES = {
    "uniform": (SPEC_TILED, 3000, 4, 0, 4.0, 33),
    "spill": (SPEC_TILED, 3000, 4, 60, 2.0, 7),
    "variable": ("variable", 4096, 16, 0, 4.0, 41),
}
PLAN_FIELDS = ("order", "slot_of_sorted", "particle_of_slot", "pad_src",
               "window_starts", "s_table", "overflow", "dropped_edges",
               "window_overflow", "s_rev_table", "reverse_mismatch")


@functools.cache
def _frame(name):
    """Positions, the spec, the k-NN grid and both packages' codes in the
    table layout (the JAX k-NN in interpret mode); cached, read-only."""
    spec, n, k, cram, capmul, seed = FRAMES[name]
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1.0, size=(n, 3)).astype(np.float32)
    spec = (cellblock.choose_cellblock_spec(n, k, variable=True) if spec == "variable"
            else cellblock.CellBlockSpec(**spec))
    g = spec.grid_size
    if cram:
        pos[:cram] = 0.5 / g + rng.uniform(0, 0.2 / g, size=(cram, 3))
    grid = (g, max(8, int(np.ceil(n / g**3 * capmul))))
    _, jcodes, jspill = jax_pallas_cell_list_knn(
        jnp.asarray(pos), k, 1.0, JaxCellGrid(*grid), with_codes=True, codes_only=True,
        codes_layout="table", interpret=True,
    )
    jspill = None if jspill is None else tuple(np.array(s) for s in jspill)
    return spec, pos, k, grid, np.array(jcodes), jspill


@functools.cache
def _port_codes(name, codes_layout):
    spec, pos, k, grid, _, _ = _frame(name)
    _, codes, spill = pallas_cell_list_knn(torch.from_numpy(pos), k, 1.0, CellGrid(*grid),
                                           codes_only=True, codes_layout=codes_layout)
    return codes, spill


def _plan(name, codes, spill, codes_layout, with_reverse=True):
    spec, pos, k, grid, _, _ = _frame(name)
    return cellblock.build_cellblock(
        torch.from_numpy(pos), None, 1.0, spec, with_reverse=with_reverse,
        neighbor_codes=codes, codes_cap=codes_packing_cap(len(pos), k, CellGrid(*grid)),
        codes_spill=spill, codes_layout=codes_layout)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_table_codes_match_jax(name):
    """The port's table output is K1''s raw rows: on every table row that
    holds a particle, with exhausted picks repeating their row's first code
    (the JAX wrapper's rule, which K2 applies on the card), it equals JAX's
    table codes (empty rows, which no slot reads, are all sentinel in the
    port); the spill tables and the solved spill picks of every used spill
    slot are JAX's."""
    spec, pos, k, grid, jcodes, jspill = _frame(name)
    codes, spill = _port_codes(name, "table")
    cap = codes_packing_cap(len(pos), k, CellGrid(*grid))
    num_rows = grid[0] ** 3 * cap
    assert codes.shape == (num_rows, k) and codes.dtype == torch.int32
    valid_lanes = 27 * cap + (0 if spill is None else spill[0].shape[0])
    fixed = torch.where(codes >= valid_lanes, codes[:, :1], codes)
    layout = cellblock.cellblock_layout(torch.from_numpy(pos), 1.0, spec)
    rows = cellblock.codes_rows(layout, spill, cap, spec, "table")
    occupied = torch.unique(rows[rows < num_rows])
    assert len(occupied) > len(pos) // 2
    np.testing.assert_array_equal(fixed[occupied].numpy(), jcodes[occupied.numpy()])
    empty = torch.ones(num_rows, dtype=torch.bool)
    empty[occupied] = False
    assert bool((codes[empty] == valid_lanes).all())
    assert (spill is None) == (jspill is None)
    if spill is not None:
        assert len(spill) == len(jspill) == 3
        np.testing.assert_array_equal(spill[0].numpy(), jspill[0])
        np.testing.assert_array_equal(spill[1].numpy(), jspill[1])
        used = spill[1].numpy() < 2**20
        np.testing.assert_array_equal(spill[2].numpy()[used], jspill[2][used])
        assert (spill[2].numpy()[~used] == valid_lanes).all()
        if name == "spill":
            assert used.any()
    # Each particle's row of the table layout holds its particle-layout codes.
    pcodes, _ = _port_codes(name, "particle")
    from_table = torch.cat([fixed, spill[2]]) if spill is not None else fixed
    np.testing.assert_array_equal(from_table[rows].numpy(), pcodes[layout.order].numpy())


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_table_plan_matches_particle_route_and_jax(name):
    """The table route's plan (K2's plain version on table rows, K3, and
    K7 from the table route's sender packs) against the particle route's on
    the same frame and JAX ``build_cellblock(codes_layout="table")`` fed
    JAX's table codes, with the reverse table."""
    spec, pos, k, grid, jcodes, jspill = _frame(name)
    codes, spill = _port_codes(name, "table")
    kernels.reset_launches()
    plan = _plan(name, codes, spill, "table")
    assert not any(kernels.launches.values())  # CPU tensors launch nothing
    particle = _plan(name, *_port_codes(name, "particle"), "particle")
    cap = codes_packing_cap(len(pos), k, CellGrid(*grid))
    # JAX's XLA S build: the table route's own step, the slots' codes
    # gather, comes before it and is shared with the Pallas build (which
    # tests/test_torch_cellblock.py holds the port's K2 and K3 to).
    jplan = jcb.build_cellblock(
        jnp.asarray(pos), None, 1.0, jcb.CellBlockSpec(*spec), s_build="contract",
        with_reverse=True, neighbor_codes=jnp.asarray(jcodes), codes_cap=cap,
        codes_spill=jspill, codes_layout="table",
    )
    for field in PLAN_FIELDS:
        got = getattr(plan, field)
        assert torch.equal(got, getattr(particle, field)), field
        want = np.asarray(getattr(jplan, field))
        assert got.shape == want.shape, field
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    if name == "spill":
        assert int(plan.dropped_edges) > 0
    else:
        assert int(plan.dropped_edges) == 0 and int(plan.overflow) == 0
    # K2's offsets and dropped count themselves, table rows vs particle rows.
    layout = cellblock.cellblock_layout(torch.from_numpy(pos), 1.0, spec)
    off_t, drop_t = cellblock.s_decode(codes, spill, layout, spec, cap, "table")
    off_p, drop_p = cellblock.s_decode(*_port_codes(name, "particle"), layout, spec, cap)
    assert torch.equal(off_t, off_p) and int(drop_t) == int(drop_p)


def test_table_layout_contract():
    """The refusals of the JAX wrappers: the table layout needs codes_only,
    the plan's codes rows and its three-element spill info; the certified
    search passes the layout through only with codes_only; no default
    changed."""
    spec, pos, k, grid, _, _ = _frame("spill")
    tpos = torch.from_numpy(pos)
    with pytest.raises(ValueError, match="requires codes_only"):
        pallas_cell_list_knn(tpos, k, 1.0, CellGrid(*grid), with_codes=True,
                             codes_layout="table")
    with pytest.raises(ValueError, match="unknown codes_layout"):
        pallas_cell_list_knn(tpos, k, 1.0, CellGrid(*grid), codes_only=True,
                             codes_layout="cells")
    codes, spill = _port_codes("spill", "table")
    cap = codes_packing_cap(len(pos), k, CellGrid(*grid))
    with pytest.raises(ValueError, match="3-element spill"):
        cellblock.build_cellblock(tpos, None, 1.0, spec, neighbor_codes=codes, codes_cap=cap,
                                  codes_spill=spill[:2], codes_layout="table")
    pcodes, pspill = _port_codes("spill", "particle")
    with pytest.raises(ValueError, match="expected G\\^3\\*cap"):
        cellblock.build_cellblock(tpos, None, 1.0, spec, neighbor_codes=pcodes, codes_cap=cap,
                                  codes_spill=spill, codes_layout="table")
    # neighbor_search_certified at N = 8,192 (K1's plain version): the table
    # layout with codes_only, the particle layout without it.
    big = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (8192, 3)).astype(np.float32))
    _, tcodes, tcap, tspill, exact = neighbor_search_certified(
        big, 16, 1.0, method="pallas", with_codes=True, codes_only=True, codes_layout="table")
    assert bool(exact) and tcodes.shape[0] > 8192 and len(tspill) == 3
    ids, dcodes, _, dspill, _ = neighbor_search_certified(
        big, 16, 1.0, method="pallas", with_codes=True, codes_layout="table")
    assert ids is not None and dcodes.shape == (8192, 16) and len(dspill) == 2
    import inspect

    for fn in (pallas_cell_list_knn, cellblock.build_cellblock, cellblock.s_decode,
               neighbor_search_certified):
        assert inspect.signature(fn).parameters["codes_layout"].default == "particle"
