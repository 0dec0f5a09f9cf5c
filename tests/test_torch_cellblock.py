"""The port's cell-block plan and aggregation (the plain paths of kernels
K2, K3 and K4) held against the JAX package on identical numpy inputs.

The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them. Plan arrays, the S table and every count must be bit-equal
(integer arithmetic throughout). The aggregation's products are exact on
both sides (int8 counts times bf16 or f32 values, summed in float32); only
the order of the float32 sums differs, so it is held to 1e-5 absolute on
O(1) values, summed over at most k = 4 neighbors.
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
from cosmology_gnn_simulation_tpu_torch.ops import cellblock
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import CellGrid
from cosmology_gnn_simulation_tpu_torch.ops.neighbors import knn_periodic
from cosmology_gnn_simulation_tpu_torch.ops.pallas_knn import codes_packing_cap

AGG_ATOL = 1e-5

# The JAX tests' specs: G = 4 with one tile per column and the window the
# whole padded column; G = 6 with 5 tiles per column and moving windows.
SPEC = dict(grid_size=4, col_capacity=32, query_block=32, window=96, wrap_cap=32,
            h_block=128)
SPEC_TILED = dict(grid_size=6, col_capacity=160, query_block=32, window=128,
                  wrap_cap=48, h_block=128)

# name: (spec, n, crammed particles, table capacity multiplier, seed)
FRAMES = {
    "spec": (SPEC, 200, 0, 4.0, 33),
    "spec_tiled": (SPEC_TILED, 3000, 0, 4.0, 33),
    # 60 particles crammed into one cell: the k-NN spills, codes reach the
    # spill block, one edge is dropped and a window overflows.
    "spill": (SPEC_TILED, 3000, 60, 2.0, 7),
}
K = 4
PLAN_FIELDS = ("order", "slot_of_sorted", "particle_of_slot", "pad_src",
               "window_starts", "s_table", "overflow", "dropped_edges",
               "window_overflow")


@functools.cache
def _frame(name):
    """Positions and the JAX k-NN's codes (codes_only, interpret mode);
    cached per frame, read-only."""
    spec, n, cram, capmul, seed = FRAMES[name]
    rng = np.random.default_rng(seed)
    g = spec["grid_size"]
    pos = rng.uniform(0, 1.0, size=(n, 3)).astype(np.float32)
    if cram:
        pos[:cram] = 0.5 / g + rng.uniform(0, 0.2 / g, size=(cram, 3))
    grid = (g, max(8, int(np.ceil(n / g**3 * capmul))))
    _, codes, spill = jax_pallas_cell_list_knn(
        jnp.asarray(pos), K, 1.0, JaxCellGrid(*grid), with_codes=True,
        codes_only=True, interpret=True,
    )
    cap = codes_packing_cap(n, K, CellGrid(*grid))
    return spec, pos, grid, np.array(codes), spill, cap


def _torch_spill(spill):
    return None if spill is None else tuple(torch.from_numpy(np.array(s)) for s in spill)


@functools.cache
def _plans(name):
    spec, pos, grid, codes, spill, cap = _frame(name)
    jplan = jcb.build_cellblock(
        jnp.asarray(pos), None, 1.0, jcb.CellBlockSpec(**spec), s_build="kernel",
        neighbor_codes=jnp.asarray(codes), codes_cap=cap, codes_spill=spill,
    )
    plan = cellblock.build_cellblock(
        torch.from_numpy(pos), None, 1.0, cellblock.CellBlockSpec(**spec),
        neighbor_codes=torch.from_numpy(codes), codes_cap=cap,
        codes_spill=_torch_spill(spill),
    )
    return spec, pos, jplan, plan


@pytest.mark.parametrize("n", [2048, 8192, 65536])
def test_spec_choice_matches_jax(n):
    spec = cellblock.choose_cellblock_spec(n, 16)
    assert tuple(spec) == tuple(jcb.choose_cellblock_spec(n, 16))
    spec.validate()
    assert spec.num_slots == jcb.choose_cellblock_spec(n, 16).num_slots


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_build_cellblock_matches_jax(name):
    _, _, jplan, plan = _plans(name)
    for field in PLAN_FIELDS:
        want = np.asarray(getattr(jplan, field))
        got = getattr(plan, field).numpy()
        assert got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    if name == "spill":
        assert int(plan.dropped_edges) > 0 and int(plan.window_overflow) > 0


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_s_decode_and_onehot_match_jax_kernels(name, monkeypatch):
    """K2 then K3 (plain) against the Pallas ``_s_from_codes_fused`` on the
    decode inputs the plan build hands K2, laid out as the JAX kernel's
    ``[k + 73, slots]`` block."""
    spec, pos, grid, codes, spill, cap = _frame(name)
    seen = {}
    real = cellblock.s_decode

    def spy(codes_n, qz_slot, cstart27, tile_const, **kw):
        seen["args"] = (codes_n, qz_slot, cstart27, tile_const)
        return real(codes_n, qz_slot, cstart27, tile_const, **kw)

    monkeypatch.setattr(cellblock, "s_decode", spy)
    tspec = cellblock.CellBlockSpec(**spec)
    plan = cellblock.build_cellblock(
        torch.from_numpy(pos), None, 1.0, tspec, neighbor_codes=torch.from_numpy(codes),
        codes_cap=cap, codes_spill=_torch_spill(spill),
    )
    codes_n, qz_slot, cstart27, tile_const = seen["args"]
    offsets = cellblock.s_decode_reference(codes_n, qz_slot, cstart27, tile_const,
                                           spec=tspec, codes_cap=cap)
    assert offsets.dtype == torch.int16
    s_table = cellblock.s_onehot_reference(offsets, width=tspec.s_width)

    slots = torch.arange(tspec.num_slots)
    s27 = cstart27[(slots // tspec.col_capacity) * tspec.grid_size + qz_slot.long()]
    const = tile_const.repeat_interleave(tspec.query_block, dim=0)
    packed = torch.cat([codes_n, s27, const, qz_slot[:, None]], dim=1).numpy().T
    packed = np.pad(packed, ((0, (-packed.shape[0]) % 8), (0, 0)))
    js, jdropped = jcb._s_from_codes_fused(jnp.asarray(packed), jcb.CellBlockSpec(**spec),
                                           K, cap, True)
    np.testing.assert_array_equal(s_table.numpy(), np.asarray(js))
    assert int((offsets == tspec.s_width + 1).sum()) == int(jdropped)
    assert torch.equal(plan.s_table, s_table)


def test_s_onehot_matches_jax_kernel():
    """K3 (plain) against the Pallas ``_s_from_offsets`` on offsets with
    duplicates (multiplicity counts) and both sentinels."""
    spec = jcb.CellBlockSpec(**SPEC)
    width = spec.s_width
    rng = np.random.default_rng(5)
    offsets = rng.integers(0, width, (spec.num_slots, 6))
    offsets[:, 1] = offsets[:, 0]
    offsets[::3, 2] = width
    offsets[::5, 3] = width + 1
    offsets = offsets.astype(np.int16)
    want = np.asarray(jcb._s_from_offsets(jnp.asarray(offsets), spec, True))
    got = cellblock.s_onehot(torch.from_numpy(offsets), width=width)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) >= 2


@pytest.mark.parametrize("carry", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["spec", "spec_tiled"])
def test_cellblock_aggregate_matches_jax(name, carry):
    spec, pos, jplan, plan = _plans(name)
    n = pos.shape[0]
    z = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
    z_sorted = z[np.asarray(jplan.order)]
    want = jcb.cellblock_aggregate(jnp.asarray(z_sorted), jplan, jcb.CellBlockSpec(**spec),
                                   carry_dtype=jnp.dtype(carry), interpret=True)
    got = cellblock.cellblock_aggregate(torch.from_numpy(z_sorted), plan,
                                        cellblock.CellBlockSpec(**spec),
                                        carry_dtype=getattr(torch, carry))
    assert got.dtype == torch.float32 and got.shape == (n, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=AGG_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["spec", "spec_tiled"])
def test_cellblock_aggregate_equals_gather_sum(name):
    """With a clean certificate the selection matrices reproduce the
    gather-sum over the k-NN graph (the plan's own oracle)."""
    spec, pos, _, plan = _plans(name)
    assert int(plan.overflow) == 0 and int(plan.dropped_edges) == 0
    tpos = torch.from_numpy(pos)
    nbr_sorted = cellblock.sort_neighbors(knn_periodic(tpos, K, 1.0), plan.order)
    z = torch.randn(pos.shape[0], 16, generator=torch.Generator().manual_seed(2))
    z_sorted = z[plan.order]
    ref = cellblock.reference_cellblock_aggregate(z_sorted, nbr_sorted)
    got = cellblock.cellblock_aggregate(z_sorted, plan, cellblock.CellBlockSpec(**spec),
                                        carry_dtype=torch.float32)
    torch.testing.assert_close(got, ref, atol=AGG_ATOL, rtol=0)


def test_sort_neighbors_and_slot_maps_match_jax():
    _, pos, jplan, plan = _plans("spec")
    tpos = torch.from_numpy(pos)
    nbr = knn_periodic(tpos, K, 1.0)
    want = jcb.sort_neighbors(jnp.asarray(nbr.numpy()), jplan.order)
    np.testing.assert_array_equal(cellblock.sort_neighbors(nbr, plan.order).numpy(),
                                  np.asarray(want))
    x = np.random.default_rng(3).standard_normal((pos.shape[0], 8)).astype(np.float32)
    slots = cellblock.expand_to_slots(torch.from_numpy(x), plan)
    np.testing.assert_array_equal(slots.numpy(),
                                  np.asarray(jcb.expand_to_slots(jnp.asarray(x), jplan)))
    np.testing.assert_array_equal(cellblock.compact_from_slots(slots, plan).numpy(), x)


def test_kernel_wrappers_take_plain_versions_on_cpu():
    spec, pos, grid, codes, spill, cap = _frame("spill")
    tspec = cellblock.CellBlockSpec(**spec)
    layout = cellblock.cellblock_layout(torch.from_numpy(pos), 1.0, tspec)
    dec_in = cellblock.s_decode_inputs(layout, torch.from_numpy(codes), cap,
                                       _torch_spill(spill), tspec)
    offsets = cellblock.s_decode(*dec_in, spec=tspec, codes_cap=cap)
    assert torch.equal(offsets, cellblock.s_decode_reference(*dec_in, spec=tspec,
                                                             codes_cap=cap))
    s_table = cellblock.s_onehot(offsets, width=tspec.s_width)
    assert torch.equal(s_table, cellblock.s_onehot_reference(offsets, width=tspec.s_width))
    z_pad = torch.randn(tspec.num_padded, 16).bfloat16()
    got = cellblock.window_matmul(s_table, z_pad, layout.window_starts, spec=tspec)
    want = cellblock.window_matmul_reference(s_table, z_pad, layout.window_starts,
                                             spec=tspec)
    assert torch.equal(got, want)


def test_unported_plan_options_raise():
    spec, pos, grid, codes, spill, cap = _frame("spec")
    tspec = cellblock.CellBlockSpec(**spec)
    tpos, tcodes = torch.from_numpy(pos), torch.from_numpy(codes)
    ok = dict(neighbor_codes=tcodes, codes_cap=cap, codes_spill=_torch_spill(spill))
    with pytest.raises(NotImplementedError, match="aux path"):
        cellblock.build_cellblock(tpos, knn_periodic(tpos, K, 1.0), 1.0, tspec)
    for kw in (dict(s_build="contract"),
               dict(codes_layout="table"), dict(valid=torch.ones(len(pos), dtype=bool)),
               dict(dense_search=object())):
        with pytest.raises(NotImplementedError):
            cellblock.build_cellblock(tpos, None, 1.0, tspec, **ok, **kw)
    for bad in (tspec._replace(slot_budget=1024), tspec._replace(grid_x=5)):
        with pytest.raises(NotImplementedError):
            cellblock.build_cellblock(tpos, None, 1.0, bad, **ok)
    with pytest.raises(NotImplementedError):
        cellblock.choose_cellblock_spec(4096, 16, variable=True)
