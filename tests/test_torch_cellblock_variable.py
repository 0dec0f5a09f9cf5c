"""The port's variable cell-block layout (per-column capacities behind
QB-aligned prefixes within a static ``slot_budget``) held against the JAX
package on identical numpy inputs: the chooser, the plan on the codes route
(K2's plain version, with and without the reverse table K7) and on the aux
route (from neighbor ids, with the reverse table), a budget overflow, and
the slot-space aggregation and its backward.

The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them. Plan arrays, the S and S_rev tables and every count must be
bit-equal (integer arithmetic throughout). The aggregation's products are
exact on both sides (int8 counts times f32 values, summed in float32); only
the order of the float32 sums differs: 1e-5 absolute on O(1) values, summed
over at most k = 16 neighbors; the backward 1e-4 relative and 1e-5
absolute, as the JAX test of the variable VJP holds it.
"""

import functools

import jax
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

N, K = 4096, 16
AGG_ATOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
PLAN_FIELDS = ("order", "slot_of_sorted", "particle_of_slot", "pad_src",
               "window_starts", "s_table", "overflow", "dropped_edges",
               "window_overflow")


@functools.cache
def _frame():
    """Uniform positions, the variable spec, the JAX k-NN's codes on its
    grid (codes_only, interpret mode) and the neighbor ids; read-only."""
    rng = np.random.default_rng(41)
    pos = rng.uniform(0, 1.0, size=(N, 3)).astype(np.float32)
    spec = cellblock.choose_cellblock_spec(N, K, variable=True)
    g = spec.grid_size
    grid = (g, max(8, int(np.ceil(N / g**3 * 4))))
    _, codes, spill = jax_pallas_cell_list_knn(
        jnp.asarray(pos), K, 1.0, JaxCellGrid(*grid), with_codes=True,
        codes_only=True, interpret=True,
    )
    cap = codes_packing_cap(N, K, CellGrid(*grid))
    nbr = knn_periodic(torch.from_numpy(pos), K, 1.0).numpy()
    return spec, pos, np.array(codes), spill, cap, nbr


def _torch_spill(spill):
    return None if spill is None else tuple(torch.from_numpy(np.array(s)) for s in spill)


def _assert_plans_equal(plan, jplan, with_reverse):
    fields = PLAN_FIELDS + (("s_rev_table", "reverse_mismatch") if with_reverse else ())
    for field in fields:
        want = np.asarray(getattr(jplan, field))
        got = getattr(plan, field).numpy()
        assert got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("n,k", [(2048, 16), (4096, 16), (65536, 16), (500000, 32),
                                 (3000, 5)])
def test_variable_spec_choice_matches_jax(n, k):
    spec = cellblock.choose_cellblock_spec(n, k, variable=True)
    jspec = jcb.choose_cellblock_spec(n, k, variable=True)
    assert tuple(spec) == tuple(jspec)
    spec.validate()
    assert spec.variable and spec.slot_budget % spec.query_block == 0
    for prop in ("num_slots", "pack_slots", "num_tiles", "num_padded", "s_width",
                 "rev_lanes"):
        assert getattr(spec, prop) == getattr(jspec, prop), prop
    with pytest.raises(ValueError):  # the budget must be a QB multiple
        spec._replace(slot_budget=spec.slot_budget + 1).validate()
    if spec.window % 16 == 0:
        with pytest.raises(ValueError):  # the window a 16-multiple
            spec._replace(window=spec.window + 8).validate()


@pytest.mark.parametrize("with_reverse", [False, True])
def test_variable_codes_plan_matches_jax(with_reverse):
    """The codes route: K2's plain version (the rollout plan, JAX's fused
    decode kernel) and, with the reverse table, the training plan (JAX's
    decoded sender packs and ``_reverse_table_kernel``)."""
    spec, pos, codes, spill, cap, _ = _frame()
    jplan = jcb.build_cellblock(
        jnp.asarray(pos), None, 1.0, jcb.CellBlockSpec(*spec), s_build="kernel",
        with_reverse=with_reverse, neighbor_codes=jnp.asarray(codes), codes_cap=cap,
        codes_spill=spill,
    )
    plan = cellblock.build_cellblock(
        torch.from_numpy(pos), None, 1.0, spec, with_reverse=with_reverse,
        neighbor_codes=torch.from_numpy(codes), codes_cap=cap,
        codes_spill=_torch_spill(spill),
    )
    _assert_plans_equal(plan, jplan, with_reverse)
    assert int(plan.overflow) == 0 and int(plan.dropped_edges) == 0
    assert int(plan.s_table.sum(dtype=torch.int64)) == N * K
    if with_reverse:
        assert int(plan.reverse_mismatch) == 0
    # The layout's own maps: every particle has a slot, reserve slots past
    # the last prefix none, and each tile lies in one column.
    layout = cellblock.cellblock_layout(torch.from_numpy(pos), 1.0, spec)
    used = layout.particle_of_slot < N
    assert int(used.sum()) == N
    assert torch.equal(layout.slot_col[::spec.query_block].int(), layout.tile_col)


def test_variable_aux_plan_matches_jax():
    """The aux route (plans from neighbor ids), with the reverse table."""
    spec, pos, _, _, _, nbr = _frame()
    jplan = jcb.build_cellblock(jnp.asarray(pos), jnp.asarray(nbr), 1.0,
                                jcb.CellBlockSpec(*spec), s_build="kernel", with_reverse=True)
    plan = cellblock.build_cellblock(torch.from_numpy(pos), torch.from_numpy(nbr), 1.0, spec,
                                     with_reverse=True)
    _assert_plans_equal(plan, jplan, True)
    assert int(plan.reverse_mismatch) == 0


def test_variable_budget_overflow_is_loud():
    """A budget too small for the data: columns past the clamped prefix own
    no slots, and their particles count in ``overflow`` exactly as in JAX;
    the aggregation still runs (overflowed rows read the last slot row)."""
    spec, pos, codes, spill, cap, _ = _frame()
    tight = spec._replace(slot_budget=(N // 2) // spec.query_block * spec.query_block)
    tight.validate()
    jplan = jcb.build_cellblock(
        jnp.asarray(pos), None, 1.0, jcb.CellBlockSpec(*tight), s_build="kernel",
        neighbor_codes=jnp.asarray(codes), codes_cap=cap, codes_spill=spill,
    )
    plan = cellblock.build_cellblock(
        torch.from_numpy(pos), None, 1.0, tight, neighbor_codes=torch.from_numpy(codes),
        codes_cap=cap, codes_spill=_torch_spill(spill),
    )
    _assert_plans_equal(plan, jplan, False)
    assert int(plan.overflow) >= N // 2
    z = torch.randn(N, 8, generator=torch.Generator().manual_seed(3))
    out = cellblock.cellblock_aggregate(z[plan.order], plan, tight, carry_dtype=torch.float32)
    assert bool(torch.isfinite(out).all())


def test_variable_slot_aggregation_and_backward_match_jax():
    """Expand once, the slot-space aggregation (K4's plain version; its
    backward K4^T over the reverse table), compact once, against JAX's, and
    both against the gather-sum over the neighbor ids."""
    spec, pos, codes, spill, cap, nbr = _frame()
    jspec = jcb.CellBlockSpec(*spec)
    jplan = jcb.build_cellblock(
        jnp.asarray(pos), None, 1.0, jspec, s_build="kernel", with_reverse=True,
        neighbor_codes=jnp.asarray(codes), codes_cap=cap, codes_spill=spill,
    )
    plan = cellblock.build_cellblock(
        torch.from_numpy(pos), None, 1.0, spec, with_reverse=True,
        neighbor_codes=torch.from_numpy(codes), codes_cap=cap,
        codes_spill=_torch_spill(spill),
    )
    z = np.random.default_rng(9).standard_normal((N, 16)).astype(np.float32)
    w = np.random.default_rng(10).standard_normal(16).astype(np.float32)
    z_sorted = z[np.asarray(jplan.order)]

    def jax_loss(x):
        out = jcb.cellblock_aggregate_slots(jcb.expand_to_slots(x, jplan), jplan, jspec,
                                            carry_dtype=jnp.float32, interpret=True)
        return jnp.sum(jcb.compact_from_slots(out, jplan) ** 2 @ jnp.asarray(w))

    jval, jgrad = jax.value_and_grad(jax_loss)(jnp.asarray(z_sorted))
    x = torch.from_numpy(z_sorted).requires_grad_(True)
    out = cellblock.compact_from_slots(cellblock.cellblock_aggregate_slots(
        cellblock.expand_to_slots(x, plan), plan, spec, carry_dtype=torch.float32), plan)
    loss = ((out ** 2) @ torch.from_numpy(w)).sum()
    (grad,) = torch.autograd.grad(loss, x)
    nbr_sorted = cellblock.sort_neighbors(torch.from_numpy(nbr), plan.order)
    ref = cellblock.reference_cellblock_aggregate(x.detach(), nbr_sorted)
    torch.testing.assert_close(out.detach(), ref, atol=AGG_ATOL, rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
