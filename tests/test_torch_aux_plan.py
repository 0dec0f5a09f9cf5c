"""The port's plans from neighbor ids (the aux path) held against the JAX
package on identical numpy inputs: the cell-list kernel's dual mode K1''
(ids and codes together, its plain path), the plain cell list
(``neighbor_method="celllist"``), ``build_cellblock`` from ids, the hybrid
rollout that plans from ids (brute force below 8192 particles, or a spec on
another grid than the k-NN's, where JAX and the port run K1''), and one
hybrid train step on that route.

Tolerances, with the errors measured on this CPU:
* K1'' on the 2^-10 lattice (``test_torch_knn.py``'s frames): ids, codes,
  overflow, ``max_d2`` and ``max_excess`` bit-equal, ties included. On
  continuous positions: neighbor sets equal, codes equal wherever the ids
  are (measured: all rows equal in order), the certificate equal, the two
  distance reductions within 4 float32 ulps of ``max_d2`` (XLA:CPU
  contracts JAX's interpret-mode ``d2 + delta * delta`` into FMAs; measured
  at most 1 ulp).
* The plain cell list against JAX's XLA cell list: sets, overflow and the
  certificate equal, distances within 4 ulps (the same contraction;
  measured 0).
* The aux plan is integer arithmetic on the ids: ``order``, S, S_rev,
  ``dropped_edges``, ``overflow``, ``window_overflow`` and
  ``reverse_mismatch`` bit-equal to JAX ``build_cellblock(..., s_build=
  "kernel", interpret=True)``.
* Rollouts: coordinates and temperatures within ``COORD_ATOL = 1e-5`` (as
  ``test_torch_cellblock_rollout.py``: exact products, float32 sums in
  another order; measured at most 1.8e-7), certificates equal every step.
* The train step: ``test_torch_training.py``'s tolerances (loss 1e-6
  relative in float32, 1e-3 in bf16; gradients 3e-5 and 2e-2 of each
  leaf's largest magnitude; measured: loss 0 and 8.4e-7, gradients 1.9e-6
  and 3.3e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosmology_gnn_simulation_tpu.ops.pallas_knn as jax_pallas_knn
from cosmology_gnn_simulation_tpu.ops import cellblock as jcb
from cosmology_gnn_simulation_tpu.ops.cell_list import (
    CellGrid as JaxCellGrid,
    cell_list_knn as jax_cell_list_knn,
)
from cosmology_gnn_simulation_tpu.ops.neighbors import knn_periodic as jax_knn_periodic
from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.featurize import neighbor_search_certified
from cosmology_gnn_simulation_tpu_torch.ops import cellblock
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import (
    NEIGHBOR_OFFSETS,
    CellGrid,
    cell_list_knn,
    choose_cell_grid,
)
from cosmology_gnn_simulation_tpu_torch.ops.pallas_knn import (
    build_table,
    codes_packing_cap,
    pallas_cell_list_knn,
)
from test_torch_cellblock_rollout import COORD_ATOL, METADATA, N, STEPS, _setup
from test_torch_knn import (
    _close_ulps,
    _lattice,
    _lattice_grid,
    _sets_equal,
    _spill,
    _uniform,
)
from test_torch_training import (
    _batch,
    _models,
    assert_step_matches,
    jax_step_grads,
    port_step_grads,
)

# name: (positions, k, grid spec or None for choose_cell_grid, bit-exact)
DUAL_CASES = {
    "uniform": (lambda: _uniform(0, 3000), 8, None, False),
    "spill": (lambda: _spill(1234), 8, (8, 16), False),
    "lattice": (lambda: _lattice(11, 4096), 8, _lattice_grid(4096), True),
    "lattice_spill": (lambda: _lattice(12, 4096, cram=40), 8, _lattice_grid(4096), True),
}


@functools.cache
def _dual(case):
    make, k, grid_spec, _ = DUAL_CASES[case]
    pos = make()
    grid = CellGrid(*grid_spec) if grid_spec else choose_cell_grid(pos.shape[0], k)
    want = jax_pallas_knn.pallas_cell_list_knn(
        jnp.asarray(pos), k, 1.0, JaxCellGrid(*grid), return_diagnostics=True,
        with_codes=True, interpret=True)
    got = pallas_cell_list_knn(torch.from_numpy(pos), k, 1.0, grid, return_diagnostics=True,
                               with_codes=True)
    return want, got


@pytest.mark.parametrize("case", sorted(DUAL_CASES))
def test_knn_dual_plain_matches_jax_with_codes(case):
    (jids, jcodes, jspill, jdiag), (ids, codes, spill, diag) = _dual(case)
    jids, jcodes = np.asarray(jids), np.asarray(jcodes)
    assert ids.dtype == torch.int64 and codes.dtype == torch.int32
    assert (spill is None) == (jspill is None)
    if spill is not None:
        for a, b in zip(spill, jspill):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    overflow, max_d2, max_excess = (float(x) for x in diag)
    j_overflow, j_max_d2, j_max_excess = (float(x) for x in jdiag)
    assert overflow == j_overflow
    if DUAL_CASES[case][3]:
        np.testing.assert_array_equal(ids.numpy(), jids)
        np.testing.assert_array_equal(codes.numpy(), jcodes)
        assert (max_d2, max_excess) == (j_max_d2, j_max_excess)
    else:
        _sets_equal(ids.numpy(), jids)
        same = ids.numpy() == jids
        np.testing.assert_array_equal(codes.numpy()[same], jcodes[same])
        _close_ulps(max_d2, j_max_d2, j_max_d2)
        _close_ulps(max_excess, j_max_excess, j_max_d2)
    assert (overflow == 0 and max_excess <= 0) == (j_overflow == 0 and j_max_excess <= 0)


def test_knn_dual_codes_name_each_neighbor():
    """A dual-mode code is the lane of its pick: its neighbor-cell offset
    and in-cell rank, read in the cell table, give back the picked id."""
    _, (ids, codes, _, _) = _dual("uniform")
    pos = torch.from_numpy(_uniform(0, 3000))
    k = 8
    grid = choose_cell_grid(pos.shape[0], k)
    g, cap = grid.grid_size, codes_packing_cap(pos.shape[0], k, grid)
    table = build_table(pos, g, cap, torch.tensor(1.0))
    codes = codes.long()
    assert bool((codes < 27 * cap).all())  # no spilled particle in this frame
    j27, rank = codes // cap, codes % cap
    offsets = torch.tensor(NEIGHBOR_OFFSETS)[j27]  # [N, k, 3]
    cell = table.cell_id
    qc = torch.stack([cell // (g * g), (cell // g) % g, cell % g], dim=-1)
    nc = torch.remainder(qc[:, None, :] + offsets, g)
    ncell = (nc[..., 0] * g + nc[..., 1]) * g + nc[..., 2]
    assert torch.equal(table.ids[ncell, rank].long(), ids)


def test_cell_list_knn_matches_jax():
    pos = _uniform(5, 3000)
    k = 8
    grid = choose_cell_grid(pos.shape[0], k)
    jidx, (j_overflow, j_max_d2, j_excess) = jax_cell_list_knn(
        jnp.asarray(pos), k, 1.0, JaxCellGrid(*grid), return_diagnostics=True)
    idx, (overflow, max_d2, excess) = cell_list_knn(torch.from_numpy(pos), k, 1.0, grid,
                                                    query_tile=1024, return_diagnostics=True)
    _sets_equal(idx.numpy(), np.asarray(jidx))
    assert int(overflow) == int(j_overflow) == 0
    _close_ulps(float(max_d2), float(j_max_d2), float(j_max_d2))
    _close_ulps(float(excess), float(j_excess), float(j_max_d2))
    found, exact = neighbor_search_certified(torch.from_numpy(pos), k, 1.0, method="celllist")
    assert torch.equal(found, idx) and bool(exact) == (float(j_excess) <= 0)


PLAN_FIELDS = ("order", "s_table", "overflow", "dropped_edges", "window_overflow")


def _plan_frame(name):
    """Positions, ids (JAX brute force) and a JAX spec: the k-NN grid's spec,
    a coarser grid's, and the coarser grid with a crammed cluster (column
    overflow) and ids no search would give: one column of random particles
    (senders outside the 3x3 ring: dropped edges) and one of the no-edge
    sentinel N."""
    rng = np.random.default_rng(21)
    n, k = 2048, 8
    pos = rng.uniform(0, 1, (n, 3))
    if name == "cram":
        pos[:300] = 0.3 + 0.04 * rng.uniform(0, 1, (300, 3))
    pos = pos.astype(np.float32)
    ids = np.array(jax_knn_periodic(jnp.asarray(pos), k, 1.0))
    if name == "cram":
        ids[:, 3] = rng.integers(0, n, n)
        ids[:, 5] = n
    spec = jcb.choose_cellblock_spec(n, k) if name == "knn_grid" else jcb.choose_cellblock_spec(n)
    return pos, ids, spec


@pytest.mark.parametrize("with_reverse", [False, True])
@pytest.mark.parametrize("name", ["knn_grid", "coarse", "cram"])
def test_aux_plan_matches_jax(name, with_reverse):
    pos, ids, jspec = _plan_frame(name)
    jplan = jcb.build_cellblock(jnp.asarray(pos), jnp.asarray(ids), 1.0, jspec,
                                with_reverse=with_reverse, s_build="kernel", interpret=True)
    tspec = cellblock.CellBlockSpec(*jspec[:6])
    plan = cellblock.build_cellblock(torch.from_numpy(pos), torch.from_numpy(ids), 1.0, tspec,
                                     with_reverse=with_reverse)
    fields = PLAN_FIELDS + (("s_rev_table", "reverse_mismatch") if with_reverse else ())
    for field in fields:
        np.testing.assert_array_equal(getattr(plan, field).numpy(),
                                      np.asarray(getattr(jplan, field)), err_msg=field)
    assert plan.search_excess is None and plan.search_window_overflow is None
    if name == "cram":
        assert int(plan.overflow) > 0 and int(plan.dropped_edges) > 0
    else:
        assert int(plan.overflow) == 0 and int(plan.dropped_edges) == 0
        if with_reverse:
            assert int(plan.reverse_mismatch) == 0


def test_codes_win_over_ids_as_in_jax():
    """Given both, build_cellblock takes the codes path (the same S here)."""
    pos, ids, jspec = _plan_frame("knn_grid")
    tspec = cellblock.CellBlockSpec(*jspec[:6])
    tpos = torch.from_numpy(pos)
    grid = choose_cell_grid(pos.shape[0], 8)
    _, codes, spill = pallas_cell_list_knn(tpos, 8, 1.0, grid, codes_only=True)
    kw = dict(neighbor_codes=codes, codes_cap=codes_packing_cap(pos.shape[0], 8, grid),
              codes_spill=spill)
    both = cellblock.build_cellblock(tpos, torch.zeros_like(torch.from_numpy(ids)), 1.0, tspec,
                                     **kw)
    codes_only = cellblock.build_cellblock(tpos, None, 1.0, tspec, **kw)
    from_ids = cellblock.build_cellblock(tpos, torch.from_numpy(ids), 1.0, tspec)
    assert torch.equal(both.s_table, codes_only.s_table)
    assert torch.equal(both.s_table, from_ids.s_table)


# name: (route, compute dtype, fused tail)
ROLLOUTS = {
    "bruteforce_f32": ("bruteforce", None, False),
    "coarse_spec_f32": ("coarse", None, False),
}


@pytest.mark.parametrize("case", sorted(ROLLOUTS))
def test_aux_rollout_matches_jax(case, monkeypatch):
    route, dtype, fused = ROLLOUTS[case]
    monkeypatch.setattr(
        jax_pallas_knn, "pallas_cell_list_knn",
        functools.partial(jax_pallas_knn.pallas_cell_list_knn, interpret=True),
    )
    from cosmology_gnn_simulation_tpu.rollout import rollout as jax_rollout
    from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
    from cosmology_gnn_simulation_tpu_torch.rollout import rollout
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

    jcfg, tcfg, jparams, tparams, pos, temp = _setup(seed=4)
    jkw, tkw = {}, {}
    if route == "bruteforce":
        jkw["neighbor_method"] = tkw["neighbor_method"] = "bruteforce"
    else:
        # A spec on another grid than the k-NN's: K1'' searches (its codes
        # are dropped) and the plan is built from the ids.
        spec = jcb.choose_cellblock_spec(N)
        assert spec.grid_size != choose_cell_grid(N, 16).grid_size
        jkw = dict(neighbor_method="pallas", cellblock_spec=spec)
        tkw = dict(neighbor_method="pallas", cellblock_spec=cellblock.CellBlockSpec(*spec[:6]))
    ref = jax_rollout(
        jparams, jcfg, jnp.asarray(pos), jnp.asarray(temp), JaxStats.from_metadata(METADATA),
        STEPS, num_neighbors=16, dtype=None if dtype is None else jnp.dtype(dtype),
        aggregation="cellblock_hybrid", s_build="kernel", fused_tail=fused, **jkw)
    kernels.reset_launches()
    out = rollout(tparams, tcfg, pos, temp, NormalizationStats.from_metadata(METADATA,
                                                                             device="cpu"),
                  STEPS, num_neighbors=16, dtype=None if dtype is None else getattr(torch, dtype),
                  aggregation="cellblock_hybrid", fused_tail=fused, device="cpu", **tkw)
    assert not any(kernels.launches.values())
    np.testing.assert_array_equal(out["neighbor_exactness"].numpy(),
                                  np.asarray(ref["neighbor_exactness"]))
    assert bool(out["neighbor_exactness"].all())
    for key in ("Coordinates", "InternalEnergy"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=COORD_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_aux_train_step_matches_jax(dtype):
    """Below 8192 particles brute force serves the search: no codes, so both
    packages build the hybrid plan with its reverse table from the ids."""
    jcfg, tcfg, jparams = _models(seed=3)
    batch = _batch(4096, 8)
    tc = dict(aggregation="cellblock_hybrid", neighbor_method="bruteforce", compute_dtype=dtype,
              fused_tail=dtype is not None, augment_prob=0.0, noise_std=0.0)
    jmetrics, jgrads = jax_step_grads(jcfg, jparams, batch, **tc)
    metrics, grads = port_step_grads(tcfg, jparams, batch, **tc)
    assert float(metrics["cellblock_violations"]) == float(jmetrics["cellblock_violations"]) == 0
    assert_step_matches(metrics, grads, jmetrics, jgrads, dtype)
