"""The port's fused dense-query search (``build_cellblock(dense_search=...)``:
the plain path of kernel K8, its inputs and the rebase of its lanes into S)
and the hybrid rollout with ``cellblock_search="dense"``, held against the
JAX package on identical numpy inputs. JAX's ``_dense_select_kernel`` runs
in interpret mode.

Tolerances, with the errors measured on this CPU:
* On positions from the 2^-10 lattice, planned on grid 8 (a dyadic cell
  edge, so the window margins are exact too), every difference, square and
  sum is exact in float32: S, ``search_excess``, ``search_window_overflow``,
  ``overflow``, ``dropped_edges`` and ``order`` bit-equal, ties included.
* On continuous positions (box 1 and box 3.7) XLA:CPU may contract JAX's
  interpret-mode ``a**2 + b**2`` into FMAs, which the port (and K8) never
  does: the neighbor sets decoded from S equal, ``search_window_overflow``
  equal, ``search_excess`` within 4 float32 ulps of the largest k-th
  distance (measured at most 3 ulps, at box 3.7; S itself measured
  bit-equal).
* A window that truncates (``DenseSearchSpec(16, 128)`` on the coarser
  grid 4 with a cluster stretched along one column): the neighbor sets
  decoded from S and ``search_window_overflow`` equal, the latter positive.
* ``with_reverse``: S_rev bit-equal, ``reverse_mismatch`` 0 where the plan
  is certified.
* The dense rollout against JAX's: coordinates and temperatures within
  ``COORD_ATOL = 1e-5`` (as ``test_torch_cellblock_rollout.py``; measured
  at most 3.6e-7), certificates equal every step.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu.ops import cellblock as jcb
from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.ops import cellblock
from test_torch_cellblock_rollout import COORD_ATOL, METADATA, N, STEPS, _setup
from test_torch_knn import _close_ulps

NP, K = 2048, 8  # tests/test_dense_search.py's size


def _positions(name):
    rng = np.random.default_rng(7)
    if name == "lattice":
        return (rng.integers(0, 1024, (NP, 3)) / 1024).astype(np.float32), 1.0
    if name == "box37":
        return (3.7 * rng.random((NP, 3))).astype(np.float32), 3.7
    pos = rng.random((NP, 3))
    if name == "truncating":
        # 120 particles in one column, stretched along z over a cell: the
        # windows of its tiles outgrow w_eff.
        pos[:120, :2] = 0.3 + 0.05 * rng.random((120, 2))
        pos[:120, 2] = 0.3 + 0.25 * rng.random(120)
    return pos.astype(np.float32), 1.0


# name: (the spec chooser's (N, k): the k-NN grid 7, grid 8 or the coarser
# grid 4, bit-exact)
FRAMES = {
    "uniform": ((NP, K), False),
    "lattice": ((2 * NP, K), True),
    "box37": ((NP, K), False),
    "truncating": ((NP, None), False),
}


@functools.cache
def _plans(name, with_reverse):
    pos, box = _positions(name)
    chooser, _ = FRAMES[name]
    jspec = jcb.choose_cellblock_spec(*chooser)
    dspec = (jcb.DenseSearchSpec(16, 128) if name == "truncating"
             else jcb.choose_dense_search_spec(NP, jspec))
    jplan = jcb.build_cellblock(jnp.asarray(pos), None, box, jspec, with_reverse=with_reverse,
                                s_build="kernel", dense_search=dspec, num_neighbors=K,
                                interpret=True)
    tspec = cellblock.CellBlockSpec(*jspec[:6])
    kernels.reset_launches()
    plan = cellblock.build_cellblock(torch.from_numpy(pos), None, box, tspec,
                                     with_reverse=with_reverse,
                                     dense_search=cellblock.DenseSearchSpec(*dspec), num_neighbors=K)
    assert not any(kernels.launches.values())  # the CPU runs the plain versions
    return tspec, jplan, plan


def _neighbor_sets(spec, plan):
    """Per particle (original order), the sorted sender ids S names (-1 for
    an entry on an unused padded row, which an uncertified plan can hold)."""
    order = plan.order.numpy()
    n = order.shape[0]
    pos_of_slot = np.append(plan.particle_of_slot.numpy(), n)
    pad_src = plan.pad_src.numpy()
    starts = plan.window_starts.numpy()
    s_table = plan.s_table.numpy()
    ids = np.append(order, -1)
    sets = {}
    for slot, lanes in zip(*np.nonzero(s_table)):
        if pos_of_slot[slot] >= n:
            continue
        j, off = divmod(lanes, spec.window)
        sender = ids[pos_of_slot[pad_src[starts[slot // spec.query_block, j] + off]]]
        sets.setdefault(int(order[pos_of_slot[slot]]), []).extend(
            [int(sender)] * int(s_table[slot, lanes]))
    return {q: sorted(v) for q, v in sets.items()}


def _jax_as_torch(jplan):
    return jcb.CellBlockGraph(**{f: (None if getattr(jplan, f) is None
                                     else torch.from_numpy(np.array(getattr(jplan, f))))
                                 for f in jplan._fields})


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_dense_plan_matches_jax(name):
    tspec, jplan, plan = _plans(name, False)
    _, bit_exact = FRAMES[name]
    for field in ("order", "overflow", "window_overflow", "search_window_overflow"):
        np.testing.assert_array_equal(getattr(plan, field).numpy(),
                                      np.asarray(getattr(jplan, field)), err_msg=field)
    excess, j_excess = float(plan.search_excess), float(jplan.search_excess)
    if bit_exact:
        np.testing.assert_array_equal(plan.s_table.numpy(), np.asarray(jplan.s_table))
        assert int(plan.dropped_edges) == int(jplan.dropped_edges)
        assert excess == j_excess
    else:
        assert _neighbor_sets(tspec, plan) == _neighbor_sets(tspec, _jax_as_torch(jplan))
        # The k-th distances reach (1.5 cell edges)^2.
        _, box = _positions(name)
        _close_ulps(excess, j_excess, 2.25 * (box / tspec.grid_size) ** 2)
    if name == "truncating":
        assert int(plan.search_window_overflow) > 0
    else:
        assert int(plan.search_window_overflow) == 0 and excess <= 0
        assert int(plan.overflow) == 0 and int(plan.dropped_edges) == 0


@pytest.mark.parametrize("name", ["uniform", "lattice"])
def test_dense_plan_reverse_table_matches_jax(name):
    _, jplan, plan = _plans(name, True)
    for field in ("s_table", "s_rev_table", "reverse_mismatch", "dropped_edges"):
        np.testing.assert_array_equal(getattr(plan, field).numpy(),
                                      np.asarray(getattr(jplan, field)), err_msg=field)
    assert int(plan.reverse_mismatch) == 0
    assert int(plan.s_rev_table.sum(dtype=torch.int64)) == NP * K


def test_dense_neighbor_sets_are_the_exact_knn():
    """On uniform data the certified dense plan names each particle's k
    nearest neighbors (brute force), each once."""
    from cosmology_gnn_simulation_tpu_torch.ops.neighbors import knn_periodic

    tspec, _, plan = _plans("uniform", False)
    pos, box = _positions("uniform")
    ref = knn_periodic(torch.from_numpy(pos), K, box).numpy()
    sets = _neighbor_sets(tspec, plan)
    assert len(sets) == NP
    assert all(sets[q] == sorted(ref[q].tolist()) for q in range(NP))


def test_dense_select_plain_version_orders_ties_by_lane():
    """K8's plain version on a hand-made tile: the k smallest (d^2, lane) in
    ascending order, equal distances by the smaller lane, and the periodic
    shift applied to a window's x."""
    w_eff, ccp, k = 4, 8, 5
    table = torch.zeros(2, 3, ccp)
    table[1, 0] = torch.arange(ccp, dtype=torch.float32)  # column 1: x = row
    windows = torch.zeros(1, 9, 4, dtype=torch.int32)
    windows[0, :, 0] = 1  # every ring column reads column 1 from row 0
    windows[0, 0, 2] = -1  # ring column 0: x shifted by -box
    queries = torch.zeros(8, 3)
    queries[0, 0] = 1.5  # rows 1 and 2 of each window at d^2 = 0.25
    lanes, kth = cellblock.dense_select(table, queries, windows, 10.0, torch.tensor([8]), k=k,
                                        query_block=8, w_eff=w_eff)
    # Ring column 0's rows sit at x - 10: its lanes 1 and 2 come last.
    assert lanes[0].tolist() == [5, 6, 9, 10, 13]
    assert float(kth[0]) == 0.25


def test_dense_rollout_matches_jax():
    from cosmology_gnn_simulation_tpu.rollout import rollout as jax_rollout
    from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
    from cosmology_gnn_simulation_tpu_torch.rollout import rollout
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

    jcfg, tcfg, jparams, tparams, pos, temp = _setup(seed=5)
    ref = jax_rollout(
        jparams, jcfg, jnp.asarray(pos), jnp.asarray(temp), JaxStats.from_metadata(METADATA),
        STEPS, num_neighbors=16, aggregation="cellblock_hybrid", cellblock_search="dense")
    kernels.reset_launches()
    out = rollout(tparams, tcfg, pos, temp, NormalizationStats.from_metadata(METADATA,
                                                                             device="cpu"),
                  STEPS, num_neighbors=16, aggregation="cellblock_hybrid",
                  cellblock_search="dense", device="cpu")
    assert not any(kernels.launches.values())
    assert out["Coordinates"].shape == (5 + STEPS, N, 3)
    np.testing.assert_array_equal(out["neighbor_exactness"].numpy(),
                                  np.asarray(ref["neighbor_exactness"]))
    assert bool(out["neighbor_exactness"].all())
    for key in ("Coordinates", "InternalEnergy"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=COORD_ATOL,
                                   rtol=0)


def test_dense_search_options_that_are_refused():
    from cosmology_gnn_simulation_tpu_torch.rollout import rollout
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

    _, tcfg, _, tparams, pos, temp = _setup()
    stats = NormalizationStats.from_metadata(METADATA, device="cpu")
    spec = cellblock.choose_cellblock_spec(N, 16)
    kw = dict(aggregation="cellblock_hybrid", device="cpu")
    with pytest.raises(ValueError, match="uniform cubic"):
        rollout(tparams, tcfg, pos, temp, stats, 1, cellblock_search="dense",
                cellblock_spec=spec._replace(slot_budget=1024), **kw)
    with pytest.raises(ValueError, match="cellblock_search"):
        rollout(tparams, tcfg, pos, temp, stats, 1, cellblock_search="nope", **kw)
    tpos = torch.from_numpy(pos[-1])
    dspec = cellblock.DenseSearchSpec()
    with pytest.raises(ValueError, match="num_neighbors"):
        cellblock.build_cellblock(tpos, None, 1.0, spec, dense_search=dspec)
    with pytest.raises(ValueError, match="replaces the neighbor search"):
        cellblock.build_cellblock(tpos, torch.zeros(N, 16, dtype=torch.long), 1.0, spec,
                                  dense_search=dspec, num_neighbors=16)
    for bad in (cellblock.DenseSearchSpec(12, 128), cellblock.DenseSearchSpec(16, 100)):
        with pytest.raises(ValueError):
            cellblock.build_cellblock(tpos, None, 1.0, spec, dense_search=bad, num_neighbors=16)
