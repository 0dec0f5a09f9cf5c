"""The halo decomposition's single-device half held against the JAX package
on identical numpy inputs: the geometry (``choose_halo_config``,
``choose_cellblock_spec_halo``), the host partition (``partition_windows``,
``partition_batch``, ``reassemble_trajectory``), one shard's candidate set
built on the host (against JAX's boundary sends and exchange under
``shard_map`` on the virtual CPU mesh), the masked cell list with separate
queries, and one shard's open-slab cell-block plan from neighbor ids with a
validity mask, a per-dimension box and the reverse table.

N = 4,096, k = 4 (``tests/test_halo.py``'s sizes): P = 4 slabs of 2 layers
on an 8-cell grid, one halo layer each side; the slab spec has ``gx = 4``.

Tolerances, with the errors measured on this CPU:
* Geometry, partition, candidates and the plan are integer arithmetic or
  copies: equal, bit for bit (``order``, the slot maps, ``pad_src``,
  ``window_starts``, the S-lane offsets, S, S_rev, ``overflow``,
  ``dropped_edges``, ``window_overflow``, ``reverse_mismatch``).
* The masked cell list: neighbor ids and overflow equal; ``max_d2`` and
  ``max_excess`` within 4 float32 ulps (XLA:CPU contracts JAX's ``d2 +
  delta * delta`` into FMAs, ``tests/test_torch_aux_plan.py``; measured at
  most 1 ulp). A row without candidates gets 0 and keeps ``+inf``.
* The aggregation and its VJP against JAX's ``cellblock_aggregate`` (its
  window kernel in interpret mode), float32 carry:
  ``test_torch_cellblock_variable.py``'s ``AGG_ATOL``, ``GRAD_RTOL`` and
  ``GRAD_ATOL`` (float32 sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from cosmology_gnn_simulation_tpu.ops import cellblock as jcb
from cosmology_gnn_simulation_tpu.ops.cell_list import (
    CellGrid as JaxCellGrid,
    cell_list_knn as jax_cell_list_knn,
)
from cosmology_gnn_simulation_tpu.parallel import halo as jhalo
from cosmology_gnn_simulation_tpu_torch.ops import cellblock
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import CellGrid, cell_list_knn
from cosmology_gnn_simulation_tpu_torch.parallel import halo
from test_torch_cellblock_variable import AGG_ATOL, GRAD_ATOL, GRAD_RTOL
from test_torch_knn import _close_ulps

N, K, P, BOX = 4096, 4, 4, 1.0


def _windows(n, seed, frames=6):
    rng = np.random.default_rng(seed)
    pos = np.remainder(rng.uniform(0, 1, (1, n, 3))
                       + rng.normal(0, 5e-4, (frames, n, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = (1.0 + rng.normal(0, 1e-3, (frames, n, 1)).cumsum(0)).astype(np.float32)
    return pos, temp


@functools.cache
def _shard(shard):
    """Shard ``shard``'s candidates (positions, valid), its owned rows, the
    halo config and the slab spec, from partition_windows of a seeded
    frame."""
    pos, temp = _windows(N, 3)
    hc = halo.choose_halo_config(N, K, P)
    part = halo.partition_windows(pos[:5], temp[:5], hc, BOX)
    recent, valid = part["positions"][-1], part["valid"]
    cand, cand_valid, overflow = halo.shard_candidates(recent, valid, hc, BOX, shard)
    own = recent[shard * hc.local_capacity:(shard + 1) * hc.local_capacity]
    spec = cellblock.choose_cellblock_spec_halo(N, hc.grid_size, hc.slab_layers,
                                                hc.halo_layers, P, h_block=128)
    return cand, cand_valid, overflow, own, hc, spec


# (num_particles, k, num_shards, options): the uniform plans, the noised
# one (two halo layers), a coarser slab, config 5 (N = 2,000,000 over 8)
# and the plans sized from a measured frame (a clustered one too).
CONFIGS = {
    "uniform": (N, K, 4, {}),
    "two_shards": (N, K, 2, {}),
    "noise": (N, K, 2, {"noise": True}),
    "coarse": (N, K, 2, {"slab_layers": 2}),
    "config5": (2_000_000, 16, 8, {}),
    "measured": (N, K, 4, {"positions": "uniform"}),
    "measured_clustered": (N, K, 4, {"positions": "clustered"}),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_halo_geometry_matches_jax(name):
    n, k, p, opts = CONFIGS[name]
    if "positions" in opts:
        frame = _windows(n, 5)[0][-1]
        if opts["positions"] == "clustered":
            frame[: n // 4] = 0.3 + 0.05 * frame[: n // 4]
        opts = {**opts, "positions": frame}
    hc = halo.choose_halo_config(n, k, p, **opts)
    assert tuple(hc) == tuple(jhalo.choose_halo_config(n, k, p, **opts))
    assert hc.candidate_count == hc.local_capacity + 2 * hc.halo_capacity
    args = (n, hc.grid_size, hc.slab_layers, hc.halo_layers, p)
    for kw in ({}, {"h_block": 128}, {"query_block": 64}):
        spec = cellblock.choose_cellblock_spec_halo(*args, **kw)
        assert tuple(spec) == tuple(jcb.choose_cellblock_spec_halo(*args, **kw))
        spec.validate()
        assert spec.gx == hc.slab_layers + 2 * hc.halo_layers and not spec.periodic_x
        assert spec.num_columns == spec.gx * hc.grid_size
    if name == "config5":
        # One shard of BASELINE config 5: G = 56, 7 slab layers, gx = 9.
        spec = cellblock.choose_cellblock_spec_halo(*args)
        assert (hc.grid_size, hc.slab_layers, hc.halo_layers) == (56, 7, 1)
        assert hc.candidate_count == 467_864 and spec.num_slots == 387_072
        assert (spec.col_capacity, spec.query_block, spec.window, spec.gx) == (768, 256, 384, 9)


def test_halo_geometry_refusals_match_jax():
    for args, kw, match in (((N, K, 1), {}, "num_shards"), ((256, 16, 8), {}, "slabs"),
                            ((N, K, 2), {"slab_layers": 7}, "FINER")):
        for chooser in (halo.choose_halo_config, jhalo.choose_halo_config):
            with pytest.raises(ValueError, match=match):
                chooser(*args, **kw)
    spec = cellblock.choose_cellblock_spec_halo(N, 8, 2, 1, 4)
    for bad, match in ((spec._replace(grid_x=2), "grid_x"),
                       (spec._replace(grid_x=0), "explicit grid_x"),
                       (spec._replace(slot_budget=spec.num_slots), "cubic-periodic")):
        with pytest.raises(ValueError, match=match):
            bad.validate()


def test_partition_and_reassembly_match_jax():
    pos, temp = _windows(N, 7, frames=12)
    hc = halo.choose_halo_config(N, K, 4)
    kw = dict(target_position=pos[5], target_temperature=temp[5])
    got = halo.partition_windows(pos[:5], temp[:5], hc, BOX, **kw)
    want = jhalo.partition_windows(pos[:5], temp[:5], hc, BOX, **kw)
    assert sorted(got) == sorted(want)
    for key in got:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    batch = {"positions": np.stack([pos[i:i + 5] for i in range(3)]),
             "temperatures": np.stack([temp[i:i + 5] for i in range(3)]),
             "target_positions": np.stack([pos[i + 5] for i in range(3)]),
             "target_temperatures": np.stack([temp[i + 5] for i in range(3)])}
    for rng_seed in (None, 11):
        rngs = [None if rng_seed is None else np.random.default_rng(rng_seed) for _ in range(2)]
        got = halo.partition_batch(batch, hc, BOX, augment_prob=0.7, rng=rngs[0])
        want = jhalo.partition_batch(batch, hc, BOX, augment_prob=0.7, rng=rngs[1])
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # A rollout's per-slot outputs (the partitioned frames, shuffled in
    # time) back in particle order.
    steps = 3
    outs = {"positions": got["positions"][0, :steps], "temperatures": got["temperatures"][0, :steps],
            "valid": np.broadcast_to(got["valid"][0], (steps,) + got["valid"][0].shape),
            "gid": np.broadcast_to(got["gid"][0], (steps,) + got["gid"][0].shape)}
    traj = halo.reassemble_trajectory(outs, pos[:5], temp[:5])
    jtraj = jhalo.reassemble_trajectory(outs, pos[:5], temp[:5])
    for key in jtraj:
        np.testing.assert_array_equal(traj[key], jtraj[key], err_msg=key)
    with pytest.raises(ValueError, match="local_capacity"):
        halo.partition_windows(pos[:5], temp[:5], hc._replace(local_capacity=8), BOX)


def test_shard_candidates_match_jax_exchange():
    """The host mirror of one shard's exchange against JAX's boundary sends
    and ppermutes over a 4-device mesh, every shard (shard 0's left halo
    wraps across x = 0)."""
    pos, temp = _windows(N, 3)
    hc = halo.choose_halo_config(N, K, P)
    part = halo.partition_windows(pos[:5], temp[:5], hc, BOX)
    recent, valid = part["positions"][-1], part["valid"]
    mesh = Mesh(np.array(jax.devices()[:P]), ("particle",))
    spec2, spec1 = PartitionSpec("particle", None), PartitionSpec("particle")

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(spec2, spec1),
                       out_specs=(spec2, spec1, spec1))
    def exchange(recent, valid):
        sends, overflow = jhalo._boundary_sends(jhalo._cell_x(recent, hc, BOX), valid, hc,
                                                "particle")
        payload = jnp.concatenate([recent, valid[:, None].astype(jnp.float32)], axis=-1)
        cand = jhalo.expand_candidates(payload, sends, "particle")
        return cand[:, :3], cand[:, 3] > 0.5, overflow[None]

    jpos, jvalid, _ = jax.jit(exchange)(jnp.asarray(recent), jnp.asarray(valid))
    m = hc.candidate_count
    for d in range(P):
        cand, cand_valid, overflow = halo.shard_candidates(recent, valid, hc, BOX, d)
        np.testing.assert_array_equal(cand, np.asarray(jpos)[d * m:(d + 1) * m])
        np.testing.assert_array_equal(cand_valid, np.asarray(jvalid)[d * m:(d + 1) * m])
        assert overflow == 0 and cand_valid[hc.local_capacity:].sum() > 0


def _sparse():
    """600 reference rows, 3 % of them valid, and 64 queries: rows with
    fewer than k valid candidates."""
    rng = np.random.default_rng(13)
    ref = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    valid = rng.uniform(0, 1, 600) < 0.03
    queries = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    return ref, valid, queries, (4, 64)


@pytest.mark.parametrize("case", ["shard0", "shard2", "sparse"])
def test_masked_cell_list_matches_jax(case):
    """Shard 0 (its halo wraps across x = 0); shard 2 (its padding queries,
    at the origin, see no valid candidate: ids 0, +inf); sparse (rows
    short of k repeat their nearest pick)."""
    if case == "sparse":
        ref, valid, queries, grid = _sparse()
    else:
        ref, valid, _, queries, hc, _ = _shard(int(case[-1]))
        grid = (hc.grid_size, hc.cell_capacity)
    jidx, (j_over, j_max_d2, j_excess) = jax_cell_list_knn(
        jnp.asarray(ref), K, BOX, JaxCellGrid(*grid), queries=jnp.asarray(queries),
        valid=jnp.asarray(valid), return_diagnostics=True)
    idx, (over, max_d2, excess) = cell_list_knn(
        torch.from_numpy(ref), K, BOX, CellGrid(*grid), queries=torch.from_numpy(queries),
        valid=torch.from_numpy(valid), return_diagnostics=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(over) == int(j_over) == 0
    if case == "shard0":
        assert bool(valid[idx.numpy()].all())
    if case == "shard0":
        _close_ulps(float(max_d2), float(j_max_d2), float(j_max_d2))
        _close_ulps(float(excess), float(j_excess), float(j_max_d2))
    else:  # short rows keep +inf: the certificate fails loudly
        assert float(max_d2) == float(j_max_d2) == np.inf
        assert float(excess) == float(j_excess) == np.inf
    if case == "shard2":
        empty = ~valid[:queries.shape[0]]  # padding rows query the origin
        assert empty.any() and not idx.numpy()[empty].any()
    if case == "sparse":
        assert (idx.numpy()[:, 1:] == idx.numpy()[:, :1]).any(1).any()
    # Invalid rows past the cell capacity are not counted as overflow.
    crowd = np.concatenate([ref, np.full((300, 3), 0.5, np.float32)])
    crowd_valid = np.concatenate([valid, np.zeros(300, bool)])
    _, (c_over, _, _) = cell_list_knn(torch.from_numpy(crowd), K, BOX, CellGrid(*grid),
                                      valid=torch.from_numpy(crowd_valid),
                                      return_diagnostics=True)
    assert int(c_over) == 0


def _plans(shard):
    """One shard's slab plan, with its reverse table, from the port and JAX
    on the same local-frame candidates and neighbor ids (the masked cell
    list's, the halo rows' lists the no-edge sentinel)."""
    cand, cand_valid, _, own, hc, spec = _shard(shard)
    idx = cell_list_knn(torch.from_numpy(cand), K, BOX, CellGrid(hc.grid_size, hc.cell_capacity),
                        queries=torch.from_numpy(own), valid=torch.from_numpy(cand_valid))
    m = cand.shape[0]
    nbr = np.concatenate([idx.numpy(), np.full((m - own.shape[0], K), m)])
    local, box_local = halo.slab_frame(cand, hc, spec.gx, BOX, shard)
    jspec = jcb.CellBlockSpec(*spec)
    jplan = jcb.build_cellblock(jnp.asarray(local), jnp.asarray(nbr), jnp.asarray(box_local),
                                jspec, with_reverse=True, valid=jnp.asarray(cand_valid),
                                s_build="contract")
    tensors = [torch.from_numpy(a) for a in (local, nbr, box_local, cand_valid)]
    plan = cellblock.build_cellblock(tensors[0], tensors[1], tensors[2], spec, with_reverse=True,
                                     valid=tensors[3])
    return plan, jplan, tensors, spec, jspec, own.shape[0]


_SEEN_OFFSETS = []
PLAN_FIELDS = ("order", "slot_of_sorted", "particle_of_slot", "pad_src", "window_starts",
               "s_table", "overflow", "dropped_edges", "window_overflow", "s_rev_table",
               "reverse_mismatch")


@pytest.mark.parametrize("shard", [0, 3])
def test_slab_plan_matches_jax(shard, monkeypatch):
    plan, jplan, (local, nbr, box_local, valid), spec, jspec, n_own = _plans(shard)
    for field in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(plan, field).numpy(),
                                      np.asarray(getattr(jplan, field)), err_msg=field)
    assert int(plan.overflow) == int(plan.dropped_edges) == int(plan.reverse_mismatch) == 0
    assert int(plan.s_table.sum(dtype=torch.int64)) == K * int(valid[:n_own].sum())
    # Invalid rows take no slot.
    assert not bool((plan.slot_of_sorted[int(valid.sum()):] < spec.num_slots).any())
    # The S-lane offsets: JAX's as its one-hot build receives them (the
    # traced callback outlives this call in the jit cache, so it appends to
    # a module list).
    _SEEN_OFFSETS.clear()

    def one_hot(offsets, spec_, interpret):
        jax.debug.callback(lambda o: _SEEN_OFFSETS.append(np.asarray(o)), offsets)
        lanes = jnp.arange(spec_.s_width, dtype=offsets.dtype)
        return jnp.sum(offsets[..., None] == lanes, axis=1).astype(jnp.int8)

    monkeypatch.setattr(jcb, "_s_from_offsets", one_hot)
    jcb.build_cellblock(jnp.asarray(local.numpy()), jnp.asarray(nbr.numpy()),
                        jnp.asarray(box_local.numpy()), jspec, valid=jnp.asarray(valid.numpy()),
                        s_build="kernel")
    jax.effects_barrier()
    layout = cellblock.cellblock_layout(local, box_local, spec, valid)
    offsets, _ = cellblock.aux_offsets(cellblock.aux_slot_senders(layout, nbr, spec), layout,
                                       spec)
    np.testing.assert_array_equal(offsets.numpy(), _SEEN_OFFSETS[-1])


def test_slab_aggregation_and_backward_match_jax():
    """Shard 0's plan: the hybrid aggregation (expand, K4's plain version,
    compact) and its backward (K4^T's over S_rev) against JAX's
    ``cellblock_aggregate`` and its VJP; compacted to the owned rows through
    the inverse order, against the gather-sum over the neighbor ids."""
    plan, jplan, (_, nbr, _, valid), spec, jspec, n_own = _plans(0)
    m = nbr.shape[0]
    z = np.random.default_rng(9).standard_normal((m, 16)).astype(np.float32)
    w = np.random.default_rng(10).standard_normal(16).astype(np.float32)
    z_sorted = z[plan.order.numpy()]

    def jax_loss(x):
        out = jcb.cellblock_aggregate(x, jplan, jspec, carry_dtype=jnp.float32, interpret=True)
        return jnp.sum(out ** 2 @ jnp.asarray(w)), out

    (jval, jout), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(z_sorted))
    x = torch.from_numpy(z_sorted).requires_grad_(True)
    out = cellblock.cellblock_aggregate(x, plan, spec, carry_dtype=torch.float32)
    loss = ((out ** 2) @ torch.from_numpy(w)).sum()
    (grad,) = torch.autograd.grad(loss, x)
    n_valid = int(valid.sum())
    np.testing.assert_allclose(out.detach().numpy()[:n_valid], np.asarray(jout)[:n_valid],
                               atol=AGG_ATOL, rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    inv = torch.empty_like(plan.order)
    inv[plan.order] = torch.arange(m)
    owned = out.detach()[inv[:n_own]][valid[:n_own]]
    ref = torch.from_numpy(z)[nbr[:n_own][valid[:n_own]]].sum(dim=1)
    torch.testing.assert_close(owned, ref, atol=AGG_ATOL, rtol=0)
