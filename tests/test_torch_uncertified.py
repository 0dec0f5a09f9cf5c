"""The port against the JAX package where the exactness certificate is
false: two clustered frames at N = 8,192, k = 16 (95 % of the particles in
a sigma 0.01 ball, 30 % in a sigma 0.05 ball), where the k-NN's spill block
overflows, rows run short of k candidates (sentinel picks), columns
overflow and edges drop. The JAX Pallas kernels run in interpret mode.

* The k-NN (K1, plain path) against JAX's: neighbor sets and overflow
  equal, the certificate flag equal (false on both); ``max_d2`` and
  ``max_excess`` within 4 float32 ulps, since XLA:CPU contracts JAX's
  interpret-mode squares and sums into FMAs and the port never does
  (``tests/test_torch_knn.py``).
* The plan from JAX's codes: K2's offsets bit-equal to the ones JAX's
  ``_s_from_codes_fused`` hands its one-hot build; S, S_rev,
  ``dropped_edges``, ``overflow``, ``window_overflow`` and
  ``reverse_mismatch`` bit-equal to JAX ``build_cellblock(...,
  with_reverse=True, s_build="kernel")``.
* 2-step rollouts (a small model, float32) of the 30 % frame on gather,
  hybrid from codes and hybrid by the dense search: every step flagged
  false on both sides,
  coordinates within 2e-4 of JAX (the tolerance of the port's card-against-
  CPU rollout checks; summation order only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosmology_gnn_simulation_tpu.ops.pallas_knn as jax_pallas_knn
from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    EncodeProcessDecodeConfig as JaxConfig,
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.ops import cellblock as jcb
from cosmology_gnn_simulation_tpu.ops.cell_list import choose_cell_grid as jax_choose_cell_grid
from cosmology_gnn_simulation_tpu.rollout import rollout as jax_rollout
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
)
from cosmology_gnn_simulation_tpu_torch.ops import cellblock
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import choose_cell_grid
from cosmology_gnn_simulation_tpu_torch.ops.pallas_knn import (
    codes_packing_cap,
    pallas_cell_list_knn,
)
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats
from test_torch_knn import _close_ulps
from test_torch_knn_select_schedule import CLUSTERED, clustered_positions

N, K, STEPS = 8192, 16, 2
COORD_ATOL = 2e-4
METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": [1.0, 1.0, 1.0], "dt": 0.05,
}


@functools.cache
def _jax_knn(name):
    """JAX's k-NN on the frame (its dual mode, interpret mode): ids,
    diagnostics, and the codes with their spill tables."""
    pos = jnp.asarray(clustered_positions(N, name))
    ids, codes, spill, diag = jax_pallas_knn.pallas_cell_list_knn(
        pos, K, 1.0, jax_choose_cell_grid(N, K), return_diagnostics=True, with_codes=True,
        interpret=True)
    return (np.asarray(ids), tuple(np.asarray(d) for d in diag), np.asarray(codes),
            None if spill is None else tuple(np.array(s) for s in spill))


@pytest.mark.parametrize("name", sorted(CLUSTERED))
def test_knn_on_clustered_frames_matches_jax(name):
    jids, (jovf, jmax_d2, jexcess), _, _ = _jax_knn(name)
    pos = torch.from_numpy(clustered_positions(N, name))
    ids, (ovf, max_d2, excess) = pallas_cell_list_knn(pos, K, 1.0, choose_cell_grid(N, K),
                                                      return_diagnostics=True)
    np.testing.assert_array_equal(np.sort(ids.numpy(), 1), np.sort(jids, 1))
    assert int(ovf) == int(jovf) > 0
    certified = int(ovf) == 0 and float(excess) <= 0
    assert certified == (int(jovf) == 0 and float(jexcess) <= 0) and not certified
    _close_ulps(max_d2, jmax_d2, jmax_d2)
    _close_ulps(excess, jexcess, jmax_d2)


@pytest.mark.parametrize("name", sorted(CLUSTERED))
def test_plan_on_clustered_frames_matches_jax(name, monkeypatch):
    """From JAX's codes on both sides (its dual mode's: any codes the
    decode takes will do): K2's offsets, then the whole plan with its
    reverse table and certificate counts."""
    _, _, codes, spill = _jax_knn(name)
    pos = clustered_positions(N, name)
    jspec = jcb.choose_cellblock_spec(N, K)
    spec = cellblock.CellBlockSpec(*jspec[:6])
    cap = codes_packing_cap(N, K, choose_cell_grid(N, K))
    tspill = None if spill is None else tuple(torch.from_numpy(s) for s in spill)
    layout = cellblock.cellblock_layout(torch.from_numpy(pos), 1.0, spec)
    offsets, dropped = cellblock.s_decode(torch.from_numpy(codes), tspill, layout, spec, cap)

    # JAX's decode kernel on the same slot codes; the offsets it hands its
    # one-hot build are captured on the way.
    seen = {}
    real = jcb._s_from_offsets

    def capture(offs, *args):
        seen["offsets"] = np.asarray(offs)
        return real(offs, *args)

    monkeypatch.setattr(jcb, "_s_from_offsets", capture)
    codes_n, qz_slot, cstart27, tile_const, slot_col = cellblock.s_decode_inputs(
        layout, torch.from_numpy(codes), cap, tspill, spec)
    s27 = cstart27[slot_col * spec.grid_size + qz_slot.long()]
    const = tile_const.repeat_interleave(spec.query_block, dim=0)
    packed = torch.cat([codes_n, s27, const, qz_slot[:, None]], dim=1).numpy().T
    packed = np.pad(packed, ((0, (-packed.shape[0]) % 8), (0, 0)))
    _, jdropped = jcb._s_from_codes_fused(jnp.asarray(packed), jspec, K, cap, True)
    monkeypatch.undo()
    np.testing.assert_array_equal(offsets.numpy(), seen["offsets"])
    assert int(dropped) == int(jdropped)

    jplan = jcb.build_cellblock(jnp.asarray(pos), None, 1.0, jspec, with_reverse=True,
                                s_build="kernel", neighbor_codes=jnp.asarray(codes),
                                codes_cap=cap, codes_spill=spill, interpret=True)
    plan = cellblock.build_cellblock(torch.from_numpy(pos), None, 1.0, spec, with_reverse=True,
                                     neighbor_codes=torch.from_numpy(codes), codes_cap=cap,
                                     codes_spill=tspill)
    for field in ("s_table", "s_rev_table", "overflow", "dropped_edges", "window_overflow",
                  "reverse_mismatch"):
        np.testing.assert_array_equal(getattr(plan, field).numpy(),
                                      np.asarray(getattr(jplan, field)), err_msg=field)
    assert int(plan.overflow) > 0
    assert int(plan.dropped_edges) == int(dropped)


ROUTES = {
    "gather": dict(aggregation="gather", neighbor_method="pallas"),
    "hybrid_codes": dict(aggregation="cellblock_hybrid", neighbor_method="pallas"),
    "hybrid_dense": dict(aggregation="cellblock_hybrid", cellblock_search="dense"),
}


@functools.cache
def _models():
    base = dict(node_input_size=17, latent_size=32, mlp_hidden_size=32,
                num_message_passing_steps=1)
    jcfg, tcfg = JaxConfig(**base), EncodeProcessDecodeConfig(**base)
    jparams = jax_init(jax.random.PRNGKey(5), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_rollout_on_clustered_frames_matches_jax(route, monkeypatch):
    """On the 30 % frame, where edges also drop and S_rev misses edges of
    S (one JAX compile a route; the 95 % frame's plan is held above)."""
    name = "clustered30"
    monkeypatch.setattr(
        jax_pallas_knn, "pallas_cell_list_knn",
        functools.partial(jax_pallas_knn.pallas_cell_list_knn, interpret=True),
    )
    jcfg, tcfg, jparams, tparams = _models()
    rng = np.random.default_rng(3)
    pos = np.remainder(clustered_positions(N, name)[None]
                       + rng.normal(0, 5e-4, (5, N, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (5, N, 1))).astype(np.float32)
    kw = dict(num_neighbors=K, exactness_guard="flag", fused_tail=False, **ROUTES[route])
    jkw = dict(kw, s_build="kernel") if route != "gather" else kw
    ref = jax_rollout(jparams, jcfg, jnp.asarray(pos), jnp.asarray(temp),
                      JaxStats.from_metadata(METADATA), STEPS, **jkw)
    out = rollout(tparams, tcfg, pos, temp, NormalizationStats.from_metadata(METADATA, device="cpu"),
                  STEPS, device="cpu", **kw)
    np.testing.assert_array_equal(out["neighbor_exactness"].numpy(),
                                  np.asarray(ref["neighbor_exactness"]))
    assert not bool(out["neighbor_exactness"].any())
    np.testing.assert_allclose(out["Coordinates"].numpy(), np.asarray(ref["Coordinates"]),
                               atol=COORD_ATOL, rtol=0)
    np.testing.assert_allclose(out["InternalEnergy"].numpy(), np.asarray(ref["InternalEnergy"]),
                               atol=COORD_ATOL, rtol=0)
