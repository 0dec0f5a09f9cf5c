"""The port's one-step prediction (``rollout.one_step_prediction``) held
against the JAX package's on identical numpy inputs and weights carried
across by ``params_from_jax``, on its three routes: gather, the hybrid
cell-block path from the k-NN kernel's codes (JAX's k-NN kernel in
interpret mode, patched in for this test's calls), and the hybrid path
from neighbor ids on a spec of another grid (the aux plan; brute force
serves the search below 8192 particles in both packages).

Tolerances: the new positions and temperatures within ``COORD_ATOL = 1e-5``
absolute, as the rollout tests (exact aggregation products, float32 sums in
another order; measured at most 6.0e-8). The port's one step is the first
frame of its own 1-step rollout of the same window, bit for bit (the same
operations), in the caller's particle order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosmology_gnn_simulation_tpu.ops.pallas_knn as jax_pallas_knn
from cosmology_gnn_simulation_tpu.ops import cellblock as jcb
from cosmology_gnn_simulation_tpu.rollout import one_step_prediction as jax_one_step
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.ops import cellblock
from cosmology_gnn_simulation_tpu_torch.rollout import one_step_prediction, rollout
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats
from test_torch_cellblock_rollout import COORD_ATOL, METADATA, N, _setup

K = 16


def _routes():
    """name: (JAX options, port options)."""
    coarse = jcb.choose_cellblock_spec(N)
    hybrid = {"aggregation": "cellblock_hybrid"}
    return {
        "gather": ({}, {}),
        "hybrid_codes": ({**hybrid, "neighbor_method": "pallas"},
                         {**hybrid, "neighbor_method": "pallas"}),
        "hybrid_aux": ({**hybrid, "cellblock_spec": coarse},
                       {**hybrid, "cellblock_spec": cellblock.CellBlockSpec(*coarse[:6])}),
    }


@pytest.mark.parametrize("route", ["gather", "hybrid_codes", "hybrid_aux"])
def test_one_step_prediction_matches_jax(route, monkeypatch):
    monkeypatch.setattr(
        jax_pallas_knn, "pallas_cell_list_knn",
        functools.partial(jax_pallas_knn.pallas_cell_list_knn, interpret=True),
    )
    jkw, tkw = _routes()[route]
    jcfg, tcfg, jparams, tparams, pos, temp = _setup(seed=6)
    want_pos, want_temp = jax_one_step(jparams, jcfg, jnp.asarray(pos), jnp.asarray(temp),
                                       JaxStats.from_metadata(METADATA), num_neighbors=K,
                                       **jkw)
    kernels.reset_launches()
    got_pos, got_temp = one_step_prediction(
        tparams, tcfg, pos, temp, NormalizationStats.from_metadata(METADATA, device="cpu"),
        num_neighbors=K, device="cpu", **tkw)
    assert not any(kernels.launches.values())
    assert got_pos.shape == (N, 3) and got_temp.shape == (N, 1)
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), atol=COORD_ATOL, rtol=0)
    np.testing.assert_allclose(got_temp.numpy(), np.asarray(want_temp), atol=COORD_ATOL,
                               rtol=0)


@pytest.mark.parametrize("route", ["gather", "hybrid_codes", "hybrid_aux"])
def test_one_step_prediction_is_the_first_rollout_frame(route):
    _, tkw = _routes()[route]
    _, tcfg, _, tparams, pos, temp = _setup(seed=7)
    stats = NormalizationStats.from_metadata(METADATA, device="cpu")
    kw = dict(num_neighbors=K, dtype=torch.bfloat16, fused_tail=True, device="cpu", **tkw)
    new_pos, new_temp = one_step_prediction(tparams, tcfg, pos, temp, stats, **kw)
    ref = rollout(tparams, tcfg, pos, temp, stats, 1, **kw)
    assert torch.equal(new_pos, ref["Coordinates"][-1])
    assert torch.equal(new_temp, ref["InternalEnergy"][-1])


def test_one_step_prediction_options_that_are_refused():
    _, tcfg, _, tparams, pos, temp = _setup()
    stats = NormalizationStats.from_metadata(METADATA, device="cpu")
    # The slot-space carry and variable capacities are ported: each one step
    # is its own 1-step rollout's first frame.
    for kw in (dict(aggregation="cellblock"),
               dict(aggregation="cellblock_hybrid", cellblock_variable=True)):
        kw = dict(num_neighbors=K, device="cpu", **kw)
        new_pos, _ = one_step_prediction(tparams, tcfg, pos, temp, stats, **kw)
        ref = rollout(tparams, tcfg, pos, temp, stats, 1, **kw)
        assert torch.equal(new_pos, ref["Coordinates"][-1])
    with pytest.raises(ValueError):
        one_step_prediction(tparams, tcfg, pos, temp, stats, aggregation="nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            one_step_prediction(tparams, tcfg, pos, temp, stats)
