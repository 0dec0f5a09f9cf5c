"""Rollout parity of the port against the JAX package away from the unit box,
k = 16 and N = 4,096 that the other rollout tests hold: four cases, each 3
steps of the small pruned model (weights carried across by
``params_from_jax``) on identical numpy inputs, JAX's cell-list k-NN kernel
in interpret mode (``neighbor_method="pallas"`` on both sides):

* hybrid, box 25, k 16, N 4,096;
* hybrid, box 3.7, k 32, N 4,096;
* hybrid, box 1, k 8, N 9,001 (not a multiple of any tile);
* gather, box 3.7, k 32, N 9,001.

Certificates must be equal every step, coordinates within 1e-5 x box and
temperatures within 1e-5 absolute: exact aggregation products, float32 sums
in another order, and coordinates that run up to the box (measured: at most
4.6e-7 x box and 1.2e-7). JAX's compile of its interpret-mode kernel takes
most of each case's time; the steps themselves take about a second.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cosmology_gnn_simulation_tpu.ops.pallas_knn as jax_pallas_knn
from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    EncodeProcessDecodeConfig as JaxConfig,
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.rollout import rollout as jax_rollout
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
)
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

STEPS = 3
REL_TOL = 1e-5

# name: (aggregation, box, k, N)
CASES = {
    "hybrid_box25_k16": ("cellblock_hybrid", 25.0, 16, 4096),
    "hybrid_box3.7_k32": ("cellblock_hybrid", 3.7, 32, 4096),
    "hybrid_box1_k8_n9001": ("cellblock_hybrid", 1.0, 8, 9001),
    "gather_box3.7_k32_n9001": ("gather", 3.7, 32, 9001),
}


def _metadata(box):
    return {"temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0, "temp_rate_std": 0.02,
            "vel_mean": 0.0, "vel_std": 0.06 * box, "acc_mean": 0.0, "acc_std": 0.2 * box,
            "box_size": [box] * 3, "dt": 0.05}


def _inputs(box, n, seed):
    rng = np.random.default_rng(seed)
    pos = np.remainder(box * rng.uniform(0, 1, (1, n, 3))
                       + box * rng.normal(0, 5e-4, (5, n, 3)).cumsum(0), box).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (5, n, 1))).astype(np.float32)
    return pos, temp


@pytest.mark.parametrize("case", list(CASES))
def test_rollout_parity_case(case, monkeypatch):
    aggregation, box, k, n = CASES[case]
    monkeypatch.setattr(
        jax_pallas_knn, "pallas_cell_list_knn",
        functools.partial(jax_pallas_knn.pallas_cell_list_knn, interpret=True),
    )
    base = dict(node_input_size=17, latent_size=32, mlp_hidden_size=32,
                num_message_passing_steps=2)
    jcfg, tcfg = JaxConfig(**base), EncodeProcessDecodeConfig(**base)
    jparams = jax_init(jax.random.PRNGKey(11), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    pos, temp = _inputs(box, n, seed=len(case))
    kw = dict(num_neighbors=k, aggregation=aggregation, neighbor_method="pallas",
              exactness_guard="flag")
    ref = jax_rollout(jparams, jcfg, jnp.asarray(pos), jnp.asarray(temp),
                      JaxStats.from_metadata(_metadata(box)), STEPS, **kw)
    out = rollout(tparams, tcfg, pos, temp,
                  NormalizationStats.from_metadata(_metadata(box), device="cpu"), STEPS,
                  device="cpu", **kw)
    np.testing.assert_array_equal(out["neighbor_exactness"].numpy(),
                                  np.asarray(ref["neighbor_exactness"]))
    assert bool(out["neighbor_exactness"].all())
    np.testing.assert_allclose(out["Coordinates"].numpy(), np.asarray(ref["Coordinates"]),
                               atol=REL_TOL * box, rtol=0)
    np.testing.assert_allclose(out["InternalEnergy"].numpy(),
                               np.asarray(ref["InternalEnergy"]), atol=REL_TOL, rtol=0)
