"""The port's hybrid cell-block rollout (K1' codes search, K2/K3 plan, K4
aggregation) held against the JAX package's, on weights carried across by
``params_from_jax`` and identical numpy inputs, re-neighboring every step
(R = 1); ``test_torch_cellblock_reneighbor.py`` covers R = 2.

JAX runs its codes path: ``neighbor_method="pallas"`` with the k-NN kernel
in interpret mode (patched in for this test's calls, as the JAX package's
tests call it with ``interpret=True``) and ``s_build="kernel"`` (its Pallas
S build, interpret mode off-TPU). Certificates must be equal step by step.
Coordinates are held to 1e-5 absolute, as the gather rollout's test holds
them: the aggregation's products are exact on both sides and only the
order of float32 sums differs (bf16 operands round at the same places).
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
from cosmology_gnn_simulation_tpu.rollout import rollout as jax_rollout
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
)
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": [1.0, 1.0, 1.0], "dt": 0.05,
}
N, K, STEPS = 4096, 16, 3
COORD_ATOL = 1e-5
# Hybrid against gather in bf16: the gather path rounds each aggregated sum
# to bf16 (2^-8 relative), the hybrid path keeps K4's float32 sum.
HYBRID_VS_GATHER_ATOL = {None: 1e-5, "bfloat16": 1e-4}
CASES = {
    # name: (dtype, fused tail)
    "f32": (None, False),
    "bf16_fused_tail": ("bfloat16", True),
}


def _setup(seed=1):
    base = dict(node_input_size=17, latent_size=32, mlp_hidden_size=32,
                num_message_passing_steps=2)
    jcfg, tcfg = JaxConfig(**base), EncodeProcessDecodeConfig(**base)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    pos = np.remainder(rng.uniform(0, 1, (1, N, 3))
                       + rng.normal(0, 5e-4, (5, N, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (5, N, 1))).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, pos, temp


def _jax_hybrid(jparams, jcfg, pos, temp, dtype, fused, reneighbor_every, monkeypatch):
    monkeypatch.setattr(
        jax_pallas_knn, "pallas_cell_list_knn",
        functools.partial(jax_pallas_knn.pallas_cell_list_knn, interpret=True),
    )
    return jax_rollout(
        jparams, jcfg, jnp.asarray(pos), jnp.asarray(temp), JaxStats.from_metadata(METADATA),
        STEPS, num_neighbors=K, dtype=None if dtype is None else jnp.dtype(dtype),
        aggregation="cellblock_hybrid", neighbor_method="pallas", s_build="kernel",
        reneighbor_every=reneighbor_every, fused_tail=fused, exactness_guard="flag",
    )


def _port(tparams, tcfg, pos, temp, dtype, fused, reneighbor_every, aggregation):
    return rollout(
        tparams, tcfg, pos, temp, NormalizationStats.from_metadata(METADATA, device="cpu"),
        STEPS, num_neighbors=K, dtype=None if dtype is None else getattr(torch, dtype),
        aggregation=aggregation, neighbor_method="pallas",
        reneighbor_every=reneighbor_every, fused_tail=fused, exactness_guard="flag",
        device="cpu",
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_hybrid_rollout_matches_jax(case, monkeypatch):
    dtype, fused = CASES[case]
    jcfg, tcfg, jparams, tparams, pos, temp = _setup()
    ref = _jax_hybrid(jparams, jcfg, pos, temp, dtype, fused, 1, monkeypatch)
    out = _port(tparams, tcfg, pos, temp, dtype, fused, 1, "cellblock_hybrid")
    assert out["Coordinates"].shape == (5 + STEPS, N, 3)
    assert out["InternalEnergy"].shape == (5 + STEPS, N, 1)
    np.testing.assert_array_equal(out["neighbor_exactness"].numpy(),
                                  np.asarray(ref["neighbor_exactness"]))
    assert bool(out["neighbor_exactness"].all())
    np.testing.assert_array_equal(out["Coordinates"][:5].numpy(), pos)
    np.testing.assert_allclose(out["Coordinates"].numpy(), np.asarray(ref["Coordinates"]),
                               atol=COORD_ATOL, rtol=0)
    np.testing.assert_allclose(out["InternalEnergy"].numpy(),
                               np.asarray(ref["InternalEnergy"]), atol=COORD_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_hybrid_and_gather_paths_agree_on_converted_params(dtype):
    """One ``params_from_jax`` tree drives both aggregation paths of the
    port (the converter needs no per-path layout); on the CPU no kernel
    launches."""
    jcfg, tcfg, _, tparams, pos, temp = _setup(seed=3)
    kernels.reset_launches()
    hybrid = _port(tparams, tcfg, pos, temp, dtype, dtype is not None, 1, "cellblock_hybrid")
    gather = _port(tparams, tcfg, pos, temp, dtype, dtype is not None, 1, "gather")
    assert not any(kernels.launches.values())
    assert bool(hybrid["neighbor_exactness"].all()) and bool(gather["neighbor_exactness"].all())
    np.testing.assert_allclose(hybrid["Coordinates"].numpy(), gather["Coordinates"].numpy(),
                               atol=HYBRID_VS_GATHER_ATOL[dtype], rtol=0)
