"""The port's model and gather rollout held against the JAX package, on
weights carried across by ``params_from_jax`` and identical numpy inputs.

Narrow model (latent 32, 2-3 message-passing steps) to keep the suite fast.
Tolerances: float32 — summation order only: 1e-4 on the normalized model
outputs, 1e-5 on coordinates. bf16 operands with the fused tail — the two
frameworks round bf16 at the same places, but a last-bit difference in an
f32 sum can flip one rounding: 2e-2 on model outputs; on coordinates
(acceleration x dt^2 ~ 1e-4 per step) 1e-5.

JAX's rollout runs its XLA cell list here (its Pallas k-NN needs a TPU or
interpret mode, which its featurize does not request); the port's runs the
plain path of kernel K1. Both are exact, so neighbor sets agree up to exact
distance ties (none in continuous random data).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    EncodeProcessDecodeConfig as JaxConfig,
    apply_encode_process_decode as jax_apply,
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.ops.neighbors import knn_periodic as jax_knn
from cosmology_gnn_simulation_tpu.rollout import rollout as jax_rollout
from cosmology_gnn_simulation_tpu.types import (
    NormalizationStats as JaxStats,
    ParticleGraph as JaxGraph,
)
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
    apply_encode_process_decode,
    default_model_config,
    init_encode_process_decode,
)
from cosmology_gnn_simulation_tpu_torch.rollout import integrate_step, rollout
from cosmology_gnn_simulation_tpu_torch.types import (
    NormalizationStats,
    ParticleGraph,
    resolve_device,
)

METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": [1.0, 1.0, 1.0], "dt": 0.05,
}


def _configs(**kw):
    base = dict(node_input_size=17, latent_size=32, mlp_hidden_size=32,
                num_message_passing_steps=3)
    base.update(kw)
    return JaxConfig(**base), EncodeProcessDecodeConfig(**base)


def _params(jcfg, seed=0):
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _graph(n=600, k=8, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    nodes = rng.normal(0, 1, (n, 17)).astype(np.float32)
    nbr = np.asarray(jax_knn(jnp.asarray(pos), k, 1.0))
    edges = (pos[nbr] - pos[:, None, :]).astype(np.float32)
    edges = np.concatenate([edges, np.linalg.norm(edges, axis=-1, keepdims=True)], -1)
    jg = JaxGraph(nodes=jnp.asarray(nodes), neighbors=jnp.asarray(nbr),
                  edges=jnp.asarray(edges), positions=jnp.asarray(pos))
    tg = ParticleGraph(nodes=torch.from_numpy(nodes), neighbors=torch.from_numpy(np.array(nbr)).long(),
                       edges=torch.from_numpy(edges), positions=torch.from_numpy(pos))
    return jg, tg


MODEL_CASES = {
    "pruned_f32": (dict(), None, 1e-4),
    "unpruned_sender_latents_f32": (dict(prune_dead_edge_stream=False), None, 1e-4),
    "unpruned_edge_messages_f32": (dict(aggregate="edge_messages"), None, 1e-4),
    "pruned_bf16": (dict(), "bfloat16", 2e-2),
    "pruned_bf16_fused_tail": (dict(fused_tail=True), "bfloat16", 2e-2),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_matches_jax(case):
    kw, dtype, tol = MODEL_CASES[case]
    jcfg, tcfg = _configs(**kw)
    jparams, tparams = _params(jcfg)
    jg, tg = _graph()
    ref = jax_apply(jparams, jg, jcfg, None if dtype is None else jnp.dtype(dtype))
    out = apply_encode_process_decode(
        tparams, tg, tcfg, None if dtype is None else getattr(torch, dtype)
    )
    for key in ("acceleration", "temp_rate"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=tol, rtol=0)


def test_params_from_jax_keeps_tree_and_layout():
    jcfg, _ = _configs()
    jparams, tparams = _params(jcfg)
    w = tparams["processor"]["node"]["layers"][0]["w"]
    assert w.shape == (3, 64, 32)  # [M, in, out], stacked like the JAX tree
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jparams["processor"]["node"]["layers"][0]["w"]))
    assert isinstance(tparams["decoder_acc"]["layers"], tuple)


def test_init_matches_jax_tree_shapes():
    jcfg, tcfg = _configs()
    shapes = jax.tree.map(lambda a: tuple(a.shape), jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(0), jcfg)))
    tparams = init_encode_process_decode(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tparams)
    assert jax.tree.structure(shapes) == jax.tree.structure(tshapes)
    assert jax.tree.leaves(shapes) == jax.tree.leaves(tshapes)
    assert default_model_config().node_input_size == 17


def _seed_window(n, w=5, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (1, n, 3))
    drift = rng.normal(0, 5e-4, (w, n, 3)).cumsum(axis=0)
    pos = np.remainder(base + drift, 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (w, n, 1))).astype(np.float32)
    return pos, temp


ROLLOUT_CASES = {
    # name: (dtype, fused_tail, model atol, coordinate atol)
    "f32": (None, False, 1e-5),
    "bf16_fused_tail": ("bfloat16", True, 1e-5),
}


@pytest.mark.parametrize("case", sorted(ROLLOUT_CASES))
def test_gather_rollout_matches_jax(case):
    dtype, fused, coord_tol = ROLLOUT_CASES[case]
    n, k, steps = 8192, 16, 3
    jcfg, tcfg = _configs(num_message_passing_steps=2)
    jparams, tparams = _params(jcfg, seed=1)
    pos, temp = _seed_window(n)
    jstats = JaxStats.from_metadata(METADATA)
    ref = jax_rollout(
        jparams, jcfg, jnp.asarray(pos), jnp.asarray(temp), jstats, steps,
        num_neighbors=k, dtype=None if dtype is None else jnp.dtype(dtype),
        aggregation="gather", neighbor_method="celllist", fused_tail=fused,
        exactness_guard="flag",
    )
    out = rollout(
        tparams, tcfg, pos, temp, NormalizationStats.from_metadata(METADATA, device="cpu"),
        steps, num_neighbors=k, dtype=None if dtype is None else getattr(torch, dtype),
        aggregation="gather", fused_tail=fused, exactness_guard="flag", device="cpu",
    )
    assert out["Coordinates"].shape == (5 + steps, n, 3)
    assert out["InternalEnergy"].shape == (5 + steps, n, 1)
    assert bool(out["neighbor_exactness"].all())
    np.testing.assert_array_equal(out["neighbor_exactness"].numpy(),
                                  np.asarray(ref["neighbor_exactness"]))
    np.testing.assert_array_equal(out["Coordinates"][:5].numpy(), pos)
    np.testing.assert_allclose(out["Coordinates"].numpy(), np.asarray(ref["Coordinates"]),
                               atol=coord_tol, rtol=0)
    np.testing.assert_allclose(out["InternalEnergy"].numpy(),
                               np.asarray(ref["InternalEnergy"]), atol=1e-5, rtol=0)


def test_small_rollout_bruteforce_and_reneighbor_match_jax():
    """Below 8192 particles both packages search by brute force; R=2 reuses
    each table for two steps in both."""
    n, k, steps = 512, 8, 4
    jcfg, tcfg = _configs(num_message_passing_steps=2)
    jparams, tparams = _params(jcfg, seed=2)
    pos, temp = _seed_window(n, seed=3)
    ref = jax_rollout(jparams, jcfg, jnp.asarray(pos), jnp.asarray(temp),
                      JaxStats.from_metadata(METADATA), steps, num_neighbors=k,
                      aggregation="gather", reneighbor_every=2)
    out = rollout(tparams, tcfg, pos, temp,
                  NormalizationStats.from_metadata(METADATA, device="cpu"), steps,
                  num_neighbors=k, reneighbor_every=2, device="cpu")
    np.testing.assert_allclose(out["Coordinates"].numpy(), np.asarray(ref["Coordinates"]),
                               atol=1e-5, rtol=0)
    assert bool(out["neighbor_exactness"].all())


def test_integrate_step_semantics():
    stats = NormalizationStats.from_metadata(METADATA, device="cpu")
    x1 = torch.tensor([[0.99, 0.5, 0.5]])
    x0 = torch.tensor([[0.98, 0.5, 0.5]])
    pos, temp = integrate_step(x1, x0, torch.ones(1, 1), torch.zeros(1, 3),
                               torch.full((1, 1), 2.0), stats)
    # Unclamped velocity, then a periodic wrap: 0.99 + 0.01 -> 0.0 (mod 1).
    assert torch.allclose(pos, torch.tensor([[0.0, 0.5, 0.5]]), atol=1e-6)
    assert torch.allclose(temp, torch.tensor([[1.1]]))


def test_unported_options_raise():
    jcfg, tcfg = _configs()
    _, tparams = _params(jcfg)
    pos, temp = _seed_window(64)
    stats = NormalizationStats.from_metadata(METADATA, device="cpu")
    # The brute-force fallback is ported: it runs on the CPU (brute force
    # serves below 8,192 particles, so it equals the flag guard here).
    guarded = rollout(tparams, tcfg, pos, temp, stats, 1, exactness_guard="fallback",
                      device="cpu")
    flagged = rollout(tparams, tcfg, pos, temp, stats, 1, device="cpu")
    for key in flagged:
        assert torch.equal(guarded[key], flagged[key]), key
    with pytest.raises(NotImplementedError):
        rollout(tparams, tcfg, pos, temp, stats, 1, aggregation="cellblock",
                device="cpu")
    with pytest.raises(NotImplementedError):
        rollout(tparams, tcfg, pos, temp, stats, 1, aggregation="cellblock_hybrid",
                cellblock_variable=True, device="cpu")


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        NormalizationStats.from_metadata(METADATA)

