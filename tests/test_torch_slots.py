"""The port's slot-space cell-block path (``aggregation="cellblock"``: the
carry expanded to the plan's slot rows once after the encoder, every
message-passing step there, compacted once before the decoders), with the
uniform and the variable layouts and the bf16 carry, held against the JAX
package on weights carried across by ``params_from_jax`` and identical
numpy inputs: 2-step rollouts and one train step with ``remat_chunk``.

JAX runs its codes path (``neighbor_method="pallas"`` with the k-NN kernel
in interpret mode, patched in for this test's calls; ``s_build="kernel"``).
Certificates must be equal step by step. Coordinates are held to 2e-4
absolute (the slots rollout test of the JAX package,
``tests/test_cellblock_rollout.py``): the aggregation's products are exact
on both sides and only the order of float32 sums differs; with the bf16
carry a last-bit difference can also flip the bf16 rounding of a carried
latent (2^-8 relative), which the same 2e-4 covers (measured below 1e-6).
The train step: the loss within 1e-3 relative and every gradient leaf
within 5e-2 of its largest magnitude, as ``chip_smoke.py`` holds the card's
step against the CPU's (bf16 operands and a bf16 carry through the steps).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosmology_gnn_simulation_tpu.ops.pallas_knn as jax_pallas_knn
from cosmology_gnn_simulation_tpu.rollout import rollout as jax_rollout
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats
from test_torch_cellblock_rollout import METADATA, N, _setup
from test_torch_training import _batch, _models, _rel_err, jax_step_grads, port_step_grads

K, STEPS = 16, 2
COORD_ATOL = 2e-4
LOSS_RTOL, GRAD_TOL = 1e-3, 5e-2
CASES = {
    # name: (cellblock_variable, dtype, fused tail, carry dtype)
    "uniform_f32": (False, None, False, None),
    "variable_bf16_fused_tail": (True, "bfloat16", True, None),
    "variable_bf16_carry": (True, "bfloat16", True, "bfloat16"),
}


@pytest.fixture
def interpret_knn(monkeypatch):
    monkeypatch.setattr(
        jax_pallas_knn, "pallas_cell_list_knn",
        functools.partial(jax_pallas_knn.pallas_cell_list_knn, interpret=True),
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_slots_rollout_matches_jax(case, interpret_knn):
    variable, dtype, fused, carry = CASES[case]
    jcfg, tcfg, jparams, tparams, pos, temp = _setup(seed=4)
    jcfg, tcfg = jcfg._replace(carry_dtype=carry), tcfg._replace(carry_dtype=carry)
    ref = jax_rollout(
        jparams, jcfg, jnp.asarray(pos), jnp.asarray(temp), JaxStats.from_metadata(METADATA),
        STEPS, num_neighbors=K, dtype=None if dtype is None else jnp.dtype(dtype),
        aggregation="cellblock", cellblock_variable=variable, neighbor_method="pallas",
        s_build="kernel", fused_tail=fused, exactness_guard="flag",
    )
    kernels.reset_launches()
    out = rollout(
        tparams, tcfg, pos, temp, NormalizationStats.from_metadata(METADATA, device="cpu"),
        STEPS, num_neighbors=K, dtype=None if dtype is None else getattr(torch, dtype),
        aggregation="cellblock", cellblock_variable=variable, neighbor_method="pallas",
        fused_tail=fused, exactness_guard="flag", device="cpu",
    )
    assert not any(kernels.launches.values())  # the CPU runs the plain versions
    assert out["Coordinates"].shape == (5 + STEPS, N, 3)
    np.testing.assert_array_equal(out["neighbor_exactness"].numpy(),
                                  np.asarray(ref["neighbor_exactness"]))
    assert bool(out["neighbor_exactness"].all())
    for key in ("Coordinates", "InternalEnergy"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=COORD_ATOL,
                                   rtol=0, err_msg=key)


def test_slots_budget_overflow_matches_jax(interpret_knn):
    """A slot budget below the occupancy: the variable spec's 49 columns of
    about 84 particles each need 49 QB = 256 rows, and a budget of 48 leaves
    the last column without slots (83 particles on the seed frame). Those
    particles have no slot: the certificate is false every step, and the
    slots rollout must still follow JAX's through the compaction (the
    slotless particles' latents as JAX's compact gives them)."""
    from cosmology_gnn_simulation_tpu.ops.cellblock import choose_cellblock_spec as jax_choose
    from cosmology_gnn_simulation_tpu_torch.ops import cellblock

    jcfg, tcfg, jparams, tparams, pos, temp = _setup(seed=4)
    jspec = jax_choose(N, K, variable=True)
    jspec = jspec._replace(slot_budget=48 * jspec.query_block)
    tspec = cellblock.CellBlockSpec(**jspec._asdict())
    assert int(cellblock.cellblock_layout(torch.from_numpy(pos[-1]), 1.0, tspec).overflow) > 0
    ref = jax_rollout(
        jparams, jcfg, jnp.asarray(pos), jnp.asarray(temp), JaxStats.from_metadata(METADATA),
        STEPS, num_neighbors=K, aggregation="cellblock", cellblock_spec=jspec,
        cellblock_variable=True, neighbor_method="pallas", s_build="kernel",
        exactness_guard="flag",
    )
    out = rollout(
        tparams, tcfg, pos, temp, NormalizationStats.from_metadata(METADATA, device="cpu"),
        STEPS, num_neighbors=K, aggregation="cellblock", cellblock_spec=tspec,
        cellblock_variable=True, neighbor_method="pallas", exactness_guard="flag",
        device="cpu",
    )
    np.testing.assert_array_equal(out["neighbor_exactness"].numpy(),
                                  np.asarray(ref["neighbor_exactness"]))
    assert not bool(out["neighbor_exactness"].any())
    for key in ("Coordinates", "InternalEnergy"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=COORD_ATOL,
                                   rtol=0, err_msg=key)


def test_slots_variable_bf16_carry_train_step_matches_jax(interpret_knn):
    """Slots, variable capacities, the bf16 carry, ``remat_chunk`` and the
    fused tail (K5 and K6's plain versions), one step of SGD with lr 1."""
    jcfg, tcfg, jparams = _models(seed=5)
    model = dict(carry_dtype="bfloat16", remat_chunk=2)
    jcfg, tcfg = jcfg._replace(**model), tcfg._replace(**model)
    batch = _batch(N, 9)
    tc = dict(aggregation="cellblock", cellblock_variable=True, neighbor_method="pallas",
              compute_dtype="bfloat16", fused_tail=True, augment_prob=0.0, noise_std=0.0,
              momentum_loss_weight=0.1)
    jmetrics, jgrads = jax_step_grads(jcfg, jparams, batch, **tc)
    metrics, grads = port_step_grads(tcfg, jparams, batch, **tc)
    assert float(metrics["cellblock_violations"]) == float(jmetrics["cellblock_violations"]) == 0
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=LOSS_RTOL)
    assert len(grads) == len(jgrads)
    worst = max(_rel_err(a, b) for a, b in zip(grads, jgrads))
    assert worst <= GRAD_TOL, worst


def test_params_from_jax_carries_the_config4_model():
    """The config-4 model (latent = hidden = 256, 15 message-passing steps):
    ``params_from_jax`` gives the port's own tree, leaf for leaf, with the
    values of a tree in the JAX init's structure (float32, exact)."""
    from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
        init_encode_process_decode as jax_init,
    )
    from cosmology_gnn_simulation_tpu.training.trainer import (
        default_model_config as jax_default_model_config,
    )
    from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        default_model_config,
        init_encode_process_decode,
    )

    widths = dict(latent_size=256, mlp_hidden_size=256, num_message_passing_steps=15)
    # The JAX tree's structure and shapes (traced, not computed), filled
    # with numpy draws.
    config = jax_default_model_config(**widths)
    shapes = jax.eval_shape(lambda key: jax_init(key, config), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
    tparams = params_from_jax(jparams, device="cpu")
    own = init_encode_process_decode(default_model_config(**widths), torch.Generator(),
                                     device="cpu")

    def walk(got, want, values):
        if isinstance(got, dict):
            assert set(got) == set(want) == set(values)
            for key in got:
                walk(got[key], want[key], values[key])
        elif isinstance(got, (tuple, list)):
            assert len(got) == len(want) == len(values)
            for a, b, c in zip(got, want, values):
                walk(a, b, c)
        else:
            assert got.shape == want.shape and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), values)

    walk(tparams, own, jparams)
    assert tparams["processor"]["node"]["layers"][0]["w"].shape == (15, 512, 256)
