"""The port's evaluation module against the JAX package's on the CPU, with
weights carried across by ``params_from_jax`` and the same synthetic
simulation (the port's generator is bit-equal to JAX's):

* ``validate_one_step``: the same start indices (numpy's
  ``default_rng(seed).choice`` on both sides), so equal
  ``tested_timesteps``; every error within rtol 1e-4 (float32, summation
  order only), and on both aggregation routes of the port;
* ``calculate_rollout_errors`` equal; ``write_rollout_summary`` byte-equal;
* ``convert_rollout_to_hdf5``: every field equal to JAX's (the min-image
  differences in float32, as ``jnp``), and its file accepted by the port's
  ``generate_metadata``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu import evaluation as jax_evaluation
from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.training.trainer import (
    default_model_config as jax_default_model_config,
)
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu_torch import evaluation
from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.data import generate_synthetic_simulation
from cosmology_gnn_simulation_tpu_torch.data.hdf5 import read_simulation
from cosmology_gnn_simulation_tpu_torch.metadata import compute_metadata, generate_metadata
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import default_model_config
from cosmology_gnn_simulation_tpu_torch.rollout import one_step_prediction
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

MODEL = dict(window_size=5, latent_size=16, mlp_hidden_size=16, mlp_num_hidden_layers=1,
             num_message_passing_steps=2)
RTOL = 1e-4


@functools.cache
def _setup():
    sim = generate_synthetic_simulation(num_snapshots=14, num_particles=512, seed=4)
    metadata = compute_metadata(sim)
    jcfg = jax_default_model_config(**MODEL)
    jparams = jax_init(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return (sim, metadata, (jcfg, jparams, JaxStats.from_metadata(metadata)),
            (default_model_config(**MODEL), tparams,
             NormalizationStats.from_metadata(metadata, device="cpu")))


@pytest.mark.parametrize("seed", [0, 7])
def test_validate_one_step_matches_jax(seed):
    sim, _, (jcfg, jparams, jstats), (cfg, params, stats) = _setup()
    kw = dict(num_neighbors=8, num_timesteps=4, seed=seed)
    ref = jax_evaluation.validate_one_step(jparams, jcfg, sim, jstats, 5, **kw)
    kernels.reset_launches()
    out = evaluation.validate_one_step(params, cfg, sim, stats, 5, device="cpu", **kw)
    assert not any(kernels.launches.values())
    assert out["tested_timesteps"] == ref["tested_timesteps"]
    assert len(set(out["tested_timesteps"])) == 4
    for key in ("position_errors", "temperature_errors"):
        np.testing.assert_allclose(out[key], ref[key], rtol=RTOL, atol=0)
    for key in ("position_error", "temperature_error"):
        np.testing.assert_allclose(out[key], ref[key], rtol=RTOL, atol=0)


def test_validate_one_step_errors_are_the_one_step_predictions_mse():
    """Each error is the numpy MSE of ``one_step_prediction`` of its window,
    on gather and on the hybrid route; the two routes agree."""
    sim, _, _, (cfg, params, stats) = _setup()
    runs = {}
    for aggregation in ("gather", "cellblock_hybrid"):
        out = evaluation.validate_one_step(params, cfg, sim, stats, 5, num_neighbors=8,
                                           num_timesteps=3, aggregation=aggregation,
                                           device="cpu")
        for i, t in enumerate(out["tested_timesteps"]):
            pos, _ = one_step_prediction(params, cfg, sim["Coordinates"][t - 5:t],
                                         sim["InternalEnergy"][t - 5:t], stats, num_neighbors=8,
                                         aggregation=aggregation, device="cpu")
            mse = float(np.mean((pos.numpy() - sim["Coordinates"][t]) ** 2))
            assert out["position_errors"][i] == mse
        runs[aggregation] = out
    np.testing.assert_allclose(runs["cellblock_hybrid"]["position_errors"],
                               runs["gather"]["position_errors"], rtol=RTOL)


def test_validate_one_step_clamps_and_refuses_like_jax():
    sim, _, (jcfg, jparams, jstats), (cfg, params, stats) = _setup()
    short = {key: value[:7] if np.ndim(value) else value for key, value in sim.items()}
    out = evaluation.validate_one_step(params, cfg, short, stats, 5, num_neighbors=8,
                                       num_timesteps=10, device="cpu")
    ref = jax_evaluation.validate_one_step(jparams, jcfg, short, jstats, 5, num_neighbors=8,
                                           num_timesteps=10)
    assert out["tested_timesteps"] == ref["tested_timesteps"] == [5]
    too_short = {key: value[:6] if np.ndim(value) else value for key, value in sim.items()}
    with pytest.raises(ValueError, match="No testable timesteps"):
        evaluation.validate_one_step(params, cfg, too_short, stats, 5, device="cpu")


def _rollout_like(sim, seed=0):
    rng = np.random.default_rng(seed)
    coords = np.remainder(sim["Coordinates"] + rng.normal(0, 1e-3, sim["Coordinates"].shape),
                          1.0).astype(np.float32)
    temps = (sim["InternalEnergy"] + rng.normal(0, 1e-2, sim["InternalEnergy"].shape)
             ).astype(np.float32)
    return {"Coordinates": coords, "InternalEnergy": temps}


def test_rollout_errors_and_summary_match_jax(tmp_path):
    sim, metadata, _, _ = _setup()
    pred = _rollout_like(sim)
    pred = {key: value[:10] for key, value in pred.items()}  # shorter than the truth
    errors = evaluation.calculate_rollout_errors(pred, sim)
    ref = jax_evaluation.calculate_rollout_errors(pred, sim)
    assert errors == ref and len(errors["position_errors"]) == 10
    kw = dict(model_path="model_out/model_best", test_data="test.hdf5", num_particles=512,
              window_size=5, num_steps=9, dt=metadata["dt"], box_size=1.0)
    evaluation.write_rollout_summary(str(tmp_path / "port.txt"), errors, **kw)
    jax_evaluation.write_rollout_summary(str(tmp_path / "jax.txt"), ref, **kw)
    text = (tmp_path / "port.txt").read_bytes()
    assert text == (tmp_path / "jax.txt").read_bytes()
    assert b"Mean position MSE: " in text and b"Mean temperature MSE: " in text
    empty = {"Coordinates": np.zeros((0, 512, 3)), "InternalEnergy": np.zeros((0, 512, 1))}
    assert (evaluation.calculate_rollout_errors(empty, sim)
            == jax_evaluation.calculate_rollout_errors(empty, sim))


@pytest.mark.parametrize("window_size", [5, 1])
def test_convert_rollout_matches_jax_and_is_a_dataset(tmp_path, window_size):
    sim, _, _, _ = _setup()
    pred = _rollout_like(sim, seed=1)
    # Steps that cross the periodic boundary: the min-image differences.
    pred["Coordinates"][3:, :7] = np.remainder(pred["Coordinates"][3:, :7] + 0.5, 1.0)
    np.save(tmp_path / "rollout_coordinates.npy", pred["Coordinates"])
    np.save(tmp_path / "rollout_temperatures.npy", pred["InternalEnergy"])
    out = evaluation.convert_rollout_to_hdf5(str(tmp_path), sim, 1.0, 0.05,
                                             str(tmp_path / "port.hdf5"), window_size=window_size)
    ref = jax_evaluation.convert_rollout_to_hdf5(str(tmp_path), sim, 1.0, 0.05,
                                                 str(tmp_path / "jax.hdf5"),
                                                 window_size=window_size)
    assert sorted(out) == sorted(ref)
    for key in out:
        np.testing.assert_array_equal(np.asarray(out[key]), np.asarray(ref[key]), err_msg=key)
    written = read_simulation(str(tmp_path / "port.hdf5"))
    for key in ("Coordinates", "Velocities", "HydroAcceleration"):
        np.testing.assert_array_equal(written[key], out[key])
    generate_metadata(str(tmp_path / "port.hdf5"), str(tmp_path / "metadata.json"))
    with open(tmp_path / "metadata.json") as f:
        meta = json.load(f)
    assert meta["dt"] == 0.05 and np.isfinite(meta["acc_std"]).all()
    with pytest.raises(ValueError, match="Particle dimension mismatch"):
        evaluation.convert_rollout_to_hdf5(
            str(tmp_path), {**sim, "Coordinates": sim["Coordinates"][:, :100]}, 1.0, 0.05,
            str(tmp_path / "bad.hdf5"))
