"""The port's eval CLIs on synthetic HDF5 files, on the CPU (``--device
cpu``):

* the pipeline of the verify recipe: synthetic HDF5 -> ``generate_metadata``
  -> a 1-epoch ``cli.train`` -> ``one_step_test`` -> ``render_rollout``
  (with ``--exactness_guard fallback`` and ``--sorted_state on``) ->
  ``rollout_conversion``, whose file is a dataset again;
* the JAX CLIs against the port's on the same HDF5 file and the same
  weights (JAX's params saved by the JAX package's Orbax writer, the same
  params through ``convert.params_from_jax`` by the port's): equal tested
  timesteps, errors within rtol 1e-4 and trajectories within 1e-5 (float32,
  summation order only), the same summary lines;
* the refusals: unported flags (``NotImplementedError`` naming the ROADMAP
  item, before any file is read), the brute-force fallback with cell-block
  aggregation (a parser error, as in JAX), a JAX Orbax checkpoint (its
  importer is ROADMAP item 2), ``--device cuda`` without a card.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu.cli import one_step_test as jax_one_step_test
from cosmology_gnn_simulation_tpu.cli import render_rollout as jax_render_rollout
from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.training.trainer import (
    default_model_config as jax_default_model_config,
)
from cosmology_gnn_simulation_tpu.utils import checkpoint as jax_ckpt
from cosmology_gnn_simulation_tpu_torch.cli import generate_metadata as generate_metadata_cli
from cosmology_gnn_simulation_tpu_torch.cli import one_step_test, render_rollout
from cosmology_gnn_simulation_tpu_torch.cli import rollout_conversion
from cosmology_gnn_simulation_tpu_torch.cli import train as train_cli
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.data import generate_synthetic_simulation, write_simulation
from cosmology_gnn_simulation_tpu_torch.data.hdf5 import read_simulation
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import default_model_config
from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib

MODEL = dict(window_size=5, latent_size=16, mlp_hidden_size=16, mlp_num_hidden_layers=1,
             num_message_passing_steps=2)
RTOL, COORD_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (as tests/test_torch_cli_train.py): the tier-1
    run puts six pytest workers on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Training, validation and test files, and the metadata of the first."""
    base = tmp_path_factory.mktemp("eval_cli")
    for sub, seeds in (("train", (0, 1)), ("val", (2,))):
        os.makedirs(base / sub)
        for seed in seeds:
            write_simulation(str(base / sub / f"sim{seed}.hdf5"), generate_synthetic_simulation(
                num_snapshots=10, num_particles=128, seed=seed))
    write_simulation(str(base / "test.hdf5"), generate_synthetic_simulation(
        num_snapshots=12, num_particles=128, seed=3))
    generate_metadata_cli.main(["--dataset", str(base / "train" / "sim0.hdf5"),
                                "--output", str(base / "metadata.json")])
    return base


def _eval_argv(data, model, *extra):
    return ["--model_path", str(model), "--test_data", str(data / "test.hdf5"),
            "--metadata_path", str(data / "metadata.json"), "--num_neighbors", "8", *extra]


def test_the_verify_pipeline_runs_on_the_cpu(data, tmp_path, capsys):
    out = tmp_path / "model_out"
    train_cli.main(["--train_dir", str(data / "train"), "--val_dir", str(data / "val"),
                    "--metadata_path", str(data / "metadata.json"), "--output_dir", str(out),
                    "--device", "cpu", "--num_epochs", "1", "--batch_size", "2",
                    "--latent_size", "16", "--mlp_hidden_size", "16",
                    "--num_message_passing_steps", "2", "--num_neighbors", "8"])
    model = out / "model_best"
    results = one_step_test.main(_eval_argv(data, model, "--num_timesteps", "3",
                                            "--device", "cpu"))
    printed = capsys.readouterr().out
    assert "ONE-STEP VALIDATION RESULTS" in printed and "Average position MSE" in printed
    assert len(results["tested_timesteps"]) == 3
    assert np.isfinite(results["position_error"]) and np.isfinite(results["temperature_error"])

    rollout_dir = tmp_path / "rollout_results"
    errors = render_rollout.main(_eval_argv(
        data, model, "--output_dir", str(rollout_dir), "--device", "cpu",
        "--exactness_guard", "fallback", "--sorted_state", "on"))
    printed = capsys.readouterr().out
    assert "kNN exactness certificate held for every rollout step" in printed
    assert sorted(os.listdir(rollout_dir)) == ["errors.png", "rollout_coordinates.npy",
                                               "rollout_summary.txt", "rollout_temperatures.npy"]
    coords = np.load(rollout_dir / "rollout_coordinates.npy")
    assert coords.shape == (12, 128, 3) and np.isfinite(coords).all()
    assert len(errors["position_errors"]) == 12
    assert "Time steps simulated: 7" in (rollout_dir / "rollout_summary.txt").read_text()

    converted = tmp_path / "rollout_as_dataset.hdf5"
    rollout_conversion.main(["--rollout_dir", str(rollout_dir), "--original_data",
                             str(data / "test.hdf5"), "--metadata_path",
                             str(data / "metadata.json"), "--output", str(converted)])
    assert "Conversion complete" in capsys.readouterr().out
    generate_metadata_cli.main(["--dataset", str(converted),
                                "--output", str(tmp_path / "metadata.json")])
    with open(tmp_path / "metadata.json") as f:
        assert sorted(json.load(f)) == sorted(json.loads((data / "metadata.json").read_text()))
    assert sorted(read_simulation(str(converted))) == sorted(
        read_simulation(str(data / "test.hdf5")))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The same weights saved by each package's own checkpoint writer."""
    base = tmp_path_factory.mktemp("ckpt")
    jcfg = jax_default_model_config(**MODEL)
    jparams = jax_init(jax.random.PRNGKey(2), jcfg)
    jax_path = jax_ckpt.save_checkpoint(str(base), "jax_model", jparams,
                                        config={"model": jcfg._asdict()})
    port_path = ckpt_lib.save_checkpoint(
        str(base), "port_model", params_from_jax(jax.tree.map(np.asarray, jparams),
                                                 device="cpu"),
        config={"model": default_model_config(**MODEL)._asdict()})
    return jax_path, port_path


def test_the_cli_results_match_jax(data, checkpoints, tmp_path, capsys):
    jax_path, port_path = checkpoints
    extra = ("--num_timesteps", "4", "--seed", "3")
    ref = jax_one_step_test.main(_eval_argv(data, jax_path, *extra))
    out = one_step_test.main(_eval_argv(data, port_path, *extra, "--device", "cpu"))
    assert out["tested_timesteps"] == ref["tested_timesteps"]
    for key in ("position_error", "temperature_error", "position_errors",
                "temperature_errors"):
        np.testing.assert_allclose(out[key], ref[key], rtol=RTOL, atol=0)

    capsys.readouterr()
    jax_errors = jax_render_rollout.main(_eval_argv(
        data, jax_path, "--output_dir", str(tmp_path / "jax"), "--num_steps", "4"))
    jax_printed = capsys.readouterr().out
    errors = render_rollout.main(_eval_argv(
        data, port_path, "--output_dir", str(tmp_path / "port"), "--num_steps", "4",
        "--device", "cpu"))
    printed = capsys.readouterr().out
    for name in ("rollout_coordinates.npy", "rollout_temperatures.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "port" / name),
                                   np.load(tmp_path / "jax" / name), atol=COORD_ATOL, rtol=0)
    for key in ("position_errors", "temperature_errors", "mean_position_error",
                "mean_temperature_error"):
        np.testing.assert_allclose(errors[key], jax_errors[key], rtol=RTOL, atol=1e-12)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    # The same messages, but for the numbers.
    def labels(text, out):
        return [line.split(":")[0] for line in text.replace(str(out), "OUT").splitlines()]

    assert labels(printed, tmp_path / "port") == labels(jax_printed, tmp_path / "jax")
    summary = (tmp_path / "port" / "rollout_summary.txt").read_text().splitlines()
    jax_summary = (tmp_path / "jax" / "rollout_summary.txt").read_text().splitlines()
    assert summary[4:-2] == jax_summary[4:-2]  # past the model path, before the errors


@pytest.mark.parametrize("cli, flags, item", [
    ("one_step_test", ["--aggregation", "cellblock"], 4),
    ("one_step_test", ["--cellblock_variable"], 4),
    ("render_rollout", ["--aggregation", "cellblock"], 4),
    ("render_rollout", ["--cellblock_variable"], 4),
    ("render_rollout", ["--spatial_shards", "2"], 5),
])
def test_unported_flags_raise(tmp_path, cli, flags, item):
    module = {"one_step_test": one_step_test, "render_rollout": render_rollout}[cli]
    argv = ["--model_path", str(tmp_path / "model"), "--test_data", str(tmp_path / "t.hdf5"),
            "--metadata_path", str(tmp_path / "no_such_metadata.json"),
            "--output_dir" if cli == "render_rollout" else "--num_timesteps",
            str(tmp_path / "out") if cli == "render_rollout" else "2", *flags]
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 item {item}"):
        module.main(argv)
    assert not os.path.exists(tmp_path / "out")


def test_the_other_refusals(data, checkpoints, tmp_path):
    jax_path, port_path = checkpoints
    with pytest.raises(SystemExit):  # the parser's error, as the JAX CLI's
        render_rollout.main(_eval_argv(data, port_path, "--aggregation", "cellblock_hybrid",
                                       "--exactness_guard", "fallback", "--device", "cpu"))
    with pytest.raises(SystemExit):
        one_step_test.main(_eval_argv(data, port_path, "--reneighbor_every", "2"))
    for module in (one_step_test, render_rollout):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
            module.main(_eval_argv(data, jax_path, "--device", "cpu",
                                   "--output_dir" if module is render_rollout else "--seed",
                                   str(tmp_path / "out") if module is render_rollout else "0"))
        with pytest.raises(FileNotFoundError):
            module.main(_eval_argv(data, tmp_path / "missing", "--device", "cpu"))
    if not torch.cuda.is_available():
        for module in (one_step_test, render_rollout):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                module.main(_eval_argv(data, port_path))
