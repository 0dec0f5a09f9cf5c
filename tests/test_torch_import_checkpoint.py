"""The JAX checkpoint importer (the repository's ``import_jax_checkpoint.py``):
a checkpoint written by the JAX package's ``save_checkpoint`` (params, Adam
state, epoch, PRNG key, config) becomes one of the port's, whose params are
bit-equal to ``convert.params_from_jax`` of JAX's and whose config carries
over unchanged; the port's ``one_step_test`` on it agrees with JAX's on the
original within ``tests/test_torch_trainer_jax.py``'s evaluation tolerance
(1e-6 relative), and ``cli.train --pretrained_model`` starts from its
weights.
"""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import optax
import pytest
import torch

from cosmology_gnn_simulation_tpu.cli import one_step_test as jax_one_step_test
from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.training.trainer import TrainConfig as JaxTrainConfig
from cosmology_gnn_simulation_tpu.training.trainer import (
    default_model_config as jax_default_model_config,
)
from cosmology_gnn_simulation_tpu.utils import checkpoint as jax_ckpt
from cosmology_gnn_simulation_tpu_torch.cli import generate_metadata as generate_metadata_cli
from cosmology_gnn_simulation_tpu_torch.cli import one_step_test
from cosmology_gnn_simulation_tpu_torch.cli import train as train_cli
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.data import generate_synthetic_simulation, write_simulation
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
)
from cosmology_gnn_simulation_tpu_torch.training.trainer import Trainer
from cosmology_gnn_simulation_tpu_torch.types import tree_leaves
from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib

MODEL = dict(window_size=5, latent_size=16, mlp_hidden_size=16, mlp_num_hidden_layers=1,
             num_message_passing_steps=2)
EVAL_RTOL = 1e-6
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "import_jax_checkpoint.py")


def _importer():
    spec = importlib.util.spec_from_file_location("import_jax_checkpoint", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A JAX checkpoint as the JAX Trainer writes one (epoch 3), its import,
    and the files the CLIs read."""
    base = tmp_path_factory.mktemp("import_ckpt")
    jcfg = jax_default_model_config(**MODEL)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    opt = optax.adam(1e-3)
    config = {"model": jcfg._asdict(),
              "train": dataclasses.asdict(JaxTrainConfig(num_neighbors=8, batch_size=2))}
    jax_path = jax_ckpt.save_checkpoint(str(base), "jax_model", jparams, opt.init(jparams),
                                        epoch=3, rng_key=jax.random.PRNGKey(7), config=config)
    port_path = _importer().main([jax_path, str(base / "port_model")])
    for sub, seed in (("train", 0), ("val", 1)):
        os.makedirs(base / sub)
        write_simulation(str(base / sub / f"sim{seed}.hdf5"), generate_synthetic_simulation(
            num_snapshots=8, num_particles=128, seed=seed))
    write_simulation(str(base / "test.hdf5"), generate_synthetic_simulation(
        num_snapshots=12, num_particles=256, seed=3))
    generate_metadata_cli.main(["--dataset", str(base / "train" / "sim0.hdf5"),
                                "--output", str(base / "metadata.json")])
    return dict(base=base, jax_path=jax_path, port_path=port_path, config=config,
                jparams=jparams)


def test_params_epoch_and_config_carry_over(imported):
    state = ckpt_lib.load_state(imported["port_path"])
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, imported["jparams"]),
                                       device="cpu"))
    got = tree_leaves(state["params"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert state["epoch"] == 3
    # Not carried: no optimizer state, no generator.
    assert "optimizer" not in state and "generator" not in state
    restored = ckpt_lib.load_checkpoint(imported["port_path"], device="cpu")
    assert restored["config"]["model"] == imported["config"]["model"]
    assert restored["config"]["train"] == imported["config"]["train"]
    EncodeProcessDecodeConfig(**restored["config"]["model"])  # the port's config reads it


def test_one_step_test_on_the_import_matches_jax(imported):
    argv = ["--test_data", str(imported["base"] / "test.hdf5"), "--metadata_path",
            str(imported["base"] / "metadata.json"), "--num_timesteps", "3",
            "--num_neighbors", "8"]
    port = one_step_test.main(["--model_path", imported["port_path"], "--device", "cpu", *argv])
    ref = jax_one_step_test.main(["--model_path", imported["jax_path"], *argv])
    assert list(port["tested_timesteps"]) == list(ref["tested_timesteps"])
    for key in ("position_errors", "temperature_errors"):
        np.testing.assert_allclose(port[key], ref[key], rtol=EVAL_RTOL, err_msg=key)


def test_pretrained_model_starts_from_the_import(imported, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(Trainer, "fit", lambda self, *args, **kwargs: self.params)
    trainer = train_cli.main([
        "--train_dir", str(imported["base"] / "train"), "--val_dir",
        str(imported["base"] / "val"), "--metadata_path", str(imported["base"] / "metadata.json"),
        "--output_dir", str(tmp_path / "out"), "--device", "cpu", "--latent_size", "16",
        "--mlp_hidden_size", "16", "--mlp_num_hidden_layers", "1",
        "--num_message_passing_steps", "2", "--num_neighbors", "8",
        "--pretrained_model", imported["port_path"]])
    assert f"Starting from pretrained model: {imported['port_path']}" in capsys.readouterr().out
    want = tree_leaves(ckpt_lib.load_state(imported["port_path"])["params"])
    for a, b in zip(tree_leaves(trainer.params), want):
        assert torch.equal(a.detach(), b)
