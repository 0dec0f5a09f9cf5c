"""The port's training CLI and metadata CLI on synthetic HDF5 files, on the
CPU (``--device cpu``): the artifacts of the JAX CLI, a full ``--resume``,
``--pretrained_model`` loading weights only, the flags of the later slices
training (the config-4 flags ``--aggregation cellblock``,
``--cellblock_variable`` and ``--carry_dtype bfloat16``, the sharded ones
and ``--native_loader``), ``--spatial_shards`` in a single process raising
the ``ValueError`` that names torchrun, and ``generate_metadata`` writing
the JAX CLI's JSON.
"""

import json
import os

import pytest
import torch
import torch.distributed as dist

from cosmology_gnn_simulation_tpu.cli import generate_metadata as jax_generate_metadata_cli
from cosmology_gnn_simulation_tpu_torch.cli import generate_metadata as generate_metadata_cli
from cosmology_gnn_simulation_tpu_torch.cli import train as train_cli
from cosmology_gnn_simulation_tpu_torch.data import generate_synthetic_simulation, write_simulation
from cosmology_gnn_simulation_tpu_torch.training import plots
from cosmology_gnn_simulation_tpu_torch.types import tree_leaves
from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    host's cores, and this file's many small CPU ops run tens of times
    slower when each worker's thread pool competes for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two training files, one validation file and their metadata.json."""
    base = tmp_path_factory.mktemp("cli")
    for sub, seeds in (("train", (0, 1)), ("val", (2,))):
        os.makedirs(base / sub)
        for seed in seeds:
            write_simulation(str(base / sub / f"sim{seed}.hdf5"), generate_synthetic_simulation(
                num_snapshots=8, num_particles=128, seed=seed))
    generate_metadata_cli.main(["--dataset", str(base / "train" / "sim0.hdf5"),
                                "--output", str(base / "metadata.json")])
    return base


def _argv(data, out, *extra):
    return ["--train_dir", str(data / "train"), "--val_dir", str(data / "val"),
            "--metadata_path", str(data / "metadata.json"), "--output_dir", str(out),
            "--device", "cpu", "--num_epochs", "2", "--batch_size", "2", "--latent_size", "16",
            "--mlp_hidden_size", "16", "--mlp_num_hidden_layers", "1",
            "--num_message_passing_steps", "2", "--num_neighbors", "8", "--noise_std", "3e-4",
            "--learning_rate", "1e-3", "--final_learning_rate", "1e-4", "--save_every", "1",
            *extra]


def test_train_writes_the_artifacts_and_resumes(data, tmp_path, capsys):
    out = tmp_path / "out"
    trainer = train_cli.main(_argv(data, out))
    assert sorted(os.listdir(out)) == ["model_best", "model_epoch_0", "model_epoch_1",
                                       "model_final", "plots", "training_history.json"]
    assert sorted(os.listdir(out / "plots")) == ["losses_epoch_0.png", "losses_final.png"]
    with open(out / "training_history.json") as f:
        history = json.load(f)
    assert sorted(history) == ["best_epoch", "best_val_loss", "component_losses",
                               "learning_rates", "train_loss", "val_loss"]
    assert len(history["train_loss"]) == 2
    with open(out / "model_final" / "config.json") as f:
        config = json.load(f)
    assert config["model"]["num_message_passing_steps"] == 2
    assert config["train"]["noise_std"] == 3e-4 and config["train"]["output_dir"] == str(out)
    assert trainer.device.type == "cpu"

    capsys.readouterr()
    resumed_out = tmp_path / "resumed"
    monkey = pytest.MonkeyPatch()
    monkey.setattr(plots, "plot_losses", lambda *args, **kwargs: None)
    try:
        resumed = train_cli.main(_argv(data, resumed_out, "--resume",
                                       str(out / "model_epoch_0")))
    finally:
        monkey.undo()
    assert "continuing at epoch 1" in capsys.readouterr().out
    assert resumed.history == trainer.history
    a = ckpt_lib.load_state(str(out / "model_epoch_1"))
    b = ckpt_lib.load_state(str(resumed_out / "model_epoch_1"))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a["params"]),
                                                 tree_leaves(b["params"])))
    assert sorted(os.listdir(resumed_out)) == ["model_best", "model_epoch_1", "model_final",
                                               "plots", "training_history.json"]


def test_pretrained_model_loads_weights_only(data, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(plots, "plot_losses", lambda *args, **kwargs: None)
    source = tmp_path / "source"
    train_cli.main(_argv(data, source, "--num_epochs", "1"))
    seen = {}
    fit = train_cli.Trainer.fit

    def spy(self, *args, **kwargs):
        seen["params"] = [t.detach().clone() for t in tree_leaves(self.params)]
        seen["adam_state"] = dict(self.opt_state.optimizer.state)
        seen["start_epoch"] = kwargs["start_epoch"]
        return fit(self, *args, **kwargs)

    monkeypatch.setattr(train_cli.Trainer, "fit", spy)
    capsys.readouterr()
    trainer = train_cli.main(_argv(data, tmp_path / "out", "--num_epochs", "1",
                                   "--pretrained_model", str(source / "model_final")))
    assert "Starting from pretrained model" in capsys.readouterr().out
    saved = ckpt_lib.load_state(str(source / "model_final"))["params"]
    assert all(torch.equal(x, y) for x, y in zip(seen["params"], tree_leaves(saved)))
    # Weights only: a fresh optimizer, the schedule and the epochs from 0.
    assert seen["adam_state"] == {} and seen["start_epoch"] == 0
    assert len(trainer.history["train_loss"]) == 1
    assert trainer.opt_state.schedule.last_epoch == 3  # this run's 3 steps

    # A failed load is loud, and training goes on from random weights.
    train_cli.main(_argv(data, tmp_path / "out2", "--num_epochs", "1",
                         "--pretrained_model", str(tmp_path / "missing")))
    assert "Error loading pretrained model" in capsys.readouterr().out


@pytest.mark.parametrize("flags,item", [
    # Ported in slice 11 (item None): the flag trains one epoch.
    (["--aggregation", "cellblock"], None),
    (["--aggregation", "cellblock", "--cellblock_variable"], None),
    (["--carry_dtype", "bfloat16"], None),
    # Ported in slice 12: one rank of a process group (gloo, in memory) with
    # --data_parallel; --distributed without torchrun's environment runs
    # single-process, as the JAX CLI does without a coordinator.
    (["--data_parallel"], None),
    # Ported in slice 15: halo sharding needs a process group of ranks.
    (["--spatial_shards", "2"], "torchrun --nproc_per_node=2"),
    (["--distributed"], None),
    (["--distributed", "--data_parallel"], None),
    (["--native_loader"], None),
])
def test_unported_flags_raise(data, tmp_path, flags, item):
    if item is None:
        try:
            trainer = train_cli.main(_argv(data, tmp_path / "out", "--num_epochs", "1", *flags))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        assert os.path.isdir(tmp_path / "out" / "model_final")
        assert all(torch.isfinite(torch.tensor(trainer.history["train_loss"])))
        assert (trainer.mesh is not None) == ("--data_parallel" in flags)
        if trainer.mesh is not None:
            assert trainer.mesh.shape == {"data": 1, "particle": 1}
        return
    with pytest.raises(ValueError, match=item):
        train_cli.main(_argv(data, tmp_path / "out", *flags))
    assert not dist.is_initialized()
    assert not os.path.exists(tmp_path / "out" / "model_final")


def test_device_defaults_to_the_card(data, tmp_path):
    argv = _argv(data, tmp_path / "out")
    argv = argv[:argv.index("--device")] + argv[argv.index("--device") + 2:]
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            train_cli.main(argv)


def test_generate_metadata_writes_the_jax_cli_json(data, tmp_path):
    dataset = str(data / "val" / "sim2.hdf5")
    generate_metadata_cli.main(["--dataset", dataset, "--output", str(tmp_path / "port.json")])
    jax_generate_metadata_cli.main(["--dataset", dataset, "--output", str(tmp_path / "jax.json")])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
