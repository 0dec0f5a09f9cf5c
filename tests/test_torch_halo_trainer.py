"""The halo path's entry points on gloo ranks: ``Trainer(mesh, halo=...)``,
``cli.train --spatial_shards`` and ``cli.render_rollout --spatial_shards``,
held against the JAX package's ``Trainer(halo=...)`` on its virtual CPU
mesh, against the port's single-device Trainer and render, and against
themselves (a resume, the ranks' agreement).

One spawn of 2 ranks (``tests/torch_halo_workers.py`` on
``torch_sharded_workers.Ranks``: a file store, no JAX in the ranks) runs
every case while the references are computed here. N = 2,048, k = 3 (the
noised halo plan needs twice 2 halo layers of exact cells: grid 8, which
k = 4 leaves at 7), latent 16, one hidden layer, 2 message-passing steps; a
training simulation of 9 snapshots (4 windows: 2 steps of batch 2 an epoch)
and a validation one of 8 (3 windows: a full batch and a padded tail).

Tolerances:
* against JAX (noise 0, no augmentation, one epoch from the same converted
  params): the history's losses within ``tests/test_torch_halo.py``'s
  rtols for the halo step against JAX (the loss and the momentum term, a
  squared global sum, 1e-3; acceleration and temperature rate 2e-4), and
  every parameter
  within 1e-5 of its leaf's largest magnitude: the JAX multi-process halo
  test's 1e-5 (``tests/test_multiprocess.py``), taken per leaf and not per
  entry, since Adam's first steps divide each gradient entry by its own
  magnitude, so an entry whose gradient is near 0 moves by a share of the
  learning rate that float32 sums in another order change (4.9e-5 of the
  entry at worst here, where JAX against JAX sums in the same order);
* with the noise keyed per particle, against the port's single-device
  ``Trainer(partition_invariant_noise=True)`` over 2 epochs: every history
  value within 1e-5 relative, every parameter within 1e-5 of its leaf's
  largest magnitude;
* the resume and the ranks' agreement: bit for bit;
* the halo render against the single-device render: 2e-5 (the JAX halo
  rollout test's).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu.data.dataset import SequenceDataset as JaxSequenceDataset
from cosmology_gnn_simulation_tpu.data.synthetic import generate_synthetic_simulation
from cosmology_gnn_simulation_tpu.metadata import compute_metadata
from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.parallel import halo as jhalo
from cosmology_gnn_simulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cosmology_gnn_simulation_tpu.training import plots as jax_plots
from cosmology_gnn_simulation_tpu.training.trainer import TrainConfig as JaxTrainConfig
from cosmology_gnn_simulation_tpu.training.trainer import Trainer as JaxTrainer
from cosmology_gnn_simulation_tpu.training.trainer import (
    default_model_config as jax_default_model_config,
)
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu_torch.cli import render_rollout
from cosmology_gnn_simulation_tpu_torch.cli import train as train_cli
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.data import write_simulation
from cosmology_gnn_simulation_tpu_torch.data.dataset import SequenceDataset
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import default_model_config
from cosmology_gnn_simulation_tpu_torch.parallel import halo
from cosmology_gnn_simulation_tpu_torch.training import plots
from cosmology_gnn_simulation_tpu_torch.training.trainer import TrainConfig, Trainer
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves
from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib

import torch_halo_workers as hw
import torch_sharded_workers as workers

N, K, P, RENDER_STEPS = 2048, 3, 2, 4
MODEL = dict(window_size=5, latent_size=16, mlp_hidden_size=16, mlp_num_hidden_layers=1,
             num_message_passing_steps=2)
FIT_TC = dict(num_neighbors=K, batch_size=2, noise_std=0.0, augment_prob=0.0,
              momentum_loss_weight=0.5, num_epochs=1, learning_rate=1e-3,
              final_learning_rate=1e-4, save_every=1)
NOISED_TC = dict(FIT_TC, noise_std=3e-4, partition_invariant_noise=True, num_epochs=2)
AUGMENTED_TC = dict(FIT_TC, augment_prob=1.0)
JAX_RTOL, SINGLE_RTOL, OUT_TOL = 1e-5, 1e-5, 2e-5
JAX_HISTORY_RTOLS = {"loss": 1e-3, "momentum": 1e-3, "acc": 2e-4, "temp_rate": 2e-4}
ARTIFACTS = {"model_best", "model_epoch_0", "model_final", "training_history.json"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here (the ranks set theirs): the tier-1 run puts
    six pytest workers on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("halo_trainer")
    sims = {"train": generate_synthetic_simulation(num_snapshots=9, num_particles=N, seed=0),
            "val": generate_synthetic_simulation(num_snapshots=8, num_particles=N, seed=1),
            "test": generate_synthetic_simulation(num_snapshots=9, num_particles=N, seed=2)}
    for sub in ("train", "val"):
        os.makedirs(base / sub)
        write_simulation(str(base / sub / "sim.hdf5"), sims[sub])
    write_simulation(str(base / "test.hdf5"), sims["test"])
    meta = {key: (np.asarray(v).tolist() if hasattr(v, "shape") else v)
            for key, v in compute_metadata(sims["train"]).items()}
    with open(base / "metadata.json", "w") as f:
        json.dump(meta, f)
    jcfg = jax_default_model_config(**MODEL)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    params = jax.tree.map(np.asarray, jparams)
    frame = sims["train"]["Coordinates"][4]
    hc = halo.choose_halo_config(N, K, P, positions=frame)
    hc_noise = halo.choose_halo_config(N, K, P, noise=True, positions=frame)
    # A checkpoint of the port for the render: the JAX weights and config.
    ckpt_lib.save_checkpoint(str(base), "model", params_from_jax(params, device="cpu"),
                             config={"model": default_model_config(**MODEL)._asdict()})
    return dict(base=base, meta=meta, jcfg=jcfg, jparams=jparams, params=params, hc=hc,
                hc_noise=hc_noise)


def _dirs(s):
    return dict(train_dir=str(s["base"] / "train"), val_dir=str(s["base"] / "val"))


def _trainer_kw(s, name, hc, tc, **extra):
    return dict(model=MODEL, meta=s["meta"], params=s["params"], hc=tuple(hc), tc=tc,
                out=str(s["base"] / name), **_dirs(s), **extra)


def _train_argv(s, *extra):
    return ["--train_dir", str(s["base"] / "train"), "--val_dir", str(s["base"] / "val"),
            "--metadata_path", str(s["base"] / "metadata.json"), "--device", "cpu",
            "--num_epochs", "1", "--batch_size", "2", "--latent_size", "16",
            "--mlp_hidden_size", "16", "--mlp_num_hidden_layers", "1",
            "--num_message_passing_steps", "2", "--num_neighbors", str(K), "--noise_std", "3e-4",
            "--learning_rate", "1e-3", "--save_every", "1", *extra]


def _render_argv(s, *extra):
    return ["--model_path", str(s["base"] / "model"), "--test_data", str(s["base"] / "test.hdf5"),
            "--metadata_path", str(s["base"] / "metadata.json"), "--num_neighbors", str(K),
            "--device", "cpu", "--num_steps", str(RENDER_STEPS), *extra]


def _single_fit(s, tc, out):
    """The port's single-device Trainer over the same sets (the plain cell
    list, as the halo shards search)."""
    tc = TrainConfig(**dict(tc, neighbor_method="celllist", output_dir=str(out)))
    train = SequenceDataset(str(s["base"] / "train"), 5, s["meta"])
    val = SequenceDataset(str(s["base"] / "val"), 5, s["meta"])
    trainer = Trainer(default_model_config(**MODEL),
                      NormalizationStats.from_metadata(s["meta"], device="cpu"), tc,
                      len(train) // tc.batch_size, params_from_jax(s["params"], device="cpu"),
                      device="cpu")
    trainer.fit(train, val, verbose=False)
    return trainer


def _jax_fit(s, out):
    """JAX ``Trainer(halo=...)`` on a (1, 2) CPU mesh, one epoch."""
    tc = JaxTrainConfig(**dict(FIT_TC, output_dir=str(out)))
    train = JaxSequenceDataset(str(s["base"] / "train"), 5, s["meta"])
    val = JaxSequenceDataset(str(s["base"] / "val"), 5, s["meta"])
    trainer = JaxTrainer(s["jcfg"], JaxStats.from_metadata(s["meta"]), tc,
                         len(train) // tc.batch_size, s["jparams"],
                         mesh=jax_make_mesh((1, P), devices=jax.devices()[:P]),
                         halo=jhalo.HaloConfig(*s["hc"]))
    trainer.fit(train, val, verbose=False)
    return trainer


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every rank case, and the references made here meanwhile (no loss or
    error plots here or in the ranks: seconds each, and no test reads
    them)."""
    s = setup
    cases = [
        ("fit", hw.halo_trainer_case, (1, P), _trainer_kw(s, "fit", s["hc"], FIT_TC)),
        ("noised", hw.halo_trainer_case, (1, P),
         _trainer_kw(s, "noised", s["hc_noise"], NOISED_TC, resume=True)),
        ("augmented", hw.halo_trainer_case, (1, P),
         _trainer_kw(s, "augmented", s["hc"], AUGMENTED_TC)),
        ("cli", hw.cli_train_case, None,
         dict(argv=_train_argv(s, "--spatial_shards", str(P)), out=str(s["base"] / "cli"))),
        ("indivisible", hw.cli_refusal_case, None,
         dict(argv=_train_argv(s, "--spatial_shards", "3", "--output_dir",
                               str(s["base"] / "indivisible")))),
        ("render", hw.render_case, None,
         dict(argv=_render_argv(s, "--spatial_shards", str(P)),
              out=str(s["base"] / "render"))),
    ]
    spawned = workers.Ranks(P, str(tmp_path_factory.mktemp("halo_trainer_ranks") / "rendezvous"),
                            cases)
    patch = pytest.MonkeyPatch()
    for name in ("plot_losses", "plot_rollout_errors"):
        for module in (jax_plots, plots):
            patch.setattr(module, name, lambda *args, **kwargs: None)
    try:
        refs = {"jax": _jax_fit(s, s["base"] / "jax_fit"),
                "single": _single_fit(s, NOISED_TC, s["base"] / "single"),
                "render": render_rollout.main(_render_argv(s, "--output_dir",
                                                           str(s["base"] / "render_single")))}
    finally:
        patch.undo()
    return spawned.results(), refs


def _close_history(got, want, rtols):
    """Each loss series within ``rtols[term]`` (a number: every term's)."""
    def rtol(term):
        return rtols if isinstance(rtols, float) else rtols[term]

    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol("loss"), err_msg=key)
    for key, values in want["component_losses"].items():
        np.testing.assert_allclose(got["component_losses"][key], values,
                                   rtol=rtol(key.rsplit("_", 1)[0]), err_msg=key)
    assert got["best_epoch"] == want["best_epoch"]


def test_halo_trainer_matches_jax(setup, ranks):
    results, refs = ranks
    jax_trainer = refs["jax"]
    want = [t.numpy() for t in tree_leaves(params_from_jax(
        jax.tree.map(np.asarray, jax_trainer.params), device="cpu"))]
    assert workers.equal_on_every_rank([r["fit"]["params"] for r in results])
    for got, ref in zip(results[0]["fit"]["params"], want):
        assert np.abs(got - ref).max() <= JAX_RTOL * np.abs(ref).max()
    _close_history(results[0]["fit"]["history"], jax_trainer.history, JAX_HISTORY_RTOLS)
    assert results[0]["fit"]["history"] == results[1]["fit"]["history"]
    # Rank 0 alone writes; the tail batch was evaluated (3 windows).
    assert ARTIFACTS <= set(results[0]["fit"]["files"]) and results[1]["fit"]["files"] == []


def _state(s, name, epoch):
    return ckpt_lib.load_state(str(s["base"] / name / f"model_epoch_{epoch}"))


def test_noised_halo_fit_matches_single_device_and_resumes(setup, ranks):
    results, refs = ranks
    s = setup
    single = refs["single"]
    got = results[0]["noised"]
    assert workers.equal_on_every_rank([r["noised"]["params"] for r in results])
    _close_history(got["history"], single.history, SINGLE_RTOL)
    for epoch in (0, 1):
        mine = tree_leaves(_state(s, "noised/rank0", epoch)["params"])
        theirs = tree_leaves(_state(s, "single", epoch)["params"])
        for a, b in zip(mine, theirs):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= SINGLE_RTOL * max(scale, 1e-30)
    # The resume from model_epoch_0 equals the continuous run bit for bit:
    # params, Adam state, generator and history.
    resumed = got["resumed"]
    assert resumed["start"] == 1 and resumed["history"] == got["history"]
    a, b = _state(s, "noised/rank0", 1), _state(s, "noised/resumed0", 1)
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
        assert torch.equal(x, y)
    for i, state in a["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state[key], b["optimizer"]["state"][i][key])
    assert torch.equal(a["generator"], b["generator"])
    assert results[1]["noised"]["resumed"]["files"] == []


def test_augmented_halo_fit_agrees_on_every_rank(ranks):
    results, _ = ranks
    assert workers.equal_on_every_rank([r["augmented"]["params"] for r in results])
    assert results[0]["augmented"]["history"] == results[1]["augmented"]["history"]
    # The host augmentation moved the fit off the unaugmented one.
    assert not workers.equal_on_every_rank([results[0]["augmented"]["params"],
                                            results[0]["fit"]["params"]])


def test_train_cli_with_spatial_shards(ranks):
    results, _ = ranks
    got = [r["cli"] for r in results]
    assert got[0]["mesh"] == {"data": 1, "particle": P}
    assert halo.HaloConfig(*got[0]["halo"]).num_shards == P
    assert workers.equal_on_every_rank([g["params"] for g in got])
    assert got[0]["history"] == got[1]["history"]
    assert np.isfinite(got[0]["history"]["train_loss"]).all()
    assert ARTIFACTS <= set(got[0]["files"]) and got[1]["files"] == []
    for message in (r["indivisible"] for r in results):
        assert "must divide the world size 2" in message


def test_render_cli_with_spatial_shards(setup, ranks):
    results, refs = ranks
    single = refs["render"]
    for r in results:
        for key, value in single.items():
            np.testing.assert_allclose(r["render"]["errors"][key], value, rtol=OUT_TOL,
                                       atol=OUT_TOL, err_msg=key)
    base = setup["base"]
    np.testing.assert_allclose(np.load(base / "render/rank0/rollout_coordinates.npy"),
                               np.load(base / "render_single/rollout_coordinates.npy"),
                               rtol=OUT_TOL, atol=OUT_TOL)
    assert {"rollout_coordinates.npy", "rollout_temperatures.npy",
            "rollout_summary.txt"} <= set(results[0]["render"]["files"])
    assert results[1]["render"]["files"] == []


def test_cellblock_with_spatial_shards_exits(setup, tmp_path):
    with pytest.raises(SystemExit):
        train_cli.main(_train_argv(setup, "--spatial_shards", str(P), "--aggregation",
                                   "cellblock_hybrid", "--output_dir", str(tmp_path / "out")))
