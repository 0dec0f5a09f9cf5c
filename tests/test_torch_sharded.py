"""The port's index-sharded paths (``parallel/``) on gloo ranks, held against
the port on a mesh of one rank and against the JAX package's sharded
functions on a JAX CPU mesh of the same shape (conftest's 8 virtual
devices).

One spawn per world size (``tests/torch_sharded_workers.py``: ranks joined
by a file store, no JAX imported there) runs every case; the references are
computed here. The setup is ``tests/test_parallel.py``'s: 64 particles,
latent 16, one hidden layer, 2 message-passing steps, k = 8, batch 8, with
noise 0 and no augmentation (the noise keys differ per shard by design).
The weights are the JAX package's, carried across by
``convert.params_from_jax`` (no new converter is needed).

Tolerances: against the port on one rank, ``test_parallel.py``'s (loss rtol
1e-5; parameters after an Adam step rtol 5e-5, atol 5e-6; forward, eval and
rollouts 2e-5); against JAX, ``test_torch_training.py``'s for the
single-device step (loss rel 1e-6; gradients, read from an SGD step with lr
1, within 3e-5 of each leaf's largest magnitude) and 2e-5 for the forward,
eval and rollouts.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from cosmology_gnn_simulation_tpu.data.synthetic import generate_synthetic_simulation
from cosmology_gnn_simulation_tpu.metadata import compute_metadata
from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.parallel import sharded as jsharded
from cosmology_gnn_simulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cosmology_gnn_simulation_tpu.training.trainer import TrainConfig as JaxTrainConfig
from cosmology_gnn_simulation_tpu.training.trainer import (
    default_model_config as jax_default_model_config,
)
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.data import write_simulation
from cosmology_gnn_simulation_tpu_torch.parallel.mesh import make_mesh
from cosmology_gnn_simulation_tpu_torch.types import tree_leaves
from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib

import torch_sharded_workers as workers

MODEL = dict(window_size=5, latent_size=16, mlp_hidden_size=16, mlp_num_hidden_layers=1,
             num_message_passing_steps=2)
K = 8
TC = dict(num_neighbors=K, batch_size=8, noise_std=0.0, augment_prob=0.0,
          momentum_loss_weight=0.5, neighbor_query_tile=32)
# The momentum term alone, batch 1 (test_parallel.py's momentum case).
MOMENTUM_TC = dict(TC, batch_size=1, momentum_loss_weight=1.0, acc_loss_weight=0.0,
                   temp_rate_loss_weight=0.0)
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL, OUT_TOL = 1e-5, 5e-5, 5e-6, 2e-5
JAX_LOSS_REL, JAX_GRAD_TOL = 1e-6, 3e-5
ROLLOUT_STEPS = 3


@pytest.fixture(scope="module")
def setup():
    sim = generate_synthetic_simulation(num_snapshots=8, num_particles=64, seed=7)
    meta = {key: (np.asarray(v).tolist() if hasattr(v, "shape") else v)
            for key, v in compute_metadata(sim).items()}
    jcfg = jax_default_model_config(**MODEL)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)

    def stack(key, offset, count):
        return np.stack([sim[key][i + offset] if offset else sim[key][i:i + 5]
                         for i in range(3)] * 3)[:count]

    batch = {"positions": stack("Coordinates", 0, 8), "temperatures": stack("InternalEnergy", 0, 8),
             "target_positions": stack("Coordinates", 5, 8),
             "target_temperatures": stack("InternalEnergy", 5, 8)}
    return dict(sim=sim, meta=meta, jstats=JaxStats.from_metadata(meta), jcfg=jcfg,
                jparams=jparams, params=jax.tree.map(np.asarray, jparams), batch=batch)


@pytest.fixture
def one_rank():
    """A mesh of one rank (a gloo group over an in-memory store), taken
    down after the test."""
    try:
        yield make_mesh((1, 1), device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _leaves(tree):
    """A JAX param tree's leaves in the port's order."""
    return [t.numpy() for t in tree_leaves(params_from_jax(jax.tree.map(np.asarray, tree),
                                                           device="cpu"))]


def _kw(s, **extra):
    return dict(model=MODEL, meta=s["meta"], params=s["params"], **extra)


def _jax_mesh(shape):
    return jax_make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


def _jax_train(s, shape, tc, batch):
    """JAX's sharded step with sgd(1.0): its metrics and gradients."""
    mesh, opt = _jax_mesh(shape), optax.sgd(1.0)
    step = jsharded.make_data_parallel_train_step(s["jcfg"], s["jstats"], JaxTrainConfig(**tc),
                                                  opt, mesh)
    keys = jax.random.split(jax.random.PRNGKey(5), batch["positions"].shape[0])
    new, _, metrics = step(s["jparams"], opt.init(s["jparams"]),
                           jsharded.shard_batch(batch, mesh), keys)
    grads = [a - b for a, b in zip(_leaves(s["jparams"]), _leaves(new))]
    return {k: float(v) for k, v in metrics.items()}, grads


def _train_cases(s, shapes, tc=TC, batch=None, label="train"):
    batch = s["batch"] if batch is None else batch
    return [(f"{label}_{a}x{b}_{opt}", "train", (a, b), _kw(s, tc=tc, batch=batch, opt=opt))
            for a, b in shapes for opt in ("adam", "sgd")]


def _train_refs(s, mesh11, shapes, tc=TC, batch=None):
    """The references of ``_check_train``: the port's step on one rank (Adam
    and SGD) and JAX's sharded step of each shape (SGD gradients, divided by
    the rank count: JAX's psum and pmean transpose to a psum inside
    shard_map, and its step then sums the gradients over the mesh, so they
    come out P times the loss's gradient on P ranks; Adam's update does not
    see a common scale, so tests/test_parallel.py cannot. The port's are the
    loss's gradient, equal to the single-device step's)."""
    batch = s["batch"] if batch is None else batch
    old = _leaves(s["jparams"])
    ref_sgd = workers.train_case(mesh11, **_kw(s, tc=tc, batch=batch, opt="sgd"))
    refs = {"adam": workers.train_case(mesh11, **_kw(s, tc=tc, batch=batch, opt="adam")),
            "grads": [o - n for o, n in zip(old, ref_sgd["params"])], "old": old,
            "local": batch["positions"].shape[0]}
    for a, p in shapes:
        jmetrics, jgrads = _jax_train(s, (a, p), tc, batch)
        refs[(a, p)] = jmetrics, [g / (a * p) for g in jgrads]
    return refs


def _check_train(ranks, refs, shapes, label="train"):
    """Every shape's step against the port on one rank (Adam) and JAX's
    sharded step of the same shape (SGD gradients); replicas equal; the
    collective counts of one step."""
    world = len(ranks)
    m = MODEL["num_message_passing_steps"]
    for a, p in shapes:
        adam = [ranks[r][f"{label}_{a}x{p}_adam"] for r in range(world)]
        sgd = [ranks[r][f"{label}_{a}x{p}_sgd"] for r in range(world)]
        assert workers.equal_on_every_rank([o["params"] for o in adam])
        assert workers.equal_on_every_rank([o["params"] for o in sgd])
        got = adam[0]
        for key, value in refs["adam"]["metrics"].items():
            assert got["metrics"][key] == pytest.approx(value, rel=LOSS_RTOL, abs=1e-9), key
        for x, y in zip(got["params"], refs["adam"]["params"]):
            np.testing.assert_allclose(x, y, rtol=PARAM_RTOL, atol=PARAM_ATOL)
        jmetrics, jgrads = refs[(a, p)]
        grads = [o - n for o, n in zip(refs["old"], sgd[0]["params"])]
        assert sgd[0]["metrics"]["loss"] == pytest.approx(jmetrics["loss"], rel=JAX_LOSS_REL)
        for key in ("acceleration", "temp_rate", "momentum"):
            assert sgd[0]["metrics"][key] == pytest.approx(jmetrics[key], rel=1e-5, abs=1e-9)
        for want in (jgrads, refs["grads"]):
            worst = max(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)
                        for x, y in zip(grads, want))
            assert worst <= JAX_GRAD_TOL, (a, p, worst)
        # Per step: the positions and each step's latents gathered per local
        # sample; the latents' backward, the two particle-axis reductions,
        # the data-axis mean and the gradients' one all-reduce.
        local = refs["local"] // a
        assert got["collectives"] == {"all_gather": local * (1 + m),
                                      "all_reduce": local * m + 4, "broadcast": 0,
                                      "ppermute": 0}


def test_sharded_paths_on_two_ranks(setup, tmp_path, one_rank):
    s = setup
    sim = s["sim"]
    pos, temp = sim["Coordinates"][:5], sim["InternalEnergy"][:5]
    # The eval batch: 3 windows padded to 4 with copies of the last.
    padded = {k: np.concatenate([v[:3], v[2:3]]) for k, v in s["batch"].items()}
    momentum_batch = {k: v[:1] for k, v in s["batch"].items()}
    data, ckpt = _hdf5_sets(s, tmp_path)
    trainer_tc = dict(TC, batch_size=2, num_epochs=1, learning_rate=1e-3, save_every=1)
    argv = _cli_argv(data, ckpt)
    cases = [
        *_train_cases(s, [(2, 1), (1, 2)]),
        *_train_cases(s, [(1, 2)], tc=MOMENTUM_TC, batch=momentum_batch, label="momentum"),
        ("eval", "eval", (2, 1), _kw(s, tc=TC, batch=padded)),
        ("forward", "forward", (1, 2), _kw(s, pos=pos, temp=temp, k=K)),
        *[(f"rollout_r{r}", "rollout", (1, 2),
           _kw(s, pos=pos, temp=temp, k=K, steps=ROLLOUT_STEPS, reneighbor_every=r))
          for r in (1, 2)],
        ("trainer", "trainer", (2, 1),
         _kw(s, tc=dict(trainer_tc, output_dir=str(tmp_path / "fit_ranks")),
             train_dir=str(data / "train"), val_dir=str(data / "val"))),
        ("cli", "cli", None,
         dict(argv=[*argv, "--output_dir", str(tmp_path / "cli_ranks"), "--distributed",
                    "--data_parallel"])),
    ]
    # The ranks run while the references are computed here.
    spawned = workers.Ranks(2, str(tmp_path / "rendezvous"), cases)
    mesh11 = one_rank
    train_refs = _train_refs(s, mesh11, [(2, 1), (1, 2)])
    momentum_refs = _train_refs(s, mesh11, [(1, 2)], tc=MOMENTUM_TC, batch=momentum_batch)

    eval_ref = workers.eval_case(mesh11, **_kw(s, tc=TC, batch=padded))
    mesh = _jax_mesh((2, 1))
    jeval = jsharded.make_sharded_eval_step(s["jcfg"], s["jstats"], JaxTrainConfig(**TC), mesh,
                                            per_sample=True)(
        s["jparams"], jsharded.shard_batch(padded, mesh),
        jax.random.split(jax.random.PRNGKey(0), 4))
    forward_ref = workers.forward_case(mesh11, **_kw(s, pos=pos, temp=temp, k=K))["out"]
    jforward = jsharded.make_particle_sharded_forward(
        s["jcfg"], s["jstats"], _jax_mesh((1, 2)), num_neighbors=K, neighbor_query_tile=32)(
        s["jparams"], pos, temp)
    rollout_refs = {}
    for r in (1, 2):
        rollout_refs[r] = (
            workers.rollout_case(mesh11, **_kw(s, pos=pos, temp=temp, k=K, steps=ROLLOUT_STEPS,
                                               reneighbor_every=r))["out"],
            jsharded.make_sharded_rollout(
                s["jcfg"], s["jstats"], _jax_mesh((1, 2)), ROLLOUT_STEPS, num_neighbors=K,
                neighbor_query_tile=32, reneighbor_every=r)(s["jparams"], pos, temp))
    single, best, cli_one = _single_device_runs(s, tmp_path, data, trainer_tc, argv)

    ranks = spawned.results()
    _check_train(ranks, train_refs, [(2, 1), (1, 2)])
    _check_train(ranks, momentum_refs, [(1, 2)], label="momentum")
    assert ranks[0]["momentum_1x2_adam"]["metrics"]["momentum"] > 0

    # The per-sample eval step with a padded tail: the real samples' values.
    for rank in (0, 1):
        got = ranks[rank]["eval"]
        for key, want in eval_ref["per_sample"].items():
            assert got["per_sample"][key].shape == (4,)
            np.testing.assert_allclose(got["per_sample"][key][:3], want[:3], rtol=OUT_TOL,
                                       atol=OUT_TOL)
            np.testing.assert_allclose(got["per_sample"][key][:3], np.asarray(jeval[key])[:3],
                                       rtol=OUT_TOL, atol=OUT_TOL)
        for key, want in eval_ref["means"].items():
            assert got["means"][key] == pytest.approx(want, rel=LOSS_RTOL)

    # The particle-sharded forward: each rank's rows, in coordinate order.
    for key in ("acceleration", "temp_rate"):
        got = np.concatenate([ranks[r]["forward"]["out"][key] for r in (0, 1)])
        np.testing.assert_allclose(got, forward_ref[key], rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose(got, np.asarray(jforward[key]), rtol=OUT_TOL, atol=OUT_TOL)
    assert ranks[0]["forward"]["collectives"] == {"all_gather": 1 + 2, "all_reduce": 0,
                                                  "broadcast": 0, "ppermute": 0}

    # Rollouts re-neighboring every step and every other step.
    for r in (1, 2):
        ref, jout = rollout_refs[r]
        for key in ("Coordinates", "InternalEnergy"):
            got = np.concatenate([ranks[q][f"rollout_r{r}"]["out"][key] for q in (0, 1)], axis=1)
            assert got.shape == (5 + ROLLOUT_STEPS, 64, 3 if key == "Coordinates" else 1)
            np.testing.assert_allclose(got, ref[key], rtol=OUT_TOL, atol=OUT_TOL)
            np.testing.assert_allclose(got, np.asarray(jout[key]), rtol=OUT_TOL, atol=OUT_TOL)
        searches = -(-ROLLOUT_STEPS // r)
        assert ranks[0][f"rollout_r{r}"]["collectives"]["all_gather"] == (
            searches + ROLLOUT_STEPS * MODEL["num_message_passing_steps"])

    # Trainer(mesh) for one epoch against the single-device Trainer: the
    # best params (rank 0 reads them back and sends them to every rank) and
    # the history; validation covers the padded tail.
    for rank in (0, 1):
        got = ranks[rank]["trainer"]
        for x, y in zip(got["params"], best):
            np.testing.assert_allclose(x, y, rtol=PARAM_RTOL, atol=PARAM_ATOL)
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got["history"][key], single.history[key],
                                       rtol=LOSS_RTOL)
    assert ranks[0]["trainer"]["collectives"]["broadcast"] == 1
    assert os.path.isdir(tmp_path / "fit_ranks" / "model_final")
    assert os.path.isfile(tmp_path / "fit_ranks" / "training_history.json")

    # cli.train --distributed --data_parallel from the checkpoint fixture,
    # against the same CLI on one process.
    want = [t.detach().numpy() for t in tree_leaves(cli_one.params)]
    for rank in (0, 1):
        got = ranks[rank]["cli"]
        assert got["mesh"] == {"data": 2, "particle": 1}
        for x, y in zip(got["params"], want):
            np.testing.assert_allclose(x, y, rtol=PARAM_RTOL, atol=PARAM_ATOL)
        np.testing.assert_allclose(got["history"]["val_loss"], cli_one.history["val_loss"],
                                   rtol=LOSS_RTOL)
    assert os.path.isdir(tmp_path / "cli_ranks" / "model_final")


def test_sharded_train_steps_on_four_ranks(setup, tmp_path, one_rank):
    shapes = [(4, 1), (2, 2), (1, 4)]
    spawned = workers.Ranks(4, str(tmp_path / "rendezvous"), _train_cases(setup, shapes))
    refs = _train_refs(setup, one_rank, shapes)
    _check_train(spawned.results(), refs, shapes)


def _single_device_runs(s, tmp_path, data, trainer_tc, argv):
    """The single-device Trainer (its returned params) and train CLI that
    the mesh runs are held to."""
    from cosmology_gnn_simulation_tpu_torch.cli import train as train_cli
    from cosmology_gnn_simulation_tpu_torch.data.dataset import SequenceDataset
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        default_model_config,
    )
    from cosmology_gnn_simulation_tpu_torch.training.trainer import TrainConfig, Trainer
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

    tc = TrainConfig(**dict(trainer_tc, output_dir=str(tmp_path / "fit_one")))
    train = SequenceDataset(str(data / "train"), 5, s["meta"])
    val = SequenceDataset(str(data / "val"), 5, s["meta"])
    assert len(val) % tc.batch_size  # a tail batch
    single = Trainer(default_model_config(**MODEL),
                     NormalizationStats.from_metadata(s["meta"], device="cpu"), tc,
                     len(train) // tc.batch_size, params_from_jax(s["params"], device="cpu"),
                     device="cpu")
    best = [t.detach().numpy() for t in tree_leaves(single.fit(train, val, verbose=False))]
    cli_one = train_cli.main([*argv, "--output_dir", str(tmp_path / "cli_one")])
    return single, best, cli_one


def _hdf5_sets(s, tmp_path):
    """Two training simulations and one validation simulation of the
    test's size (3 windows each), their metadata.json, and a checkpoint of
    the JAX weights in the port's format."""
    data = tmp_path / "data"
    for sub, seeds in (("train", (0, 1)), ("val", (2,))):
        os.makedirs(data / sub)
        for seed in seeds:
            write_simulation(str(data / sub / f"sim{seed}.hdf5"),
                             generate_synthetic_simulation(num_snapshots=8, num_particles=64,
                                                           seed=seed))
    import json

    with open(data / "metadata.json", "w") as f:
        json.dump(s["meta"], f)
    ckpt = ckpt_lib.save_checkpoint(str(tmp_path), "jax_weights",
                                    params_from_jax(s["params"], device="cpu"))
    return data, ckpt


def _cli_argv(data, ckpt):
    return ["--train_dir", str(data / "train"), "--val_dir", str(data / "val"),
            "--metadata_path", str(data / "metadata.json"), "--device", "cpu",
            "--num_epochs", "1", "--batch_size", "2", "--latent_size", "16",
            "--mlp_hidden_size", "16", "--mlp_num_hidden_layers", "1",
            "--num_message_passing_steps", "2", "--num_neighbors", "8", "--noise_std", "0",
            "--augment_prob", "0", "--momentum_loss_weight", "0.5", "--learning_rate", "1e-3",
            "--pretrained_model", ckpt]
