"""The port's ``Trainer`` and ``validate`` held against the JAX package's on
the same HDF5 files, configuration and initial weights (JAX's, carried
across with ``convert.params_from_jax``): float32, the gather path, noise 0
and no augmentation, so neither side draws a random number that matters. A
tiny model (latent 16, two message-passing steps), 256 particles, 2 epochs
of 3 steps; the validation set has a tail batch.

Tolerances (float32 sums in another order, then Adam on gradients that
differ in the last bits): the learning rates are the same Python floats
(1e-12); the first step's metrics within 1e-6 relative (measured at most
1.1e-7); every history entry within 1e-4 relative (measured at most 1.8e-5,
on the small momentum term); ``validate`` and the evaluation of JAX-trained
weights within 1e-6 relative (measured at most 2.9e-7).
"""

import json
import os

import jax
import numpy as np
import pytest

from cosmology_gnn_simulation_tpu.data.dataset import SequenceDataset as JaxSequenceDataset
from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.training import plots as jax_plots
from cosmology_gnn_simulation_tpu.training import trainer as jax_trainer
from cosmology_gnn_simulation_tpu.training.validation import validate as jax_validate
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu.utils import checkpoint as jax_ckpt
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.data import (
    SequenceDataset,
    generate_synthetic_simulation,
    read_simulation,
    write_simulation,
)
from cosmology_gnn_simulation_tpu_torch.metadata import compute_metadata
from cosmology_gnn_simulation_tpu_torch.training import TrainConfig, Trainer, plots, validate
from cosmology_gnn_simulation_tpu_torch.training.trainer import default_model_config
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

FIRST_STEP_RTOL, HISTORY_RTOL, EVAL_RTOL = 1e-6, 1e-4, 1e-6
MODEL = dict(latent_size=16, mlp_hidden_size=16, mlp_num_hidden_layers=1,
             num_message_passing_steps=2)
TRAIN = dict(num_neighbors=8, batch_size=2, num_epochs=2, learning_rate=1e-3,
             final_learning_rate=1e-4, noise_std=0.0, augment_prob=0.0,
             momentum_loss_weight=0.1, aggregation="gather", save_every=1)


def _recording(step, record):
    def wrapped(*args):
        out = step(*args)
        record.append({k: float(v) for k, v in out[2].items()})
        return out
    return wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX and the port's Trainer, each fitted 2 epochs from the same
    files and initial weights, with each one's first-step metrics. Neither
    draws its loss plots (seconds each; the CLI test draws the port's)."""
    patch = pytest.MonkeyPatch()
    for module in (jax_plots, plots):
        patch.setattr(module, "plot_losses", lambda *args, **kwargs: None)
    try:
        return _fit_both(tmp_path_factory.mktemp("trainer_jax"))
    finally:
        patch.undo()


def _fit_both(base):
    for sub, seeds in (("train", (0, 1)), ("val", (2,))):
        os.makedirs(base / sub)
        for seed in seeds:
            write_simulation(str(base / sub / f"sim{seed}.hdf5"), generate_synthetic_simulation(
                num_snapshots=8, num_particles=256, seed=seed))
    meta = compute_metadata(read_simulation(str(base / "train" / "sim0.hdf5")))
    fields = ("Coordinates", "InternalEnergy")

    jcfg = jax_trainer.default_model_config(**MODEL)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    jtc = jax_trainer.TrainConfig(**TRAIN, output_dir=str(base / "jax"))
    jax_train = JaxSequenceDataset(str(base / "train"), 5, meta, fields=fields)
    jax_val = JaxSequenceDataset(str(base / "val"), 5, meta, fields=fields)
    jt = jax_trainer.Trainer(jcfg, JaxStats.from_metadata(meta), jtc,
                             len(jax_train) // 2, init_params=jparams)
    jax_steps = []
    jt.train_step = _recording(jt.train_step, jax_steps)
    jt.fit(jax_train, jax_val, verbose=False)

    cfg = default_model_config(**MODEL)
    tc = TrainConfig(**TRAIN, output_dir=str(base / "port"))
    train = SequenceDataset(str(base / "train"), 5, meta, fields=fields)
    val = SequenceDataset(str(base / "val"), 5, meta, fields=fields)
    stats = NormalizationStats.from_metadata(meta, device="cpu")
    pt = Trainer(cfg, stats, tc, len(train) // 2,
                 init_params=params_from_jax(np_params, device="cpu"), device="cpu")
    port_steps = []
    pt.train_step = _recording(pt.train_step, port_steps)
    pt.fit(train, val, verbose=False)
    return dict(base=base, meta=meta, jt=jt, pt=pt, jax_steps=jax_steps,
                port_steps=port_steps, jax_val=jax_val, val=val, cfg=cfg, jcfg=jcfg,
                stats=stats)


def _rel(a, b):
    return abs(a - b) / abs(b) if b else abs(a - b)


def test_fit_history_matches_jax(runs):
    jt, pt = runs["jt"], runs["pt"]
    assert len(runs["port_steps"]) == len(runs["jax_steps"]) == 6
    first, jfirst = runs["port_steps"][0], runs["jax_steps"][0]
    assert sorted(first) == sorted(jfirst)
    for key in first:
        assert _rel(first[key], jfirst[key]) <= FIRST_STEP_RTOL, (key, first[key], jfirst[key])

    h, jh = pt.history, jt.history
    assert sorted(h) == sorted(jh)
    assert sorted(h["component_losses"]) == sorted(jh["component_losses"])
    np.testing.assert_allclose(h["learning_rates"], jh["learning_rates"], rtol=0, atol=1e-12)
    for series in ("train_loss", "val_loss"):
        assert len(h[series]) == 2
        for a, b in zip(h[series], jh[series]):
            assert _rel(a, b) <= HISTORY_RTOL, (series, h[series], jh[series])
    for name, values in h["component_losses"].items():
        for a, b in zip(values, jh["component_losses"][name]):
            assert _rel(a, b) <= HISTORY_RTOL, (name, values, jh["component_losses"][name])
    assert h["best_epoch"] == jh["best_epoch"]
    assert _rel(h["best_val_loss"], jh["best_val_loss"]) <= HISTORY_RTOL

    # The same artifacts, and training_history.json with JAX's keys.
    out, jout = runs["base"] / "port", runs["base"] / "jax"
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    with open(out / "training_history.json") as f, open(jout / "training_history.json") as g:
        port_json, jax_json = json.load(f), json.load(g)
    assert sorted(port_json) == sorted(jax_json)
    assert sorted(port_json["component_losses"]) == sorted(jax_json["component_losses"])
    # config.json in JAX's schema: the same model and train fields, in order.
    with open(out / "model_final" / "config.json") as f, \
            open(jout / "model_final" / "config.json") as g:
        config, jconfig = json.load(f), json.load(g)
    assert list(config) == list(jconfig) == ["model", "train"]
    assert config["model"] == jconfig["model"]
    assert list(config["train"]) == list(jconfig["train"])
    assert config["train"] == jconfig["train"] | {"output_dir": str(out)}


def test_validate_matches_jax(runs):
    params = jax.tree.map(np.asarray, runs["jt"].params)
    loss, comps = validate(params_from_jax(params, device="cpu"), runs["val"], runs["cfg"],
                           runs["stats"], batch_size=1, num_neighbors=8,
                           momentum_loss_weight=0.1, device="cpu")
    jloss, jcomps = jax_validate(runs["jt"].params, runs["jax_val"], runs["jcfg"],
                                 JaxStats.from_metadata(runs["meta"]), batch_size=1,
                                 num_neighbors=8, momentum_loss_weight=0.1)
    assert _rel(loss, jloss) <= EVAL_RTOL, (loss, jloss)
    assert sorted(comps) == sorted(jcomps)
    for key in comps:
        assert _rel(comps[key], jcomps[key]) <= EVAL_RTOL, (key, comps[key], jcomps[key])


def test_jax_trained_weights_evaluate_the_same(runs):
    """JAX ``Trainer.save`` -> JAX ``load_checkpoint`` -> numpy ->
    ``params_from_jax`` -> the port's ``Trainer.evaluate``."""
    restored = jax_ckpt.load_checkpoint(str(runs["base"] / "jax" / "model_final"))
    params = params_from_jax(jax.tree.map(np.asarray, restored["params"]), device="cpu")
    tc = TrainConfig(**TRAIN, output_dir=str(runs["base"] / "unused"))
    trainer = Trainer(runs["cfg"], runs["stats"], tc, 3, init_params=params, device="cpu")
    port = trainer.evaluate(runs["val"])
    ref = runs["jt"].evaluate(runs["jax_val"])
    assert sorted(port) == sorted(ref)
    for key in port:
        assert _rel(port[key], ref[key]) <= EVAL_RTOL, (key, port[key], ref[key])


def _frame(kind, n=8192):
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 1, (n, 3))
    if kind == "clustered":  # 95 % in a sigma 0.01 ball: cells overflow
        m = int(0.95 * n)
        pos[:m] = 0.5 + 0.01 * rng.standard_normal((m, 3))
    return np.remainder(pos, 1.0).astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
def test_verify_neighbor_exactness_matches_jax(kind):
    """The one-frame certificate the Trainer runs on its first batch: the
    same diagnostics as JAX's (the overflow count equal, the distances
    equal, or within float32 rounding of sums taken in another order: 1e-6
    relative; inf on both sides where a row runs out of candidates), the
    same verdict, the strict raise and the warning."""
    import torch

    from cosmology_gnn_simulation_tpu.featurize import (
        verify_neighbor_exactness as jax_verify,
    )
    from cosmology_gnn_simulation_tpu_torch.featurize import verify_neighbor_exactness

    pos = _frame(kind)
    ref = jax_verify(pos, 16, 1.0, strict=False) if kind == "uniform" else None
    if kind == "clustered":
        with pytest.warns(UserWarning, match="certificate FAILED"):
            ref = jax_verify(pos, 16, 1.0, strict=False)
        with pytest.raises(ValueError, match="certificate FAILED"):
            verify_neighbor_exactness(torch.from_numpy(pos), 16, 1.0)
        with pytest.warns(UserWarning, match="certificate FAILED"):
            result = verify_neighbor_exactness(torch.from_numpy(pos), 16, 1.0, strict=False)
    else:
        result = verify_neighbor_exactness(torch.from_numpy(pos), 16, 1.0)
    assert result["exact"] == ref["exact"] == (kind == "uniform")
    assert result["method"] == ref["method"] == "celllist"
    assert tuple(result["grid"]) == tuple(ref["grid"])
    assert result["overflow"] == ref["overflow"]
    assert result["cell_edge_sq"] == ref["cell_edge_sq"]
    for key in ("max_kth_distance_sq", "max_excess_sq"):
        assert result[key] == ref[key] or abs(result[key] - ref[key]) <= 1e-6 * abs(ref[key]), \
            (key, result[key], ref[key])
    small = verify_neighbor_exactness(torch.from_numpy(pos[:100]), 16, 1.0)
    assert small == jax_verify(pos[:100], 16, 1.0) == {"method": "bruteforce", "exact": True}
