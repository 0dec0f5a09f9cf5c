"""The port's ``Trainer`` on its own (no JAX): resume equals a continuous
run bit for bit, ``restore`` cuts the history, the checkpoint's contents,
the loop's failure checks (non-finite loss, zero batches, the cell-block
certificate), the hybrid path's fit against the gather path's, and the
profiling hooks. Tiny models and synthetic files; every run on the CPU.

Tolerances: resume against continuous is bit-equal (the same operations on
the same inputs, with the generator's state carried across). Hybrid against
gather (float32; the hybrid aggregation sums each row's neighbors in
another order): the first step's loss within 2e-4 relative (the JAX
package's own hybrid-vs-gather tolerance, tests/test_trainer_cellblock.py),
every later history entry within 1e-5 relative (measured: the first step's
loss equal, the history at most 1.6e-7).
"""

import json
import os

import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu_torch.data import (
    SequenceDataset,
    generate_synthetic_simulation,
    write_simulation,
)
from cosmology_gnn_simulation_tpu_torch.training import TrainConfig, Trainer, plots
from cosmology_gnn_simulation_tpu_torch.training.trainer import default_model_config
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves
from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib
from cosmology_gnn_simulation_tpu_torch.utils.profiling import (
    StepTimer,
    annotate,
    enable_nan_debugging,
    trace,
)

METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": 1.0, "dt": 0.05,
}
MODEL = dict(latent_size=16, mlp_hidden_size=16, mlp_num_hidden_layers=1,
             num_message_passing_steps=2)
HYBRID_FIRST_RTOL, HYBRID_HISTORY_RTOL = 2e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    host's cores, and this file's many small CPU ops run tens of times
    slower when each worker's thread pool competes for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_plots(monkeypatch):
    """Each loss plot takes seconds (matplotlib); the CLI test draws them."""
    monkeypatch.setattr(plots, "plot_losses", lambda *args, **kwargs: None)


def _dataset(directory, seeds, n=256, snapshots=8, edit=None):
    os.makedirs(directory, exist_ok=True)
    for seed in seeds:
        sim = generate_synthetic_simulation(num_snapshots=snapshots, num_particles=n, seed=seed)
        if edit is not None:
            edit(sim)
        write_simulation(os.path.join(directory, f"sim{seed}.hdf5"), sim)
    return SequenceDataset(str(directory), 5, METADATA)


def _trainer(out, **train_kw):
    kw = dict(num_neighbors=8, batch_size=2, num_epochs=3, learning_rate=1e-3,
              final_learning_rate=1e-4, noise_std=3e-4, save_every=1, output_dir=str(out))
    tc = TrainConfig(**{**kw, **train_kw})
    return Trainer(default_model_config(**MODEL), NormalizationStats.from_metadata(
        METADATA, device="cpu"), tc, 3, device="cpu")


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


@pytest.mark.parametrize("aggregation", ["gather", "cellblock_hybrid"])
def test_resume_equals_continuous_bit_for_bit(tmp_path, aggregation):
    """Noise and augmentation on: the resumed run must draw what the
    continuous run drew (generator state), at the same learning rate (the
    schedule's position) with the same Adam moments and step count."""
    n = 600 if aggregation == "cellblock_hybrid" else 256
    train = _dataset(tmp_path / "train", (0, 1), n=n)
    val = _dataset(tmp_path / "val", (2,), n=n, snapshots=7)
    kw = dict(aggregation=aggregation, augment_prob=1.0)
    first = _trainer(tmp_path / "a", **kw)
    first.fit(train, val, verbose=False)

    resumed = _trainer(tmp_path / "b", **kw)
    start = resumed.restore(str(tmp_path / "a" / "model_epoch_0"))
    assert start == 1
    saved = ckpt_lib.load_state(str(tmp_path / "a" / "model_epoch_0"))
    assert torch.equal(resumed.generator.get_state(), saved["generator"])
    assert resumed.opt_state.schedule.last_epoch == 3  # 3 steps in epoch 0
    assert resumed.opt_state.optimizer.param_groups[0]["lr"] == pytest.approx(
        1e-3 * 0.1 ** (1 / 3), rel=1e-12)
    resumed.fit(train, val, verbose=False, start_epoch=start)

    a = ckpt_lib.load_state(str(tmp_path / "a" / "model_epoch_2"))
    b = ckpt_lib.load_state(str(tmp_path / "b" / "model_epoch_2"))
    assert _leaves_equal(a["params"], b["params"])
    assert a["optimizer"]["state"].keys() == b["optimizer"]["state"].keys()
    for i, state in a["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state[key], b["optimizer"]["state"][i][key]), (i, key)
    assert a["schedule"] == b["schedule"] and a["epoch"] == b["epoch"] == 2
    assert torch.equal(a["generator"], b["generator"])
    assert first.history == resumed.history


def test_restore_cuts_history_and_checkpoint_contents(tmp_path):
    train = _dataset(tmp_path / "train", (0, 1))
    val = _dataset(tmp_path / "val", (2,), snapshots=7)
    trainer = _trainer(tmp_path / "out", augment_prob=0.0)
    trainer.fit(train, val, verbose=False)
    out = tmp_path / "out"
    assert sorted(os.listdir(out)) == [
        "model_best", "model_epoch_0", "model_epoch_1", "model_epoch_2", "model_final",
        "plots", "training_history.json"]
    for name in ("model_epoch_1", "model_final"):
        assert sorted(os.listdir(out / name)) == ["config.json", "history.json", "state.pt"]
    # weights_only reads the whole payload; the config has the two halves.
    state = torch.load(out / "model_epoch_1" / "state.pt", weights_only=True)
    assert sorted(state) == ["epoch", "generator", "optimizer", "params", "schedule"]
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in tree_leaves(state["params"]))
    loaded = ckpt_lib.load_checkpoint(str(out / "model_epoch_1"), device="cpu")
    assert sorted(loaded["config"]) == ["model", "train"]
    assert loaded["config"]["model"]["latent_size"] == 16
    assert loaded["config"]["train"]["num_epochs"] == 3
    # model_final holds the best params.
    best = ckpt_lib.load_state(str(out / "model_best"))
    assert _leaves_equal(ckpt_lib.load_state(str(out / "model_final"))["params"], best["params"])
    assert _leaves_equal(trainer.params, best["params"])

    fresh = _trainer(tmp_path / "other")
    assert fresh.restore(str(out / "model_epoch_0")) == 1
    h = fresh.history
    assert len(h["train_loss"]) == len(h["val_loss"]) == len(h["learning_rates"]) == 1
    assert all(len(v) == 1 for v in h["component_losses"].values())
    assert fresh.restore(str(out / "model_epoch_1")) == 2
    assert len(fresh.history["train_loss"]) == 2
    with open(out / "training_history.json") as f:
        assert len(json.load(f)["train_loss"]) == 3


def _nan_temperatures(sim):
    sim["InternalEnergy"][2, 5] = np.nan


def test_nonfinite_loss_halts(tmp_path):
    train = _dataset(tmp_path / "train", (0,), edit=_nan_temperatures)
    val = _dataset(tmp_path / "val", (2,), snapshots=7)
    with pytest.raises(FloatingPointError, match="Non-finite training loss at epoch 0"):
        _trainer(tmp_path / "out", num_epochs=1).fit(train, val, verbose=False)
    trainer = _trainer(tmp_path / "out2", num_epochs=1, halt_on_nonfinite=False)
    trainer.fit(train, val, verbose=False)
    assert np.isnan(trainer.history["train_loss"][0])


def test_zero_batches_raise(tmp_path):
    train = _dataset(tmp_path / "train", (0,), snapshots=6)  # one window
    val = _dataset(tmp_path / "val", (2,), snapshots=6)
    with pytest.raises(ValueError, match="Epoch 0 produced zero batches"):
        _trainer(tmp_path / "out", batch_size=2).fit(train, val, verbose=False)
    trainer = _trainer(tmp_path / "out2", batch_size=1)
    with pytest.raises(ValueError, match="Validation produced zero batches"):
        trainer.evaluate(_Empty())


def test_dropped_tail_note(tmp_path, capsys):
    train = _dataset(tmp_path / "train", (0,), snapshots=8)  # 3 windows, batch 2
    _trainer(tmp_path / "out", num_epochs=1).fit(train, train)
    out = capsys.readouterr().out
    assert "NOTE: 1 tail training sample(s) per epoch are dropped" in out
    assert "Epoch 0: training loss = " in out and "New best model saved" in out


class _Empty:
    """A dataset with no windows."""

    def __len__(self):
        return 0

    def batches(self, *args, **kwargs):
        return iter(())


def _clustered(sim):
    """90 % of the particles in a sigma 0.01 ball: the cell-block plan's
    columns overflow."""
    rng = np.random.default_rng(0)
    c = sim["Coordinates"]
    m = int(0.9 * c.shape[1])
    ball = 0.5 + 0.01 * rng.standard_normal((1, m, 3))
    c[:, :m] = np.remainder(ball + 0.01 * (c[:, :m] - c[:1, :m]), 1.0)


@pytest.mark.parametrize("strict", [True, False])
def test_cellblock_violations_raise_or_warn(tmp_path, capsys, strict):
    train = _dataset(tmp_path / "train", (0,), n=600, snapshots=6, edit=_clustered)
    trainer = _trainer(tmp_path / "out", aggregation="cellblock_hybrid", num_epochs=1,
                       batch_size=1, strict_neighbor_check=strict)
    if strict:
        with pytest.raises(ValueError, match="Cell-block aggregation certificate failed"):
            trainer.fit(train, train, verbose=False)
    else:
        trainer.fit(train, train, verbose=False)
        assert "WARNING: Cell-block aggregation certificate failed during epoch 0" in \
            capsys.readouterr().out
        assert len(trainer.history["train_loss"]) == 1


def test_hybrid_fit_matches_gather(tmp_path):
    train = _dataset(tmp_path / "train", (0, 1), n=600)
    val = _dataset(tmp_path / "val", (2,), n=600, snapshots=7)
    runs = {}
    for aggregation in ("gather", "cellblock_hybrid"):
        trainer = _trainer(tmp_path / aggregation, aggregation=aggregation, num_epochs=2,
                           augment_prob=0.0, noise_std=0.0)
        steps = []
        step = trainer.train_step

        def recording(*args, step=step, steps=steps):
            out = step(*args)
            steps.append(out[2])
            return out

        trainer.train_step = recording
        trainer.fit(train, val, verbose=False)
        runs[aggregation] = (steps, trainer.history)
    (g_steps, g), (h_steps, h) = runs["gather"], runs["cellblock_hybrid"]
    assert all(float(m["cellblock_violations"]) == 0 for m in h_steps)
    first, ref = float(h_steps[0]["loss"]), float(g_steps[0]["loss"])
    assert abs(first - ref) <= HYBRID_FIRST_RTOL * abs(ref)
    assert h["learning_rates"] == g["learning_rates"]
    pairs = [(h[s], g[s]) for s in ("train_loss", "val_loss")]
    pairs += [(h["component_losses"][k], g["component_losses"][k]) for k in g["component_losses"]]
    for a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=HYBRID_HISTORY_RTOL)


def test_profiling_step_timer_trace_and_profile_epoch(tmp_path):
    timer = StepTimer()
    for seconds in (0.3, 0.1, 0.2):
        timer.record("step", seconds)
    with timer.phase("phase", block_on={"x": torch.ones(2)}):
        pass
    summary = timer.summary()
    assert summary["step"]["count"] == 3
    assert summary["step"]["p50_s"] == 0.2 and summary["step"]["total_s"] == pytest.approx(0.6)
    assert summary["step"]["mean_s"] == pytest.approx(0.2)
    assert summary["phase"]["count"] == 1

    train = _dataset(tmp_path / "train", (0,))
    trainer = _trainer(tmp_path / "out", num_epochs=2, profile_epoch=1)
    trainer.fit(train, train, verbose=False)
    with open(tmp_path / "out" / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert trainer.step_timer.summary()["train_epoch"]["count"] == 2

    # A named region in a trace of one's own; NaN debugging toggles anomaly mode.
    with trace(str(tmp_path / "own")):
        with annotate("my_region"):
            torch.ones(3).add_(1)
    with open(tmp_path / "own" / "trace.json") as f:
        assert any(e.get("name") == "my_region" for e in json.load(f)["traceEvents"])
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_unported_and_device_arguments_raise():
    # The mesh and halo trainers are ported (tests/test_torch_sharded.py,
    # tests/test_torch_halo_trainer.py); halo sharding needs a mesh, as JAX's.
    with pytest.raises(ValueError, match="halo sharding requires a mesh"):
        Trainer(default_model_config(**MODEL), NormalizationStats.from_metadata(
            METADATA, device="cpu"), TrainConfig(), 1, halo=object(), device="cpu")
    if not torch.cuda.is_available():  # the default device is the card; no fallback
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            Trainer(default_model_config(**MODEL),
                    NormalizationStats.from_metadata(METADATA, device="cpu"), TrainConfig(), 1)
