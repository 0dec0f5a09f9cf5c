"""The plain reference against the port's CPU plain path at a tiny size, for
both entry points, in float32: the two compute the same thing."""

import torch

from portbench.tests.conftest import tiny_cell


def test_rollout_reference_matches_the_port():
    name = "config4.rollout"
    import importlib
    _, _, cfg, mix, _ = tiny_cell(name, f32=True)
    entry = importlib.import_module("portbench.entries.rollout").Entry(
        cfg, mix, 2**33 + 1, torch.device("cpu"))
    entry.warm_up()
    for i in range(mix["check_requests"]):
        entry.request(i)
    assert all(entry.settle())
    entry.release()
    got = entry.compare()["raw"]["program"]
    # float32 on both sides: sums in another order, k-NN sets equal. A step
    # moves a particle by about 1e-3 of the box.
    assert got["position_rms"] < 1e-7 and got["position_max"] < 2e-6, got
    assert got["temperature_rms"] < 1e-6 and got["temperature_max"] < 2e-5, got


def test_train_reference_matches_the_port():
    name = "config4.train"
    import importlib
    _, _, cfg, mix, _ = tiny_cell(name, f32=True)
    entry = importlib.import_module("portbench.entries.train_step").Entry(
        cfg, mix, 2**33 + 2, torch.device("cpu"))
    entry.warm_up()
    entry.release()
    got = entry.compare()["raw"]["program"]
    assert got["loss"] < 1e-6 and got["first_gradient"] < 1e-5, got
    # Adam moves a leaf by about lr a step whatever its gradient's size: a
    # component near 0 may take either sign.
    assert got["update"] < 2e-2, got
