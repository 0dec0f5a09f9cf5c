"""The traffic generator: a seed gives the same windows every time, and
every seed gives windows of the same sizes, so a seed changes the values
and never the work."""

import numpy as np

from portbench.traffic import frames

MIX = {"frames": 5, "drift_sigma": 5e-4, "temp_mean": 1.0, "temp_sigma": 0.3,
       "temp_drift": 1e-3}


def test_same_seed_same_windows():
    seed = 2**33 + 17
    for make in (frames.rollout_window, frames.train_window):
        a, b = make(1000, MIX, seed), make(1000, MIX, seed)
        pairs = zip(a, b) if isinstance(a, tuple) else ((a[key], b[key]) for key in a)
        for x, y in pairs:
            assert np.array_equal(x, y)
    assert frames.pool_seeds(seed, 4) == frames.pool_seeds(seed, 4)


def test_every_seed_the_same_sizes():
    shapes = set()
    for seed in frames.pool_seeds(2**40 + 3, 3):
        pos, temp = frames.rollout_window(1000, MIX, seed)
        batch = frames.train_window(1000, MIX, seed)
        shapes.add((pos.shape, temp.shape) + tuple(v.shape for v in batch.values()))
        assert pos.dtype == np.float32 and 0 <= pos.min() and pos.max() <= 1
    assert shapes == {((5, 1000, 3), (5, 1000, 1), (1, 5, 1000, 3), (1, 5, 1000, 1),
                       (1, 1000, 3), (1, 1000, 1))}


def test_the_seed_frames_rule():
    # The base is N uniform points, then a random walk, then the
    # temperatures, drawn in that order from the seed.
    seed, n = 2**35 + 9, 500
    pos, temp = frames.rollout_window(n, MIX, seed)
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (1, n, 3))
    drift = rng.normal(0, 5e-4, (5, n, 3)).cumsum(axis=0)
    assert np.array_equal(pos, np.remainder(base + drift, 1.0).astype(np.float32))
    assert np.array_equal(temp, np.abs(rng.normal(1.0, 0.3, (5, n, 1))).astype(np.float32))
    batch = frames.train_window(n, MIX, seed)
    assert np.array_equal(batch["positions"][0, 0], pos[0])
