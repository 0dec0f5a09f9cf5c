"""Per-particle noise keying (``partition_invariant_noise``): the port's
gid-keyed draws (``ops/noise.py``: one integer key from the call's
generator, a counter-based hash of (key, gid, element), Box-Muller) and the
train step that keys each sample's noise by its particles' global ids, held
against the JAX package where the two can agree.

A ``torch.Generator`` does not give ``jax.random``'s numbers, so the walks
and the train step are compared with both packages handed the same draws
per global id (each package's draw function replaced, as in
``test_torch_training.py``), augmentation off. The layout invariance that
the keying exists for is checked on the port alone: exact for the draws and
the walks (row-local integer and float ops), within the train step's
float32 tolerances for the loss and gradients (``test_torch_training.py``:
1e-6 relative loss, 3e-5 of each leaf's largest gradient; the permuted
sample sums its edges and particles in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosmology_gnn_simulation_tpu.ops.noise as jax_noise
from cosmology_gnn_simulation_tpu_torch.ops import noise
from cosmology_gnn_simulation_tpu_torch.parallel.sharded import make_data_parallel_train_step
from cosmology_gnn_simulation_tpu_torch.training import TrainConfig, make_train_step
from cosmology_gnn_simulation_tpu_torch.training.trainer import Optimizer
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats
from test_torch_training import (
    GRAD_TOL,
    METADATA,
    _batch,
    _models,
    _rel_err,
    assert_step_matches,
    jax_step_grads,
    port_step_grads,
)

SHAPE = (257, 4, 3)


def _fmix32(h: int) -> int:
    """murmur3's 32-bit finalizer on Python ints (the hash's definition)."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_gid_bits_are_the_documented_hash():
    key, gids = torch.tensor([2**32 - 3]), torch.tensor([0, 7, 2**31 + 5, 123456789])
    bits = noise.gid_bits(key, gids, 3)
    for i, gid in enumerate(gids.tolist()):
        stream = _fmix32(_fmix32(int(key)) ^ gid)
        for e in range(3):
            for c in range(2):
                assert int(bits[i, e, c]) == _fmix32(stream ^ _fmix32(2 * e + c))


def test_gid_draws_are_invariant_under_permutation_and_padding():
    gen_seed, rng = 5, np.random.default_rng(0)
    gids = torch.from_numpy(rng.permutation(10_000)[:SHAPE[0]])
    perm = torch.from_numpy(rng.permutation(SHAPE[0]))
    key = torch.tensor([987654321])
    base = noise.gid_normals(key, gids, SHAPE)
    assert torch.equal(noise.gid_normals(key, gids[perm], SHAPE), base[perm])
    # Padding rows (other ids, more rows) leave the real rows' draws alone.
    padded = torch.cat([torch.tensor([20_001, 20_002]), gids, torch.tensor([20_003])])
    assert torch.equal(noise.gid_normals(key, padded, (SHAPE[0] + 3,) + SHAPE[1:])[2:-1], base)
    assert not torch.equal(noise.gid_normals(key + 1, gids, SHAPE), base)
    # The walks: the same generator state, particles and ids permuted together.
    pos = torch.rand(SHAPE[0], 5, 3, generator=torch.Generator().manual_seed(1))
    temp = torch.rand(SHAPE[0], 5, 1, generator=torch.Generator().manual_seed(2))
    for walk, seq, extra in ((noise.random_walk_position_noise, pos, ()),
                             (noise.random_walk_temperature_noise, temp, (0.02,))):
        ref = walk(seq, 3e-4, *extra, 0.05, torch.Generator().manual_seed(gen_seed), gids=gids)
        got = walk(seq[perm], 3e-4, *extra, 0.05, torch.Generator().manual_seed(gen_seed),
                   gids=gids[perm])
        assert torch.equal(got, ref[perm]) and not ref[:, 0].any() and ref[:, 1:].all()
        pad_seq = torch.cat([seq[:2], seq, seq[:1]])
        got = walk(pad_seq, 3e-4, *extra, 0.05, torch.Generator().manual_seed(gen_seed),
                   gids=padded)
        assert torch.equal(got[2:-1], ref)


def test_gid_draws_are_standard_normal():
    z = noise.gid_normals(torch.tensor([42]), torch.arange(2**16), (2**16, 4)).double()
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    assert abs(float((z.abs() < 1).double().mean()) - 0.682689) < 0.005
    assert bool(torch.isfinite(z).all())


def _inject_gid_draws(monkeypatch, seed, num_ids):
    """Both packages' gid-keyed draws become one fixed table per shape,
    indexed by global id."""
    rng = np.random.default_rng(seed)
    tables = {}

    def table(shape):
        rest = tuple(int(s) for s in shape[1:])
        if rest not in tables:
            tables[rest] = rng.normal(0, 1, (num_ids,) + rest).astype(np.float32)
        return tables[rest]

    monkeypatch.setattr(jax_noise, "_iid_normal",
                        lambda key, shape, dtype, gids: jnp.asarray(table(shape), dtype)[gids])
    monkeypatch.setattr(noise, "_gid_normal",
                        lambda generator, shape, device, gids:
                        torch.from_numpy(table(shape))[gids.cpu()].to(device))


def test_gid_walks_match_jax_with_injected_draws(monkeypatch):
    _inject_gid_draws(monkeypatch, 1, 1000)
    rng = np.random.default_rng(2)
    pos = rng.uniform(0, 1, (300, 5, 3)).astype(np.float32)
    temp = rng.uniform(0.5, 1.5, (300, 5, 1)).astype(np.float32)
    gids = rng.permutation(1000)[:300]
    rate_std = np.array([0.02], np.float32)
    key = jax.random.PRNGKey(0)
    jpos = jax_noise.random_walk_position_noise(key, jnp.asarray(pos), 3e-4, 0.05,
                                                gids=jnp.asarray(gids))
    jtemp = jax_noise.random_walk_temperature_noise(key, jnp.asarray(temp), 3e-4,
                                                    jnp.asarray(rate_std), 0.05,
                                                    gids=jnp.asarray(gids))
    tgids = torch.from_numpy(gids)
    tpos = noise.random_walk_position_noise(torch.from_numpy(pos), 3e-4, 0.05, gids=tgids)
    ttemp = noise.random_walk_temperature_noise(torch.from_numpy(temp), 3e-4,
                                                torch.from_numpy(rate_std), 0.05, gids=tgids)
    assert _rel_err(tpos, jpos) <= 1e-6 and _rel_err(ttemp, jtemp) <= 1e-6


@pytest.mark.parametrize("noise_std", [0.0, 3e-4])
def test_gid_keyed_train_step_matches_jax(noise_std, monkeypatch):
    n = 1024
    _inject_gid_draws(monkeypatch, 3, n)
    jcfg, tcfg, jparams = _models()
    batch = _batch(n, 6)
    tc = dict(aggregation="gather", partition_invariant_noise=True, noise_std=noise_std,
              augment_prob=0.0, momentum_loss_weight=0.1)
    jmetrics, jgrads = jax_step_grads(jcfg, jparams, batch, **tc)
    metrics, grads = port_step_grads(tcfg, jparams, batch, **tc)
    assert_step_matches(metrics, grads, jmetrics, jgrads, None)


@pytest.mark.parametrize("aggregation", ["gather", "cellblock_hybrid"])
def test_gid_keyed_train_step_is_layout_invariant(aggregation):
    """The same sample with its particles (and their ids) permuted: the same
    noise per particle, so the same loss and gradients (augmentation on, as
    in training)."""
    _, tcfg, jparams = _models()
    n = 1024
    batch = _batch(n, 8)
    perm = np.random.default_rng(4).permutation(n)
    permuted = {"positions": batch["positions"][:, :, perm],
                "temperatures": batch["temperatures"][:, :, perm],
                "target_positions": batch["target_positions"][:, perm],
                "target_temperatures": batch["target_temperatures"][:, perm],
                "gids": perm[None]}
    tc = dict(aggregation=aggregation, partition_invariant_noise=True, noise_std=3e-4,
              momentum_loss_weight=0.1)
    metrics, grads = port_step_grads(tcfg, jparams, batch, **tc)
    pmetrics, pgrads = port_step_grads(tcfg, jparams, permuted, **tc)
    assert float(pmetrics["loss"]) == pytest.approx(float(metrics["loss"]), rel=1e-6)
    assert max(_rel_err(a, b) for a, b in zip(pgrads, grads)) <= GRAD_TOL[None]
    # Without the keying the stream noise follows the rows: another loss.
    smetrics, _ = port_step_grads(tcfg, jparams, permuted,
                                  **{**tc, "partition_invariant_noise": False})
    assert float(smetrics["loss"]) != pytest.approx(float(metrics["loss"]), rel=1e-6)


def test_index_sharded_step_refuses_gid_keying():
    _, tcfg, _ = _models()
    stats = NormalizationStats.from_metadata(METADATA, device="cpu")
    opt = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
    assert callable(make_train_step(tcfg, stats, TrainConfig(partition_invariant_noise=True),
                                    opt))
    with pytest.raises(ValueError, match="keys its noise per sample"):
        make_data_parallel_train_step(tcfg, stats, TrainConfig(partition_invariant_noise=True),
                                      opt, mesh=None)
