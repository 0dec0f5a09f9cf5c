"""The port's training pieces held against the JAX package on identical numpy
inputs: the loss stack, the random-walk noise, the featurized training
targets, the axis augmentation, the optimizer, and one gather-path train
step (loss and every gradient).

Randomness: a ``torch.Generator`` does not give ``jax.random``'s numbers,
so the tests hand both packages the same iid draws by replacing each
package's ``ops.noise._iid_normal``, and run the train step with noise 0
and ``augment_prob = 0``. JAX's gradients come from its step with
``optax.sgd(1.0)`` (new params = params - grad), the port's from its step
with ``torch.optim.SGD(lr=1)``.

Tolerances: the loss and noise terms are float32 sums in another order
(1e-6 relative). The targets divide position differences by dt^2: 1e-4
relative to their largest magnitude, a few float32 ulps of a coordinate
amplified by 1/dt^2. Adam on identical gradients: 1e-6 absolute (both
float32; the learning rate is computed in float64 here, float32 in optax).
The train step's gradients, relative to each leaf's largest magnitude:
float32, 3e-5 (f32 products and sums in another order through 2
message-passing steps; measured at most 7.5e-6); bf16 operands with the
fused tail, 2e-2 (a last-bit difference can flip the bf16 rounding of an
operand, 2^-8 relative, or a ReLU mask at 0; measured at most 8.9e-3). The
loss: 1e-6 relative in float32 (measured 1.8e-7), 1e-3 in bf16 (measured
3.0e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cosmology_gnn_simulation_tpu.ops.noise as jax_noise
from cosmology_gnn_simulation_tpu.featurize import featurize as jax_featurize
from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    EncodeProcessDecodeConfig as JaxConfig,
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.training import trainer as jax_trainer
from cosmology_gnn_simulation_tpu.training.losses import combined_loss as jax_combined_loss
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax, params_to_numpy
from cosmology_gnn_simulation_tpu_torch.featurize import featurize
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
)
from cosmology_gnn_simulation_tpu_torch.ops import noise
from cosmology_gnn_simulation_tpu_torch.training import (
    TrainConfig,
    combined_loss,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from cosmology_gnn_simulation_tpu_torch.training import trainer
from cosmology_gnn_simulation_tpu_torch.training.trainer import AXIS_PERMS, Optimizer
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves

METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": [1.0, 1.0, 1.0], "dt": 0.05,
}
GRAD_TOL = {None: 3e-5, "bfloat16": 2e-2}


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return np.abs(a - b).max() / scale if scale else np.abs(a - b).max()


def _inject_draws(monkeypatch, seed):
    """Both packages' iid draws become one fixed array per shape."""
    rng = np.random.default_rng(seed)
    draws = {}

    def draw(shape):
        shape = tuple(int(s) for s in shape)
        if shape not in draws:
            draws[shape] = rng.normal(0, 1, shape).astype(np.float32)
        return draws[shape]

    monkeypatch.setattr(jax_noise, "_iid_normal",
                        lambda key, shape, dtype, gids: jnp.asarray(draw(shape), dtype))
    monkeypatch.setattr(noise, "_iid_normal",
                        lambda generator, shape, device: torch.from_numpy(draw(shape)).to(device))


def _window(n, seed, frames=6):
    rng = np.random.default_rng(seed)
    pos = np.remainder(rng.uniform(0, 1, (1, n, 3))
                       + rng.normal(0, 5e-4, (frames, n, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = (1.0 + rng.normal(0, 1e-3, (frames, n, 1)).cumsum(0)).astype(np.float32)
    return pos, temp


@pytest.mark.parametrize("momentum_weight", [0.0, 0.3])
def test_combined_loss_matches_jax(momentum_weight):
    rng = np.random.default_rng(0)
    preds = {"acceleration": rng.normal(0, 1, (2, 50, 3)).astype(np.float32),
             "temp_rate": rng.normal(0, 1, (2, 50, 1)).astype(np.float32)}
    acc = rng.normal(0, 1, (2, 50, 3)).astype(np.float32)
    rate = rng.normal(0, 1, (2, 50, 1)).astype(np.float32)
    kw = dict(acc_weight=0.7, temp_rate_weight=1.3, momentum_weight=momentum_weight)
    jt, jc = jax_combined_loss({k: jnp.asarray(v) for k, v in preds.items()},
                               jnp.asarray(acc), jnp.asarray(rate), 0.05, **kw)
    t, c = combined_loss({k: torch.from_numpy(v) for k, v in preds.items()},
                         torch.from_numpy(acc), torch.from_numpy(rate), 0.05, **kw)
    np.testing.assert_allclose(float(t), float(jt), rtol=1e-6)
    assert set(c) == set(jc)
    for key in c:
        np.testing.assert_allclose(float(c[key]), float(jc[key]), rtol=1e-6, atol=1e-12)


def test_noise_walk_matches_jax_with_injected_draws(monkeypatch):
    _inject_draws(monkeypatch, 1)
    rng = np.random.default_rng(2)
    pos = rng.uniform(0, 1, (300, 5, 3)).astype(np.float32)
    temp = rng.uniform(0.5, 1.5, (300, 5, 1)).astype(np.float32)
    rate_std = np.array([0.02], np.float32)
    key = jax.random.PRNGKey(0)
    jpos = jax_noise.random_walk_position_noise(key, jnp.asarray(pos), 3e-4, 0.05)
    jtemp = jax_noise.random_walk_temperature_noise(key, jnp.asarray(temp), 3e-4,
                                                    jnp.asarray(rate_std), 0.05)
    tpos = noise.random_walk_position_noise(torch.from_numpy(pos), 3e-4, 0.05)
    ttemp = noise.random_walk_temperature_noise(torch.from_numpy(temp), 3e-4,
                                                torch.from_numpy(rate_std), 0.05)
    assert tpos.shape == pos.shape and ttemp.shape == temp.shape
    assert not tpos[:, 0].any() and not ttemp[:, 0].any()  # zero first frame
    assert _rel_err(tpos, jpos) <= 1e-6 and _rel_err(ttemp, jtemp) <= 1e-6
    # noise_std == 0 gives exact zeros.
    assert not noise.random_walk_position_noise(torch.from_numpy(pos), 0.0, 0.05).any()


@pytest.mark.parametrize("noise_std", [0.0, 3e-4])
def test_featurize_targets_match_jax(noise_std, monkeypatch):
    _inject_draws(monkeypatch, 3)
    pos, temp = _window(600, 4)
    jstats = JaxStats.from_metadata(METADATA)
    stats = NormalizationStats.from_metadata(METADATA, device="cpu")
    jg = jax_featurize(jnp.asarray(pos[:5]), jnp.asarray(temp[:5]), jstats,
                       jax.random.PRNGKey(0), noise_std=noise_std, num_neighbors=8,
                       target_position=jnp.asarray(pos[5]),
                       target_temperature=jnp.asarray(temp[5]), build_reverse=True)
    g = featurize(torch.from_numpy(pos[:5]), torch.from_numpy(temp[:5]), stats,
                  noise_std=noise_std, num_neighbors=8,
                  target_position=torch.from_numpy(pos[5]),
                  target_temperature=torch.from_numpy(temp[5]), build_reverse=True)
    assert _rel_err(g.positions, jg.positions) <= 1e-6
    assert _rel_err(g.nodes, jg.nodes) <= 1e-5
    assert _rel_err(g.target_acceleration, jg.target_acceleration) <= 1e-4
    assert _rel_err(g.target_temp_rate, jg.target_temp_rate) <= 1e-4
    np.testing.assert_array_equal(g.neighbors.numpy(), np.asarray(jg.neighbors))
    assert _rel_err(g.edges, jg.edges) <= 1e-5
    # The sender-sorted edge stream.
    for field in ("order", "receivers", "boundaries"):
        np.testing.assert_array_equal(getattr(g.sorted_edges, field).numpy(),
                                      np.asarray(getattr(jg.sorted_edges, field)))


@pytest.mark.parametrize("index", range(6))
def test_augment_axes_with_a_fixed_permutation(index, monkeypatch):
    np.testing.assert_array_equal(np.array(AXIS_PERMS), jax_trainer._AXIS_PERMS)
    rng = np.random.default_rng(index)
    pos = rng.uniform(0, 1, (5, 40, 3)).astype(np.float32)
    tpos = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    perm = jax_trainer._AXIS_PERMS[index]
    for u, applied in ((0.25, True), (0.75, False)):
        monkeypatch.setattr(trainer, "_axis_draw",
                            lambda generator, device: (torch.tensor([index]), torch.tensor([u])))
        out, tout = trainer._augment_axes(None, torch.from_numpy(pos), torch.from_numpy(tpos), 0.5)
        want = np.asarray(jnp.asarray(pos)[..., perm]) if applied else pos
        twant = np.asarray(jnp.asarray(tpos)[..., perm]) if applied else tpos
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_array_equal(tout.numpy(), twant)
    # The JAX draw picks one of the same six, applied to inputs and targets.
    outs = [pos[..., list(p)] for p in AXIS_PERMS]
    jout, jtout = jax_trainer._augment_axes(jax.random.PRNGKey(index), jnp.asarray(pos),
                                            jnp.asarray(tpos), 1.0)
    hit = [i for i, o in enumerate(outs) if np.array_equal(np.asarray(jout), o)]
    assert hit and np.array_equal(np.asarray(jtout), tpos[..., list(AXIS_PERMS[hit[0]])])
    # The port's own draw: a permutation from the generator, on the device.
    out, _ = trainer._augment_axes(torch.Generator().manual_seed(index),
                                   torch.from_numpy(pos), torch.from_numpy(tpos), 1.0)
    assert any(np.array_equal(out.numpy(), o) for o in outs)


def test_optimizer_matches_optax_across_an_epoch_boundary():
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(0, 1, (3, 4)).astype(np.float32),
            "b": (rng.normal(0, 1, (5,)).astype(np.float32),)}
    kw = dict(learning_rate=1e-2, final_learning_rate=1e-3, num_epochs=4, weight_decay=1e-2)
    jopt = jax_trainer.make_optimizer(jax_trainer.TrainConfig(**kw), 2)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    tparams = params_from_jax(tree, device="cpu")
    opt = make_optimizer(TrainConfig(**kw), 2)
    state = opt.init(tparams)
    for step in range(3):  # steps 0, 1 in epoch 0; step 2 in epoch 1
        grads = jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), tree)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.apply(state, [torch.from_numpy(g) for g in tree_leaves(grads)])
        for a, b in zip(tree_leaves(params_to_numpy(tparams)),
                        tree_leaves(jax.tree.map(np.asarray, jparams))):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.1 ** 0.25)


def _models(seed=1):
    base = dict(node_input_size=17, latent_size=32, mlp_hidden_size=32,
                num_message_passing_steps=2)
    jcfg, tcfg = JaxConfig(**base), EncodeProcessDecodeConfig(**base)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams


def _batch(n, seed):
    pos, temp = _window(n, seed)
    return {"positions": pos[None, :5], "temperatures": temp[None, :5],
            "target_positions": pos[None, 5], "target_temperatures": temp[None, 5]}


def jax_step_grads(jcfg, jparams, batch, **tc):
    """Loss, metrics and gradients of one JAX train step (sgd(1.0))."""
    step = jax_trainer.make_train_step(jcfg, JaxStats.from_metadata(METADATA),
                                       jax_trainer.TrainConfig(**tc), optax.sgd(1.0))
    new, _, metrics = step(jparams, optax.sgd(1.0).init(jparams),
                           jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    old = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    new = tree_leaves(params_from_jax(jax.tree.map(np.asarray, new), device="cpu"))
    return metrics, [(a - b).numpy() for a, b in zip(old, new)]


def port_step_grads(tcfg, jparams, batch, **tc):
    """Loss, metrics and gradients of one port train step (SGD, lr 1)."""
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    old = [t.clone() for t in tree_leaves(tparams)]
    sgd = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
    step = make_train_step(tcfg, NormalizationStats.from_metadata(METADATA, device="cpu"),
                           TrainConfig(**tc), sgd)
    tparams, _, metrics = step(tparams, sgd.init(tparams), batch, torch.Generator())
    return metrics, [(a - b.detach()).numpy() for a, b in zip(old, tree_leaves(tparams))]


def assert_step_matches(metrics, grads, jmetrics, jgrads, dtype):
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                                   rel=1e-6 if dtype is None else 1e-3)
    for key in ("acceleration", "temp_rate", "momentum"):
        assert float(metrics[key]) == pytest.approx(float(jmetrics[key]), rel=1e-3, abs=1e-9)
    assert len(grads) == len(jgrads)
    worst = max(_rel_err(a, b) for a, b in zip(grads, jgrads))
    assert worst <= GRAD_TOL[dtype], worst


CASES = {
    # name: (compute dtype, fused tail, build_reverse)
    "f32": (None, False, True),
    "f32_no_reverse": (None, False, False),
    "bf16_fused_tail": ("bfloat16", True, True),
    "bf16_fused_tail_no_reverse": ("bfloat16", True, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_train_step_matches_jax(case):
    dtype, fused, build_reverse = CASES[case]
    jcfg, tcfg, jparams = _models()
    batch = _batch(4096, 6)
    tc = dict(aggregation="gather", compute_dtype=dtype, fused_tail=fused,
              build_reverse=build_reverse, augment_prob=0.0, noise_std=0.0,
              momentum_loss_weight=0.1)
    jmetrics, jgrads = jax_step_grads(jcfg, jparams, batch, **tc)
    metrics, grads = port_step_grads(tcfg, jparams, batch, **tc)
    assert_step_matches(metrics, grads, jmetrics, jgrads, dtype)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_eval_step_matches_jax(dtype):
    """No noise, no augmentation, no gradient: the metrics of one batch."""
    jcfg, tcfg, jparams = _models(seed=3)
    batch = _batch(4096, 8)
    tc = dict(aggregation="gather", compute_dtype=dtype, noise_std=3e-4,
              momentum_loss_weight=0.1)
    jmetrics = jax_trainer.make_eval_step(jcfg, JaxStats.from_metadata(METADATA),
                                          jax_trainer.TrainConfig(**tc))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    metrics = make_eval_step(tcfg, NormalizationStats.from_metadata(METADATA, device="cpu"),
                             TrainConfig(**tc))(tparams, batch)
    assert set(metrics) == set(jmetrics)
    for key in metrics:
        assert not metrics[key].requires_grad
        assert float(metrics[key]) == pytest.approx(float(jmetrics[key]),
                                                    rel=1e-6 if dtype is None else 1e-3,
                                                    abs=1e-9)


def test_train_step_options_that_are_refused():
    _, tcfg, _ = _models()
    stats = NormalizationStats.from_metadata(METADATA, device="cpu")
    opt = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
    # The slot-space carry, variable capacities and the per-particle noise
    # keying are ported: accepted.
    for tc in (TrainConfig(aggregation="cellblock"), TrainConfig(cellblock_variable=True),
               TrainConfig(partition_invariant_noise=True)):
        assert callable(make_train_step(tcfg, stats, tc, opt))
    with pytest.raises(ValueError):
        make_train_step(tcfg, stats, TrainConfig(aggregation="nope"), opt)
    with pytest.raises(ValueError, match="pruned"):
        make_train_step(tcfg._replace(aggregate="edge_messages"), stats,
                        TrainConfig(fused_tail=True), opt)
