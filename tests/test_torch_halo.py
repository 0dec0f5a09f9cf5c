"""The port's halo exchange and halo steps (``parallel/halo.py``, gather
aggregation) on gloo ranks, held against the JAX package's halo functions on
its virtual CPU mesh, against the host mirror of the exchange
(``shard_candidates``, ``slab_frame``) and against the port's single-device
steps.

One spawn per world size (2 and 4 ranks, ``tests/torch_halo_workers.py`` on
``torch_sharded_workers.Ranks``: a file store, no JAX in the ranks) runs
every case; the references are computed here meanwhile. JAX compiles its
halo functions at 4 shards, and ``featurize_halo`` once at 2. The setup is
``tests/test_halo.py``'s: N = 4,096, k = 4, latent 16, one hidden layer, 2
message-passing steps, noise 0 wherever JAX is the reference (JAX's noise
keys are threefry's), the synthetic simulation of seed 3.

Tolerances:
* the exchange, the ring permute and the local frame are copies: equal,
  bit for bit;
* ``featurize_halo``'s nodes, edges and targets within 1e-6 of JAX's,
  relative to each array's largest magnitude (``tests/test_torch_training.py``'s
  measure; divisions by dt put the targets a few ulps apart), the
  neighbor sets exactly (both index the same candidate rows), the overflow
  counts equal, ``max_kth_d2`` and ``max_excess_sq`` within 4 float32 ulps
  (``tests/test_torch_knn.py``: XLA:CPU contracts its squared distances into
  FMAs);
* rollouts within 2e-5 (``test_halo.py``'s), the certificate true every
  step and the migration diagnostics 0;
* the train step against JAX's through Adam: losses at ``test_halo.py``'s
  rtols (acceleration and temperature rate 2e-4, momentum and loss 1e-3),
  parameters rtol 3e-4, atol 3e-6; against the port's single-device step
  (the gradients the same Adam step applied, kept by the optimizer),
  every gradient leaf within 3e-5 of its largest magnitude and the loss
  within 1e-5;
* the eval step's per-sample metrics within 2e-5 of JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec

from cosmology_gnn_simulation_tpu.data.synthetic import generate_synthetic_simulation
from cosmology_gnn_simulation_tpu.metadata import compute_metadata
from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.parallel import halo as jhalo
from cosmology_gnn_simulation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cosmology_gnn_simulation_tpu.training.trainer import TrainConfig as JaxTrainConfig
from cosmology_gnn_simulation_tpu.training.trainer import make_optimizer as jax_make_optimizer
from cosmology_gnn_simulation_tpu.training.trainer import (
    default_model_config as jax_default_model_config,
)
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    apply_encode_process_decode,
    default_model_config,
)
from cosmology_gnn_simulation_tpu_torch.ops import cellblock
from cosmology_gnn_simulation_tpu_torch.parallel import halo
from cosmology_gnn_simulation_tpu_torch.parallel.mesh import make_mesh
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.training.trainer import TrainConfig, make_optimizer
from cosmology_gnn_simulation_tpu_torch.types import (
    NormalizationStats,
    ParticleGraph,
    tree_leaves,
)
from test_torch_knn import _close_ulps

import torch_halo_workers as hw
import torch_sharded_workers as workers

N, K, STEPS = 4096, 4, 4
MODEL = dict(window_size=5, latent_size=16, mlp_hidden_size=16, mlp_num_hidden_layers=1,
             num_message_passing_steps=2)
TC = dict(num_neighbors=K, batch_size=2, noise_std=0.0, augment_prob=0.0,
          momentum_loss_weight=0.5, neighbor_query_tile=512)
# test_halo.py's noised step: the noise keyed per particle (the port's
# single-device side of the contract).
NOISED_TC = dict(TC, noise_std=3e-4, partition_invariant_noise=True)
# The port's single-device references search with the plain cell list, as
# the halo shards do (the same neighbor sets as brute force, which "auto"
# picks at this N, at a fraction of the CPU time).
SEARCH = "celllist"
FEATURE_TOL, OUT_TOL = 1e-6, 2e-5
JAX_RTOLS = {"acceleration": 2e-4, "temp_rate": 2e-4, "momentum": 1e-3, "loss": 1e-3}
PARAM_RTOL, PARAM_ATOL = 3e-4, 3e-6
GRAD_TOL, LOSS_RTOL = 3e-5, 1e-5
SEED = 5


@pytest.fixture(scope="module")
def setup():
    sim = generate_synthetic_simulation(num_snapshots=12, num_particles=N, seed=3)
    meta = {key: (np.asarray(v).tolist() if hasattr(v, "shape") else v)
            for key, v in compute_metadata(sim).items()}
    jcfg = jax_default_model_config(**MODEL)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    batch = {"positions": np.stack([sim["Coordinates"][i:i + 5] for i in range(2)]),
             "temperatures": np.stack([sim["InternalEnergy"][i:i + 5] for i in range(2)]),
             "target_positions": np.stack([sim["Coordinates"][i + 5] for i in range(2)]),
             "target_temperatures": np.stack([sim["InternalEnergy"][i + 5] for i in range(2)])}
    return dict(sim=sim, meta=meta, jstats=JaxStats.from_metadata(meta), jcfg=jcfg,
                jparams=jparams, params=jax.tree.map(np.asarray, jparams), batch=batch,
                pos=sim["Coordinates"][:5], temp=sim["InternalEnergy"][:5])


def _kw(s, **extra):
    return dict(model=MODEL, meta=s["meta"], params=s["params"], **extra)


def _jax_mesh(shape):
    return jax_make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


def _partition(s, hc):
    """The first window partitioned with its targets (``featurize``'s
    inputs)."""
    return halo.partition_windows(s["pos"], s["temp"], hc, 1.0,
                                  target_position=s["sim"]["Coordinates"][5],
                                  target_temperature=s["sim"]["InternalEnergy"][5])


def wrapped_frame(s, hc):
    """The partitioned last frame with shard 0's first particle moved to
    x = 1 - 1e-4, as noise wraps it across x = 0: its slab's left
    neighbour must receive it."""
    part = halo.partition_windows(s["pos"], s["temp"], hc, 1.0)
    recent = part["positions"][-1].copy()
    recent[0, 0] = np.float32(1 - 1e-4)
    return recent, part["valid"]


def exchange_cases(s, hc, spec):
    recent, valid = wrapped_frame(s, hc)
    return [("permute", hw.permute_case, (1, hc.num_shards), dict(seed=3)),
            ("exchange", hw.exchange_case, (1, hc.num_shards),
             dict(hc=tuple(hc), recent=recent, valid=valid, grid_x=spec.gx))]


def check_exchange(ranks, s, hc, spec):
    """The permute both ways and its backward; every rank's candidates and
    local frame bit-equal to the host mirror's, the wrapped particle with
    the left neighbour."""
    p = hc.num_shards
    for q in range(p):
        for shift in (1, -1):
            y, g = ranks[q]["permute"][shift]
            np.testing.assert_array_equal(y, ranks[(q - shift) % p]["permute"]["x"])
            np.testing.assert_array_equal(g, ranks[(q + shift) % p]["permute"]["w"])
        assert ranks[q]["permute"]["collectives"]["ppermute"] == 4
    recent, valid = wrapped_frame(s, hc)
    for q in range(p):
        cand, cand_valid, overflow = halo.shard_candidates(recent, valid, hc, 1.0, q)
        got = ranks[q]["exchange"]
        np.testing.assert_array_equal(got["positions"], cand)
        np.testing.assert_array_equal(got["valid"], cand_valid)
        assert got["overflow"] == overflow == 0
        local, box_local = halo.slab_frame(cand, hc, spec.gx, 1.0, q)
        np.testing.assert_array_equal(got["local"], local)
        np.testing.assert_array_equal(got["box_local"], box_local)
    from_right = ranks[p - 1]["exchange"]["positions"][hc.local_capacity + hc.halo_capacity:]
    assert (from_right == recent[0]).all(axis=1).any()


def _spec(hc):
    return cellblock.choose_cellblock_spec_halo(N, hc.grid_size, hc.slab_layers, hc.halo_layers,
                                                hc.num_shards, h_block=128)


def _jax_featurize(s, hc, part):
    """JAX ``featurize_halo`` under ``shard_map`` on ``num_shards`` CPU
    devices (noise 0): each shard's graph arrays and diagnostics."""
    mesh = Mesh(np.array(jax.devices()[:hc.num_shards]), ("particle",))
    win, rows, vec = (PartitionSpec(None, "particle", None), PartitionSpec("particle", None),
                      PartitionSpec("particle"))
    diag_keys = ("halo_overflow", "cell_overflow", "max_kth_d2", "max_excess_sq")

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(win, win, vec, rows, rows),
                       out_specs=(rows, rows, PartitionSpec("particle", None, None), rows, rows,
                                  rows))
    def feat(pos, temp, valid, tpos, ttemp):
        graph, _, diag = jhalo.featurize_halo(
            pos, temp, valid, s["jstats"], jax.random.PRNGKey(0), noise_std=0.0,
            num_neighbors=K, hc=hc, axis_name="particle", target_position=tpos,
            target_temperature=ttemp, with_diagnostics=True)
        return (graph.nodes, graph.neighbors, graph.edges, graph.target_acceleration,
                graph.target_temp_rate,
                jnp.stack([jnp.asarray(diag[k], jnp.float32) for k in diag_keys])[None])

    out = jax.jit(feat)(*(jnp.asarray(part[key]) for key in
                          ("positions", "temperatures", "valid", "target_positions",
                           "target_temperatures")))
    names = ("nodes", "neighbors", "edges", "target_acceleration", "target_temp_rate")
    per_shard = []
    for q in range(hc.num_shards):
        rows_q = {}
        for name, value in zip(names, out[:5]):
            value = np.asarray(value)
            m = value.shape[0] // hc.num_shards
            rows_q[name] = value[q * m:(q + 1) * m]
        rows_q["diag"] = dict(zip(diag_keys, np.asarray(out[5])[q]))
        per_shard.append(rows_q)
    return per_shard


def check_featurize(ranks, jax_shards):
    for q, want in enumerate(jax_shards):
        got = ranks[q]["featurize"]
        for name in ("nodes", "edges", "target_acceleration", "target_temp_rate"):
            scale = np.abs(want[name]).max()
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=FEATURE_TOL * scale,
                                       err_msg=name)
        np.testing.assert_array_equal(np.sort(got["neighbors"], axis=1),
                                      np.sort(want["neighbors"], axis=1))
        for name in ("halo_overflow", "cell_overflow"):
            assert got["diag"][name] == want["diag"][name] == 0
        for name in ("max_kth_d2", "max_excess_sq"):
            _close_ulps(got["diag"][name], want["diag"][name], want["diag"]["max_kth_d2"])


def check_gradients(got, want):
    """The steps' gradients within GRAD_TOL of each leaf's largest
    magnitude; the loss within LOSS_RTOL."""
    assert got["metrics"]["loss"] == pytest.approx(want["metrics"]["loss"], rel=LOSS_RTOL)
    worst = max(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)
                for x, y in zip(got["grads"], want["grads"]))
    assert worst <= GRAD_TOL, worst


@pytest.fixture(scope="module")
def single(setup):
    """The port's single-device train step on the batch (noise 0)."""
    return hw.single_train(**_kw(setup), tc=dict(TC, neighbor_method=SEARCH),
                           batch=setup["batch"], seed=SEED)


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    """Two ranks (the degenerate ring: both neighbours one rank): the
    exchange, ``featurize_halo`` against JAX at 2 shards, a
    ``run_halo_rollout`` against the port's single-device rollout and a
    train step (SGD) against the port's single-device step."""
    s = setup
    hc = halo.choose_halo_config(N, K, 2)
    spec = _spec(hc)
    part = _partition(s, hc)
    cases = [*exchange_cases(s, hc, spec),
             ("featurize", hw.featurize_case, (1, 2), _kw(s, hc=tuple(hc), part=part, k=K)),
             ("run_rollout", hw.run_rollout_case, (1, 2),
              _kw(s, hc=tuple(hc), pos=s["pos"], temp=s["temp"], k=K, steps=STEPS)),
             ("train", hw.train_case, (1, 2),
              _kw(s, hc=tuple(hc), tc=TC, part=halo.partition_batch(s["batch"], hc, 1.0),
                  seed=SEED))]
    spawned = workers.Ranks(2, str(tmp_path_factory.mktemp("halo2") / "rendezvous"), cases)
    stats = NormalizationStats.from_metadata(s["meta"], device="cpu")
    cfg = default_model_config(**MODEL)
    refs = {"featurize": _jax_featurize(s, hc, part),
            "rollout": rollout(params_from_jax(s["params"], device="cpu"), cfg, s["pos"],
                               s["temp"], stats, STEPS, num_neighbors=K, device="cpu",
                               neighbor_method=SEARCH)}
    return spawned.results(), refs, hc, spec


def test_exchange_on_two_ranks(setup, two_ranks):
    ranks, _, hc, spec = two_ranks
    check_exchange(ranks, setup, hc, spec)


def test_featurize_halo_matches_jax_on_two_ranks(two_ranks):
    ranks, refs, _, _ = two_ranks
    check_featurize(ranks, refs["featurize"])


def test_run_halo_rollout_on_two_ranks(two_ranks):
    ranks, refs, _, _ = two_ranks
    for rank in (0, 1):
        got = ranks[rank]["run_rollout"]
        assert got["diag"] == {"overflow": 0, "stranded": 0}
        assert got["traj"]["neighbor_exactness"].all()
        for key in ("Coordinates", "InternalEnergy"):
            np.testing.assert_allclose(got["traj"][key], refs["rollout"][key].numpy(),
                                       rtol=OUT_TOL, atol=OUT_TOL)


def test_halo_train_step_on_two_ranks(two_ranks, single):
    ranks, _, _, _ = two_ranks
    assert workers.equal_on_every_rank([ranks[r]["train"]["params"] for r in (0, 1)])
    check_gradients(ranks[0]["train"], single)
    # Per sample: the positions' exchange, each step's latents and their
    # backward; then the particle sum, the data mean and the gradients.
    m = MODEL["num_message_passing_steps"]
    assert ranks[0]["train"]["collectives"] == {"all_gather": 0, "all_reduce": 3,
                                                "broadcast": 0, "ppermute": 2 * (2 + 4 * m)}


@pytest.fixture(scope="module")
def four_ranks(setup, tmp_path_factory):
    """Four ranks: the exchange; the gather rollout (with migration), the
    train step (Adam, SGD) and the eval step against JAX's at 4 shards; the
    noised step on a (2, 2) mesh against the port's noised single-device
    step."""
    s = setup
    hc = halo.choose_halo_config(N, K, 4)
    hc_noise = halo.choose_halo_config(N, K, 2, noise=True)
    spec = _spec(hc)
    part = halo.partition_windows(s["pos"], s["temp"], hc, 1.0)
    tpart = halo.partition_batch(s["batch"], hc, 1.0)
    cases = [*exchange_cases(s, hc, spec),
             ("rollout", hw.rollout_case, (1, 4),
              _kw(s, hc=tuple(hc), part=part, k=K, steps=STEPS)),
             ("train", hw.train_case, (1, 4), _kw(s, hc=tuple(hc), tc=TC, part=tpart, seed=SEED)),
             ("eval", hw.eval_case, (1, 4), _kw(s, hc=tuple(hc), tc=TC, part=tpart)),
             ("noised", hw.train_case, (2, 2),
              _kw(s, hc=tuple(hc_noise), tc=NOISED_TC,
                  part=halo.partition_batch(s["batch"], hc_noise, 1.0), seed=SEED))]
    spawned = workers.Ranks(4, str(tmp_path_factory.mktemp("halo4") / "rendezvous"), cases)
    mesh = _jax_mesh((1, 4))
    jtraj, jdiag = jhalo.run_halo_rollout(s["jparams"], s["jcfg"], s["pos"], s["temp"],
                                          s["jstats"], STEPS, mesh, hc, num_neighbors=K)
    jtc = JaxTrainConfig(**TC)
    jopt = jax_make_optimizer(jtc, steps_per_epoch=1)
    jbatch = jhalo.shard_halo_batch(tpart, mesh)
    keys = jax.random.split(jax.random.PRNGKey(SEED), 2)
    jstep = jhalo.make_halo_train_step(s["jcfg"], s["jstats"], jtc, jopt, mesh, hc)
    jnew, _, jmetrics = jstep(s["jparams"], jopt.init(s["jparams"]), jbatch, keys)
    jeval = jhalo.make_halo_eval_step(s["jcfg"], s["jstats"], jtc, mesh, hc)(s["jparams"],
                                                                             jbatch)
    refs = {"rollout": (jtraj, jdiag), "part": part,
            "train": ({k: float(v) for k, v in jmetrics.items()},
                      [t.numpy() for t in tree_leaves(params_from_jax(
                          jax.tree.map(np.asarray, jnew), device="cpu"))]),
            "eval": {k: np.asarray(v) for k, v in jeval.items()},
            "noised": hw.single_train(**_kw(s), tc=dict(NOISED_TC, neighbor_method=SEARCH),
                                      batch=s["batch"], seed=SEED)}
    return spawned.results(), refs, hc, spec


def test_exchange_on_four_ranks(setup, four_ranks):
    ranks, _, hc, spec = four_ranks
    check_exchange(ranks, setup, hc, spec)


def test_halo_rollout_matches_jax_and_migrates(setup, four_ranks):
    ranks, refs, hc, _ = four_ranks
    jtraj, jdiag = refs["rollout"]
    outs = {key: np.concatenate([ranks[q]["rollout"]["outs"][key] for q in range(4)], axis=1)
            for key in ranks[0]["rollout"]["outs"]}
    traj = halo.reassemble_trajectory(outs, setup["pos"], setup["temp"])
    for key in ("Coordinates", "InternalEnergy"):
        np.testing.assert_allclose(traj[key], jtraj[key], rtol=OUT_TOL, atol=OUT_TOL)
    for q in range(4):
        got = ranks[q]["rollout"]
        assert got["exact"].all() and got["diag"] == jdiag == {"overflow": 0, "stranded": 0}
        for name, value in got["certs"].items():
            if not name.startswith("max"):
                assert not value.any(), name
        assert (got["certs"]["max_excess_sq"] <= 0).all()
    np.testing.assert_array_equal(jtraj["neighbor_exactness"], ranks[0]["rollout"]["exact"])
    # The particle count is conserved, and particles change slab.
    assert (outs["valid"].sum(axis=1) == N).all()
    cap, part = hc.local_capacity, refs["part"]
    first = set(part["gid"][:cap][part["valid"][:cap]].tolist())
    last = ranks[0]["rollout"]["outs"]
    assert first != set(last["gid"][-1][last["valid"][-1]].tolist())
    # A step: the positions', each message-passing step's latents' and the
    # migration's exchanges, and one gather of the certificate.
    m = MODEL["num_message_passing_steps"]
    assert ranks[0]["rollout"]["collectives"] == {
        "all_gather": STEPS, "all_reduce": 0, "broadcast": 0, "ppermute": STEPS * (4 + 2 * m)}


def test_halo_train_step_matches_jax_and_single_device(four_ranks, single):
    ranks, refs, _, _ = four_ranks
    assert workers.equal_on_every_rank([ranks[r]["train"]["params"] for r in range(4)])
    jmetrics, jparams = refs["train"]
    got = ranks[0]["train"]
    for key, rtol in JAX_RTOLS.items():
        assert got["metrics"][key] == pytest.approx(jmetrics[key], rel=rtol), key
    for x, y in zip(got["params"], jparams):
        np.testing.assert_allclose(x, y, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    check_gradients(got, single)


def test_halo_eval_step_matches_jax(four_ranks):
    ranks, refs, _, _ = four_ranks
    for q in range(4):
        for key, want in refs["eval"].items():
            assert ranks[q]["eval"][key].shape == (2,)
            np.testing.assert_allclose(ranks[q]["eval"][key], want, rtol=OUT_TOL, atol=OUT_TOL)


def test_noised_halo_train_step_matches_single_device(four_ranks):
    """partition_invariant_noise: each data rank draws the single-device
    step's keys for its own sample and skips the other's."""
    ranks, refs, _, _ = four_ranks
    assert workers.equal_on_every_rank([ranks[r]["noised"]["params"] for r in range(4)])
    check_gradients(ranks[0]["noised"], refs["noised"])


@pytest.fixture
def one_rank():
    try:
        yield make_mesh((1, 1), device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_halo_refusals(setup, one_rank):
    s = setup
    cfg = default_model_config(**MODEL)
    stats = NormalizationStats.from_metadata(s["meta"], device="cpu")
    tc = TrainConfig(**TC)
    with pytest.raises(ValueError, match="num_shards"):
        halo.choose_halo_config(N, K, 1)
    hc = halo.choose_halo_config(N, K, 2)
    with pytest.raises(ValueError, match="local_capacity"):
        halo.partition_windows(s["pos"], s["temp"], hc._replace(local_capacity=8), 1.0)
    for make in (lambda: halo.make_halo_train_step(cfg, stats, tc, make_optimizer(tc, 1),
                                                   one_rank, hc),
                 lambda: halo.make_halo_eval_step(cfg, stats, tc, one_rank, hc),
                 lambda: halo.make_halo_rollout(cfg, stats, one_rank, 1, hc)):
        with pytest.raises(ValueError, match="num_shards"):
            make()
    graph = ParticleGraph(nodes=torch.zeros(4, 17), neighbors=None, edges=None,
                          positions=torch.zeros(4, 3), cellblock=object())
    params = params_from_jax(s["params"], device="cpu")
    axis = one_rank.axis("particle")
    with pytest.raises(ValueError, match="use halo sharding"):
        apply_encode_process_decode(params, graph, cfg, cellblock_spec=object(),
                                    particle_axis=axis)
    with pytest.raises(ValueError, match="cellblock_mode='hybrid'"):
        apply_encode_process_decode(params, graph, cfg, cellblock_spec=object(),
                                    particle_axis=axis, halo=object())
