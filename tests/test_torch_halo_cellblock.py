"""The halo x cell-block composition of the port (``parallel/halo.py`` with a
``choose_cellblock_spec_halo`` spec): each shard's aggregation runs K4 (K4^T
in the backward; their plain versions on the CPU) over the shard's local
open-slab plan, held on gloo ranks against the JAX package's halo x
cell-block functions on its virtual CPU mesh, against the plan built on the
host from the exchange's mirror (``shard_candidates``, ``slab_frame``) and
against the port's single-device steps.

One spawn of 4 ranks (``tests/torch_halo_workers.py``; the degenerate ring
of 2 runs in ``tests/test_torch_halo.py``); JAX compiles its halo functions
at 4 shards only. The setup is ``tests/test_halo.py``'s (see
``tests/test_torch_halo.py``), the slab spec ``test_halo_cellblock.py``'s
(``h_block=128``).

Tolerances: the plan is integer arithmetic on equal inputs: equal, bit for
bit, to the host-built plan; the rollouts within 2e-5 of JAX's and of the
port's single-device hybrid rollout (float32 sums in window order on both
sides), the certificate true every step with no plan overflow or dropped
edge; the train step as ``tests/test_torch_halo.py``'s.
"""

import jax
import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu.ops.cellblock import (
    choose_cellblock_spec_halo as jax_choose_spec_halo,
)
from cosmology_gnn_simulation_tpu.parallel import halo as jhalo
from cosmology_gnn_simulation_tpu.training.trainer import TrainConfig as JaxTrainConfig
from cosmology_gnn_simulation_tpu.training.trainer import make_optimizer as jax_make_optimizer
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import default_model_config
from cosmology_gnn_simulation_tpu_torch.ops import cellblock
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import CellGrid, cell_list_knn
from cosmology_gnn_simulation_tpu_torch.parallel import halo
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves
from test_torch_halo import (  # noqa: F401 (the module fixture)
    JAX_RTOLS,
    K,
    MODEL,
    N,
    OUT_TOL,
    PARAM_ATOL,
    PARAM_RTOL,
    SEARCH,
    SEED,
    TC,
    _jax_mesh,
    _kw,
    _partition,
    _spec,
    check_gradients,
    setup,
    single,
)

import torch_halo_workers as hw
import torch_sharded_workers as workers

STEPS = 3
PLAN_FIELDS = ("order", "slot_of_sorted", "particle_of_slot", "pad_src", "window_starts",
               "s_table", "overflow", "dropped_edges", "window_overflow")


@pytest.fixture(scope="module")
def single_hybrid(setup):
    """The port's single-device hybrid rollout of the first window."""
    s = setup
    stats = NormalizationStats.from_metadata(s["meta"], device="cpu")
    out = rollout(params_from_jax(s["params"], device="cpu"), default_model_config(**MODEL),
                  s["pos"], s["temp"], stats, STEPS, num_neighbors=K, device="cpu",
                  aggregation="cellblock_hybrid", neighbor_method=SEARCH)
    return {key: out[key].numpy() for key in ("Coordinates", "InternalEnergy")}


def _host_plan(part, hc, spec, shard):
    """Shard ``shard``'s plan built on the host side: the exchange's mirror
    (``shard_candidates``), the masked cell list, ``slab_frame``."""
    cand, cand_valid, _ = halo.shard_candidates(part["positions"][-1], part["valid"], hc, 1.0,
                                                shard)
    cap, m = hc.local_capacity, cand.shape[0]
    cand_t, valid_t = torch.from_numpy(cand), torch.from_numpy(cand_valid)
    idx = cell_list_knn(cand_t, K, 1.0, CellGrid(hc.grid_size, hc.cell_capacity),
                        queries=cand_t[:cap], valid=valid_t)
    nbr = torch.cat([idx, torch.full((m - cap, K), m, dtype=idx.dtype)])
    local, box_local = halo.slab_frame(cand, hc, spec.gx, 1.0, shard)
    return cellblock.build_cellblock(torch.from_numpy(local), nbr, torch.from_numpy(box_local),
                                     spec, valid=valid_t)


@pytest.fixture(scope="module")
def four_ranks(setup, single_hybrid, tmp_path_factory):
    """Four ranks: ``featurize_halo``'s plans against the host-built ones;
    ``run_halo_rollout`` with the slab spec against JAX's and the port's
    single-device hybrid rollout; the train step (Adam) against JAX's, and
    its gradients against the port's single-device step's."""
    s = setup
    hc = halo.choose_halo_config(N, K, 4)
    spec = _spec(hc)
    part = _partition(s, hc)
    tpart = halo.partition_batch(s["batch"], hc, 1.0)
    cases = [("featurize", hw.featurize_case, (1, 4),
              _kw(s, hc=tuple(hc), part=part, k=K, spec=spec)),
             ("run_rollout", hw.run_rollout_case, (1, 4),
              _kw(s, hc=tuple(hc), pos=s["pos"], temp=s["temp"], k=K, steps=STEPS, spec=spec)),
             ("train", hw.train_case, (1, 4),
              _kw(s, hc=tuple(hc), tc=TC, part=tpart, seed=SEED, spec=spec))]
    spawned = workers.Ranks(4, str(tmp_path_factory.mktemp("halocb4") / "rendezvous"), cases)
    mesh = _jax_mesh((1, 4))
    jspec = jax_choose_spec_halo(N, hc.grid_size, hc.slab_layers, hc.halo_layers, 4,
                                 h_block=128)
    jtraj, jdiag = jhalo.run_halo_rollout(s["jparams"], s["jcfg"], s["pos"], s["temp"],
                                          s["jstats"], STEPS, mesh, hc, num_neighbors=K,
                                          cellblock_spec=jspec)
    jtc = JaxTrainConfig(**TC)
    jopt = jax_make_optimizer(jtc, steps_per_epoch=1)
    jstep = jhalo.make_halo_train_step(s["jcfg"], s["jstats"], jtc, jopt, mesh, hc,
                                       cellblock_spec=jspec)
    jnew, _, jmetrics = jstep(s["jparams"], jopt.init(s["jparams"]),
                              jhalo.shard_halo_batch(tpart, mesh),
                              jax.random.split(jax.random.PRNGKey(SEED), 2))
    refs = {"plans": [_host_plan(part, hc, spec, q) for q in range(4)],
            "rollout": (jtraj, jdiag), "single_rollout": single_hybrid,
            "train": ({k: float(v) for k, v in jmetrics.items()},
                      [t.numpy() for t in tree_leaves(params_from_jax(
                          jax.tree.map(np.asarray, jnew), device="cpu"))])}
    return spawned.results(), refs, hc


def test_featurize_halo_plan_matches_the_host_built_plan(four_ranks):
    ranks, refs, hc = four_ranks
    for q in range(4):
        got, want = ranks[q]["featurize"], refs["plans"][q]
        for field in PLAN_FIELDS:
            np.testing.assert_array_equal(got["plan"][field], getattr(want, field).numpy(),
                                          err_msg=field)
        assert got["diag"]["cb_overflow"] == got["diag"]["cb_dropped"] == 0
        # inv_owned takes the plan order back to the owned rows.
        np.testing.assert_array_equal(got["plan"]["order"][got["inv_owned"]],
                                      np.arange(hc.local_capacity))


def test_halo_cellblock_rollout_matches_jax(four_ranks):
    ranks, refs, _ = four_ranks
    jtraj, jdiag = refs["rollout"]
    for q in range(4):
        got = ranks[q]["run_rollout"]
        assert got["diag"] == jdiag == {"overflow": 0, "stranded": 0}
        # The certificate covers the plans' overflow and dropped edges.
        assert got["traj"]["neighbor_exactness"].all() and jtraj["neighbor_exactness"].all()
        for key in ("Coordinates", "InternalEnergy"):
            np.testing.assert_allclose(got["traj"][key], jtraj[key], rtol=OUT_TOL, atol=OUT_TOL)


def test_halo_cellblock_rollout_matches_single_device(four_ranks):
    ranks, refs, _ = four_ranks
    for key in ("Coordinates", "InternalEnergy"):
        np.testing.assert_allclose(ranks[0]["run_rollout"]["traj"][key],
                                   refs["single_rollout"][key], rtol=OUT_TOL, atol=OUT_TOL)


def test_halo_cellblock_train_step_matches_jax_and_single_device(four_ranks, single):
    ranks, refs, _ = four_ranks
    assert workers.equal_on_every_rank([ranks[r]["train"]["params"] for r in range(4)])
    jmetrics, jparams = refs["train"]
    got = ranks[0]["train"]
    for key, rtol in JAX_RTOLS.items():
        assert got["metrics"][key] == pytest.approx(jmetrics[key], rel=rtol), key
    for x, y in zip(got["params"], jparams):
        np.testing.assert_allclose(x, y, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    check_gradients(got, single)
