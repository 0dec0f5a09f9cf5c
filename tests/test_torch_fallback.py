"""The rollout's brute-force fallback, its cell-sorted state and the
separate-query searches, held against the JAX package on the CPU.

* ``exactness_guard="fallback"`` on the clustered frame of
  ``tests/test_exactness.py`` (95 % of the particles in a sigma 0.01 ball;
  N = 4,096 where that test takes 16,384, to keep the brute-force reruns
  short: the XLA / plain cell list, asked for by name, serves at any N,
  and its certificate fails every step): coordinates within 1e-5 of JAX's
  fallback (float32, summation order only) and equal flags; within 1e-6 of the port's brute-force
  rollout (the JAX test's tolerance; the two run the same brute force),
  while the unguarded run differs; the same at ``reneighbor_every=2`` and
  with ``sorted_state="on"``. On a uniform frame the certificate holds and
  the fallback changes nothing: bit-equal to ``"flag"``.
* ``sorted_state="on"``: within 1e-5 of JAX's ``"on"``, and bit-equal to
  the port's ``"off"`` on a tie-free frame (brute force keeps each query's
  neighbors in distance order), also at ``reneighbor_every=2``.
* ``knn_periodic_reference``, ``cell_list_knn`` and ``neighbor_search``
  with separate queries against JAX: equal neighbor sets and overflow;
  ``max_d2`` and ``max_excess`` within 4 float32 ulps (XLA:CPU contracts
  JAX's squares and sums into FMAs; ``tests/test_torch_knn.py``), the
  excess's ulps taken at the largest window margin^2 ``(1.5 edge)^2``, since
  it is the difference of a k-th d^2 and a margin^2 of up to that size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu.featurize import neighbor_search as jax_neighbor_search
from cosmology_gnn_simulation_tpu.models.encode_process_decode import (
    init_encode_process_decode as jax_init,
)
from cosmology_gnn_simulation_tpu.ops.cell_list import (
    cell_list_knn as jax_cell_list_knn,
    cell_sort_order as jax_cell_sort_order,
    choose_cell_grid as jax_choose_cell_grid,
)
from cosmology_gnn_simulation_tpu.ops.neighbors import knn_periodic as jax_knn_periodic
from cosmology_gnn_simulation_tpu.rollout import rollout as jax_rollout
from cosmology_gnn_simulation_tpu.training.trainer import (
    default_model_config as jax_default_model_config,
)
from cosmology_gnn_simulation_tpu.types import NormalizationStats as JaxStats
from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.featurize import neighbor_search
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import default_model_config
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import (
    cell_list_knn,
    cell_sort_order,
    choose_cell_grid,
)
from cosmology_gnn_simulation_tpu_torch.ops.neighbors import knn_periodic_reference
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats
from test_torch_knn import _close_ulps, _sets_equal

N, K = 4096, 16
COORD_ATOL = 1e-5
EXACT_ATOL = 1e-6
METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": 1.0, "dt": 0.05,
}
MODEL = dict(window_size=5, latent_size=8, mlp_hidden_size=8, mlp_num_hidden_layers=1,
             num_message_passing_steps=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (as tests/test_torch_cli_train.py): the tier-1
    run puts six pytest workers on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _model():
    jcfg = jax_default_model_config(**MODEL)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jstats = JaxStats(**{key: (jnp.asarray(value) if key not in ("box_size", "dt")
                               else value) for key, value in METADATA.items()})
    return (jcfg, jparams, jstats), (default_model_config(**MODEL), tparams,
                                     NormalizationStats.from_metadata(METADATA, device="cpu"))


def _frame(kind, n=N, seed=1234):
    """The 5-frame seed window of tests/test_exactness.py about a clustered
    (95 % in a sigma 0.01 ball) or a uniform base frame."""
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        m = int(0.95 * n)
        base = np.concatenate([0.5 + rng.normal(0, 0.01, (m, 3)),
                               rng.uniform(0, 1, (n - m, 3))])
    else:
        base = rng.uniform(0, 1, (n, 3))
    base = np.remainder(base, 1.0).astype(np.float32)
    drift = rng.normal(0, 2e-4, (5, n, 3)).cumsum(axis=0)
    pos = np.remainder(base[None] + drift, 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (5, n, 1))).astype(np.float32)
    return pos, temp


def _port(pos, temp, steps, **kw):
    _, (cfg, params, stats) = _model()
    kernels.reset_launches()
    out = rollout(params, cfg, pos, temp, stats, steps, num_neighbors=K, device="cpu", **kw)
    assert not any(kernels.launches.values())  # CPU tensors launch nothing
    return out


def _jax(pos, temp, steps, **kw):
    (cfg, params, stats), _ = _model()
    out = jax_rollout(params, cfg, jnp.asarray(pos), jnp.asarray(temp), stats, steps,
                      num_neighbors=K, **kw)
    return {key: np.asarray(value) for key, value in out.items()}


@pytest.mark.parametrize("reneighbor_every", [1, 2])
def test_fallback_matches_jax_on_clustered_frame(reneighbor_every):
    pos, temp = _frame("clustered")
    steps = 2 * reneighbor_every
    kw = dict(neighbor_method="celllist", reneighbor_every=reneighbor_every)
    ref = _jax(pos, temp, steps, exactness_guard="fallback", **kw)
    out = _port(pos, temp, steps, exactness_guard="fallback", **kw)
    assert not ref["neighbor_exactness"].any()
    np.testing.assert_array_equal(out["neighbor_exactness"].numpy(), ref["neighbor_exactness"])
    np.testing.assert_allclose(out["Coordinates"].numpy(), ref["Coordinates"],
                               atol=COORD_ATOL, rtol=0)
    np.testing.assert_allclose(out["InternalEnergy"].numpy(), ref["InternalEnergy"],
                               atol=COORD_ATOL, rtol=0)

    exact = _port(pos, temp, steps, exactness_guard="off", reneighbor_every=reneighbor_every,
                  neighbor_method="bruteforce")
    np.testing.assert_allclose(out["Coordinates"].numpy(), exact["Coordinates"].numpy(),
                               atol=EXACT_ATOL, rtol=EXACT_ATOL)
    degraded = _port(pos, temp, steps, exactness_guard="flag", **kw)
    assert not np.allclose(degraded["Coordinates"].numpy(), exact["Coordinates"].numpy(),
                           atol=EXACT_ATOL, rtol=EXACT_ATOL)
    np.testing.assert_array_equal(degraded["neighbor_exactness"].numpy(),
                                  out["neighbor_exactness"].numpy())


def test_sorted_fallback_equals_unsorted_fallback_on_clustered_frame():
    pos, temp = _frame("clustered")
    kw = dict(neighbor_method="celllist", exactness_guard="fallback")
    plain = _port(pos, temp, 2, **kw)
    srt = _port(pos, temp, 2, sorted_state="on", **kw)
    np.testing.assert_array_equal(srt["Coordinates"].numpy(), plain["Coordinates"].numpy())
    np.testing.assert_array_equal(srt["neighbor_exactness"].numpy(),
                                  plain["neighbor_exactness"].numpy())


def test_fallback_changes_nothing_where_the_certificate_holds():
    pos, temp = _frame("uniform", n=1024)
    flag = _port(pos, temp, 2, neighbor_method="pallas")
    guarded = _port(pos, temp, 2, neighbor_method="pallas", exactness_guard="fallback")
    assert flag["neighbor_exactness"].all()
    for key in flag:
        assert torch.equal(guarded[key], flag[key]), key


@pytest.mark.parametrize("reneighbor_every", [1, 2])
def test_sorted_state_matches_jax_and_the_unsorted_rollout(reneighbor_every):
    pos, temp = _frame("uniform", n=1024, seed=5)
    kw = dict(neighbor_method="bruteforce", neighbor_query_tile=128,
              reneighbor_every=reneighbor_every)
    steps = 3 if reneighbor_every == 1 else 4
    ref = _jax(pos, temp, steps, sorted_state="on", **kw)
    srt = _port(pos, temp, steps, sorted_state="on", **kw)
    plain = _port(pos, temp, steps, sorted_state="off", **kw)
    for key in ("Coordinates", "InternalEnergy"):
        np.testing.assert_allclose(srt[key].numpy(), ref[key], atol=COORD_ATOL, rtol=0)
        assert torch.equal(srt[key], plain[key]), key
    order = cell_sort_order(torch.from_numpy(pos[-1]), K, 1.0)
    np.testing.assert_array_equal(order.numpy(),
                                  np.asarray(jax_cell_sort_order(jnp.asarray(pos[-1]), K, 1.0)))
    assert (order.numpy() != np.arange(pos.shape[1])).any()


def _queries(n_ref=9000, n_q=700, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n_ref, 3)).astype(np.float32),
            rng.uniform(0, 1, (n_q, 3)).astype(np.float32))


def test_brute_force_with_separate_queries_matches_jax():
    ref_pos, q = _queries()
    idx, d2 = knn_periodic_reference(torch.from_numpy(ref_pos), 8, 1.0,
                                     queries=torch.from_numpy(q), query_tile=256,
                                     return_distances=True)
    jidx, jd2 = jax_knn_periodic(jnp.asarray(ref_pos), 8, 1.0, queries=jnp.asarray(q),
                                 query_tile=256, return_distances=True)
    assert idx.shape == (q.shape[0], 8) and idx.dtype == torch.int64
    _sets_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=4 * 2**-23, atol=0)


def test_cell_list_with_separate_queries_matches_jax():
    ref_pos, q = _queries()
    grid = choose_cell_grid(ref_pos.shape[0], 8)
    assert tuple(grid) == tuple(jax_choose_cell_grid(ref_pos.shape[0], 8))
    idx, (ovf, max_d2, excess) = cell_list_knn(
        torch.from_numpy(ref_pos), 8, 1.0, grid, queries=torch.from_numpy(q),
        return_diagnostics=True)
    jidx, (jovf, jmax_d2, jexcess) = jax_cell_list_knn(
        jnp.asarray(ref_pos), 8, 1.0, jax_choose_cell_grid(ref_pos.shape[0], 8),
        queries=jnp.asarray(q), return_diagnostics=True)
    _sets_equal(idx.numpy(), np.asarray(jidx))
    assert int(ovf) == int(jovf)
    _close_ulps(max_d2, jmax_d2, jmax_d2)
    _close_ulps(excess, jexcess, (1.5 / grid.grid_size) ** 2)
    assert float(excess) <= 0  # certified: equal to brute force
    _sets_equal(idx.numpy(), knn_periodic_reference(torch.from_numpy(ref_pos), 8, 1.0,
                                                    queries=torch.from_numpy(q)).numpy())


@pytest.mark.parametrize("method", ["auto", "pallas", "celllist", "bruteforce"])
def test_neighbor_search_with_separate_queries_matches_jax(method):
    ref_pos, q = _queries()
    out = neighbor_search(torch.from_numpy(ref_pos), 8, 1.0, queries=torch.from_numpy(q),
                          method=method, with_codes=True)
    ref = jax_neighbor_search(jnp.asarray(ref_pos), 8, 1.0, queries=jnp.asarray(q),
                              method=method, with_codes=True)
    assert out[1:] == (None, None, None) and all(r is None for r in ref[1:])
    _sets_equal(out[0].numpy(), np.asarray(ref[0]))
