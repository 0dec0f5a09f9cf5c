"""The port's hybrid cell-block rollout against the JAX package's with each
plan reused for two steps (R = 2), and the options of the cell-block path
that are refused. Setup, inputs and tolerances are those of
``test_torch_cellblock_rollout.py`` (R = 1), split off to keep each file's
JAX compilations short.
"""

import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    apply_encode_process_decode,
)
from cosmology_gnn_simulation_tpu_torch.ops.cellblock import choose_cellblock_spec
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, ParticleGraph
from test_torch_cellblock_rollout import (
    CASES,
    COORD_ATOL,
    METADATA,
    STEPS,
    _jax_hybrid,
    _port,
    _setup,
)


@pytest.mark.parametrize("case", sorted(CASES))
def test_hybrid_rollout_reusing_plans_matches_jax(case, monkeypatch):
    dtype, fused = CASES[case]
    jcfg, tcfg, jparams, tparams, pos, temp = _setup(seed=2)
    ref = _jax_hybrid(jparams, jcfg, pos, temp, dtype, fused, 2, monkeypatch)
    out = _port(tparams, tcfg, pos, temp, dtype, fused, 2, "cellblock_hybrid")
    np.testing.assert_array_equal(out["neighbor_exactness"].numpy(),
                                  np.asarray(ref["neighbor_exactness"]))
    assert out["neighbor_exactness"].shape == (STEPS,)
    np.testing.assert_allclose(out["Coordinates"].numpy(), np.asarray(ref["Coordinates"]),
                               atol=COORD_ATOL, rtol=0)
    np.testing.assert_allclose(out["InternalEnergy"].numpy(),
                               np.asarray(ref["InternalEnergy"]), atol=COORD_ATOL, rtol=0)


def test_cellblock_options_that_are_refused():
    _, tcfg, _, tparams, pos, temp = _setup()
    stats = NormalizationStats.from_metadata(METADATA, device="cpu")
    kw = dict(aggregation="cellblock_hybrid", device="cpu")
    # The brute-force fallback can exceed the one-cell windows (as in JAX).
    with pytest.raises(ValueError, match="exactness_guard"):
        rollout(tparams, tcfg, pos, temp, stats, 1, exactness_guard="fallback", **kw)
    # Plans from neighbor ids (brute force below 8192 particles with "auto",
    # or a spec on another grid than the k-NN's) are ported; the dense
    # search takes only the uniform cubic layout, as in JAX.
    other = choose_cellblock_spec(pos.shape[1] * 8, 16)
    with pytest.raises(ValueError, match="uniform cubic"):
        rollout(tparams, tcfg, pos, temp, stats, 1, cellblock_search="dense",
                cellblock_spec=other._replace(grid_x=5), **kw)
    with pytest.raises(ValueError, match="cellblock_search"):
        rollout(tparams, tcfg, pos, temp, stats, 1, cellblock_search="nope", **kw)
    # The slot-space carry of the model is ported; a plan needs its spec.
    graph = ParticleGraph(nodes=torch.zeros(8, 17), neighbors=None, edges=None,
                          positions=torch.zeros(8, 3), cellblock=object())
    with pytest.raises(ValueError, match="cellblock_spec"):
        apply_encode_process_decode(tparams, graph, tcfg)
    slots = rollout(tparams, tcfg, pos, temp, stats, 1, **{**kw, "aggregation": "cellblock"})
    hybrid = rollout(tparams, tcfg, pos, temp, stats, 1, **kw)
    np.testing.assert_allclose(slots["Coordinates"].numpy(), hybrid["Coordinates"].numpy(),
                               atol=COORD_ATOL, rtol=0)
