"""The cell-block training path of the port held against the JAX package:
the plan's reverse table (the plain path of kernel K7), the window matmul's
S^T mode (the plain path of K4^T), the hybrid aggregation's gradient, and
one hybrid train step.

The JAX Pallas kernels run in interpret mode. The plan with its reverse
table is integer arithmetic: S, S_rev, ``reverse_mismatch``,
``dropped_edges`` and ``overflow`` must be bit-equal to JAX
``build_cellblock(..., with_reverse=True, s_build="kernel")`` on the frames
of ``test_torch_cellblock.py``. The S^T products are exact on both sides
(int8 counts times bf16 or f32 values) and only the order of the float32
sums differs: 1e-5 absolute on sums of at most k = 4 O(1) values; a bf16
gradient is then rounded to bf16 on both sides (one bf16 ulp, 2^-8
relative). The train step, as the gather step of ``test_torch_training.py``:
float32 gradients within 3e-5 of each leaf's largest magnitude, bf16 with
the fused tail within 2e-2; its ``cellblock_violations`` 0 on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosmology_gnn_simulation_tpu.ops.pallas_knn as jax_pallas_knn
from cosmology_gnn_simulation_tpu.ops import cellblock as jcb
from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.ops import cellblock
from test_torch_cellblock import FRAMES, PLAN_FIELDS, _frame, _torch_spill
from test_torch_training import (
    _batch,
    _models,
    assert_step_matches,
    jax_step_grads,
    port_step_grads,
)

BF16_ULP = 2.0**-8


@functools.cache
def _reverse_plans(name):
    spec, pos, grid, codes, spill, cap = _frame(name)
    jplan = jcb.build_cellblock(
        jnp.asarray(pos), None, 1.0, jcb.CellBlockSpec(**spec), with_reverse=True,
        s_build="kernel", neighbor_codes=jnp.asarray(codes), codes_cap=cap,
        codes_spill=spill, interpret=True,
    )
    plan = cellblock.build_cellblock(
        torch.from_numpy(pos), None, 1.0, cellblock.CellBlockSpec(**spec), with_reverse=True,
        neighbor_codes=torch.from_numpy(codes), codes_cap=cap,
        codes_spill=_torch_spill(spill),
    )
    return spec, pos, jplan, plan


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_reverse_plan_matches_jax(name):
    spec, _, jplan, plan = _reverse_plans(name)
    for field in PLAN_FIELDS + ("s_rev_table", "reverse_mismatch"):
        want = np.asarray(getattr(jplan, field))
        got = getattr(plan, field).numpy()
        assert got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    tspec = cellblock.CellBlockSpec(**spec)
    assert plan.s_rev_table.dtype == torch.int8
    assert plan.s_rev_table.shape == (tspec.num_tiles, tspec.s_width, tspec.rev_lanes)
    if name != "spill":
        # Every edge of S is in S_rev: the transpose is certified exact.
        assert int(plan.reverse_mismatch) == 0 and int(plan.dropped_edges) == 0
        assert int(plan.s_rev_table.sum(dtype=torch.int64)) == int(
            plan.s_table.sum(dtype=torch.int64)) > 0


def _cotangent(spec, h, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (cellblock.CellBlockSpec(**spec).num_slots, h)).astype(np.float32)


@pytest.mark.parametrize("carry", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["spec", "spec_tiled"])
def test_window_matmul_t_plain_matches_jax(name, carry):
    spec, _, jplan, plan = _reverse_plans(name)
    g = _cotangent(spec, 16, 9)
    want = jcb._window_matmul(
        jplan.s_rev_table, jnp.asarray(g), jplan.pad_src, jplan.window_starts,
        jcb.CellBlockSpec(**spec), jnp.float32, jnp.dtype(carry), True, s_rev3=True,
    )
    tspec = cellblock.CellBlockSpec(**spec)
    g_pad = cellblock._pad_candidates(torch.from_numpy(g), plan.pad_src, getattr(torch, carry))
    got = cellblock.window_matmul_t(plan.s_rev_table, g_pad, plan.window_starts, spec=tspec)
    assert torch.equal(got, cellblock.window_matmul_t_reference(
        plan.s_rev_table, g_pad, plan.window_starts, spec=tspec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("carry", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["spec", "spec_tiled"])
def test_hybrid_aggregate_gradient_matches_jax(name, carry):
    spec, pos, jplan, plan = _reverse_plans(name)
    rng = np.random.default_rng(10)
    z = rng.normal(0, 1, (pos.shape[0], 16)).astype(np.float32)
    ct = rng.normal(0, 1, (pos.shape[0], 16)).astype(np.float32)
    jspec = jcb.CellBlockSpec(**spec)
    out, vjp = jax.vjp(lambda z: jcb.cellblock_aggregate(
        z, jplan, jspec, carry_dtype=jnp.dtype(carry), interpret=True), jnp.asarray(z))
    (want,) = vjp(jnp.asarray(ct))
    tz = torch.from_numpy(z).requires_grad_(True)
    tout = cellblock.cellblock_aggregate(tz, plan, cellblock.CellBlockSpec(**spec),
                                         carry_dtype=getattr(torch, carry))
    (got,) = torch.autograd.grad(tout, tz, torch.from_numpy(ct))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), atol=1e-5, rtol=0)
    # The gradient is the transpose applied to the cotangent: the gather-sum
    # oracle's gradient, a scatter of ct over each receiver's neighbors.
    atol = 1e-5 if carry == "float32" else BF16_ULP * float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=atol, rtol=0)


def test_hybrid_backward_needs_the_reverse_table():
    spec, pos, _, _ = _reverse_plans("spec")
    _, _, grid, codes, spill, cap = _frame("spec")
    plan = cellblock.build_cellblock(
        torch.from_numpy(pos), None, 1.0, cellblock.CellBlockSpec(**spec),
        neighbor_codes=torch.from_numpy(codes), codes_cap=cap, codes_spill=_torch_spill(spill))
    assert plan.s_rev_table is None and plan.reverse_mismatch is None
    z = torch.randn(pos.shape[0], 16, requires_grad=True)
    out = cellblock.cellblock_aggregate(z, plan, cellblock.CellBlockSpec(**spec),
                                        carry_dtype=torch.float32)
    with pytest.raises(ValueError, match="with_reverse=True"):
        out.sum().backward()


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_hybrid_train_step_matches_jax(dtype, monkeypatch):
    monkeypatch.setattr(
        jax_pallas_knn, "pallas_cell_list_knn",
        functools.partial(jax_pallas_knn.pallas_cell_list_knn, interpret=True),
    )
    jcfg, tcfg, jparams = _models(seed=2)
    batch = _batch(4096, 7)
    tc = dict(aggregation="cellblock_hybrid", neighbor_method="pallas", compute_dtype=dtype,
              fused_tail=dtype is not None, augment_prob=0.0, noise_std=0.0)
    jmetrics, jgrads = jax_step_grads(jcfg, jparams, batch, **tc)
    kernels.reset_launches()
    metrics, grads = port_step_grads(tcfg, jparams, batch, **tc)
    assert not any(kernels.launches.values())  # the CPU runs the plain versions
    assert float(metrics["cellblock_violations"]) == float(jmetrics["cellblock_violations"]) == 0
    assert_step_matches(metrics, grads, jmetrics, jgrads, dtype)
