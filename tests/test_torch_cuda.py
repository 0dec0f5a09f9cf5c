"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
file imports no JAX, so it runs on a machine that has none:

    python -m pytest -o addopts='' --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 and its codes mode K1' are exact (equal neighbor ids or
codes, bit-equal k-th distances and certificate); so are K2 and K3 (integer
arithmetic: equal offsets, dropped counts and S tables). K4's products are
exact (int8 counts times bf16) and only its float32 sums run in another
order on the tensor cores: 1e-3 absolute, 1e-5 mean, on sums of at most 16
N(0, 1) values. K5 sums on tensor cores in another order than the plain
version's f32 matmul, and a last-bit difference can flip the bf16 rounding
of an intermediate before the next product: 5e-2 absolute, 2e-3 mean.
K7 is exact (integer counts: equal tables, reverse_mismatch 0); K4^T as K4.
K6 rounds its operands to bf16 where its plain version does, and sums in
another order (its weight gradients over 65,536 rows). A last-bit
difference can also flip a ReLU mask where a pre-activation is within
rounding of 0 (a handful of the 8.4 M entries at N = 65,536), which moves
that entry of dagg by O(1): each output has at most 1e-5 of its entries off
by more than 1e-2 of its largest magnitude, and a mean error within 1e-3 of
its mean magnitude, against the plain version; against autograd through
the plain forward, which rounds the gradients to bf16 at other places,
3e-2 and 1e-2. The train steps: loss within 1e-3 relative and every
gradient within 3e-2 of its leaf's largest magnitude against the CPU plain
path (bf16 operands, summation order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    default_model_config,
    init_encode_process_decode,
)
from cosmology_gnn_simulation_tpu_torch.models.mlp import init_mlp
from cosmology_gnn_simulation_tpu_torch.ops import cellblock, pallas_knn
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import CellGrid, choose_cell_grid
from cosmology_gnn_simulation_tpu_torch.ops.fused_step import (
    fused_step_tail,
    fused_step_tail_bwd,
    fused_step_tail_bwd_reference,
    fused_step_tail_reference,
)
from cosmology_gnn_simulation_tpu_torch.ops.neighbors import knn_periodic
from cosmology_gnn_simulation_tpu_torch.ops.pallas_knn import (
    codes_packing_cap,
    pallas_cell_list_knn,
)
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.training import TrainConfig, make_train_step
from cosmology_gnn_simulation_tpu_torch.training.trainer import Optimizer
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves, tree_map

METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": 1.0, "dt": 0.05,
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    return torch.device("cuda")


def _spill_positions(seed=1234):
    rng = np.random.default_rng(seed)
    bg = rng.uniform(0, 1, (2048, 3))
    cram = 0.44 + 0.04 * rng.uniform(0, 1, (40, 3))
    return torch.tensor(np.concatenate([bg, cram]), dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "spill"])
def test_knn_kernel_matches_plain_version(cuda_device, case):
    if case == "spill":
        pos, k, grid = _spill_positions(), 8, CellGrid(8, 16)
    else:
        pos = torch.rand(20000, 3, generator=torch.Generator().manual_seed(0))
        k = 16
        grid = choose_cell_grid(pos.shape[0], k)
    idx, diag = pallas_cell_list_knn(pos.to(cuda_device), k, 1.0, grid,
                                     return_diagnostics=True)
    cidx, cdiag = pallas_cell_list_knn(pos, k, 1.0, grid, return_diagnostics=True)
    torch.cuda.synchronize()
    assert torch.equal(idx.cpu(), cidx)
    for a, b in zip(diag, cdiag):
        assert torch.equal(a.cpu(), b)
    ref = knn_periodic(pos.to(cuda_device), k, 1.0)
    assert all(set(a) == set(b) for a, b in zip(idx.tolist(), ref.tolist()))


def _codes_case(case):
    if case == "spill":
        return _spill_positions(), 8, CellGrid(8, 16)
    pos = torch.rand(20000, 3, generator=torch.Generator().manual_seed(0))
    return pos, 16, choose_cell_grid(pos.shape[0], 16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "spill"])
def test_knn_codes_kernel_matches_plain_version(cuda_device, case):
    pos, k, grid = _codes_case(case)
    n = pos.shape[0]
    dpos = pos.to(cuda_device)
    cap, _, spill_cap = pallas_knn.spill_layout(n, k, grid)
    box = torch.tensor(1.0, device=cuda_device)
    t = pallas_knn.build_table(dpos, grid.grid_size, cap, box)
    spill = pallas_knn.build_spill(dpos, t.particle_rank, cap, spill_cap)
    args = dict(k=k, n=n, g=grid.grid_size, box=box,
                mi_start=pallas_knn.min_image_start(cap, spill_cap))
    planes = (t.x, t.y, t.z, t.ids)
    kernels.reset_launches()
    codes, kth = pallas_knn.knn_codes(planes, spill, **args)
    ref_codes, ref_kth = pallas_knn.knn_codes_reference(planes, spill, **args)
    torch.cuda.synchronize()
    assert kernels.launches["knn_codes"] == 1
    assert torch.equal(codes, ref_codes)
    assert torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32))
    # The whole codes_only search, card against CPU.
    out = pallas_cell_list_knn(dpos, k, 1.0, grid, return_diagnostics=True, codes_only=True)
    cpu = pallas_cell_list_knn(pos, k, 1.0, grid, return_diagnostics=True, codes_only=True)
    assert out[0] is None and torch.equal(out[1].cpu(), cpu[1])
    for a, b in zip(out[3], cpu[3]):
        assert torch.equal(a.cpu(), b)


def _decode_inputs(device, cram=0):
    """K2's inputs at the flagship spec (N = 65,536, k = 16) on ``device``;
    ``cram`` particles packed into one cell make the k-NN spill."""
    n, k = 65536, 16
    pos = torch.rand(n, 3, generator=torch.Generator().manual_seed(4))
    if cram:
        pos[:cram] = 0.51 + 0.01 * pos[:cram]
    pos = pos.to(device)
    grid = choose_cell_grid(n, k)
    spec = cellblock.choose_cellblock_spec(n, k)
    _, codes, spill = pallas_cell_list_knn(pos, k, 1.0, grid, codes_only=True)
    layout = cellblock.cellblock_layout(pos, 1.0, spec)
    cap = codes_packing_cap(n, k, grid)
    return spec, cap, layout, cellblock.s_decode_inputs(layout, codes, cap, spill, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("cram", [0, 60])
def test_s_decode_and_onehot_kernels_match_plain_versions(cuda_device, cram):
    spec, cap, _, inputs = _decode_inputs(cuda_device, cram)
    kernels.reset_launches()
    offsets = cellblock.s_decode(*inputs, spec=spec, codes_cap=cap)
    ref = cellblock.s_decode_reference(*inputs, spec=spec, codes_cap=cap)
    s_table = cellblock.s_onehot(offsets, width=spec.s_width)
    ref_s = cellblock.s_onehot_reference(offsets, width=spec.s_width)
    torch.cuda.synchronize()
    assert kernels.launches["s_decode"] == 1 and kernels.launches["s_onehot"] == 1
    assert torch.equal(offsets, ref)
    assert torch.equal(s_table, ref_s)
    assert int(s_table.sum(dtype=torch.int64)) == int((offsets < spec.s_width).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["flagship", "small"])
def test_window_matmul_kernel_matches_plain_version(cuda_device, shape):
    gen = torch.Generator().manual_seed(5)
    if shape == "flagship":
        spec, _, layout, inputs = _decode_inputs(cuda_device)
        cap = codes_packing_cap(65536, 16, choose_cell_grid(65536, 16))
        s_table = cellblock.s_onehot(cellblock.s_decode(*inputs, spec=spec, codes_cap=cap),
                                     width=spec.s_width)
        starts, h = layout.window_starts, 128
    else:
        # The JAX tests' SPEC: QB 32, W 96 (a partial 64-row stage), H 16.
        spec = cellblock.CellBlockSpec(grid_size=4, col_capacity=32, query_block=32,
                                       window=96, wrap_cap=32, h_block=128)
        s_table = torch.randint(0, 3, (spec.num_slots, spec.s_width), generator=gen,
                                dtype=torch.int8).to(cuda_device)
        starts = (torch.randint(0, spec.padded_col - spec.window + 1,
                                (spec.num_tiles, 9), generator=gen)
                  + torch.arange(9) * spec.padded_col).to(torch.int32).to(cuda_device)
        h = 16
    z_pad = torch.randn(spec.num_padded, h, generator=gen).bfloat16().to(cuda_device)
    kernels.reset_launches()
    out = cellblock.window_matmul(s_table, z_pad, starts, spec=spec)
    ref = cellblock.window_matmul_reference(s_table, z_pad, starts, spec=spec)
    torch.cuda.synchronize()
    assert kernels.launches["window_matmul"] == 1
    err = (out - ref).abs()
    assert float(err.max()) <= 1e-3 and float(err.mean()) <= 1e-5, (
        float(err.max()), float(err.mean()))


def _tail_inputs(n, latent, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    node = init_mlp(gen, 2 * latent, latent, 2, latent, layer_norm=True)
    node["ln"] = {"scale": torch.rand(latent, generator=gen) + 0.5,
                  "bias": torch.randn(latent, generator=gen) * 0.1}
    node = tree_map(lambda t: t.to(device), node)
    x = torch.randn(n, latent, generator=gen).to(device)
    agg = torch.randn(n, latent, generator=gen).bfloat16().to(device)
    return x, agg, node


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 4099, 65536])
def test_fused_tail_kernel_matches_plain_version(cuda_device, n):
    x, agg, node = _tail_inputs(n, 128, cuda_device)
    out = fused_step_tail(x, agg, node)
    ref = fused_step_tail_reference(x, agg, node)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    assert float(err.max()) <= 5e-2 and float(err.mean()) <= 2e-3, (
        float(err.max()), float(err.mean()))


@pytest.mark.cuda
def test_fused_tail_kernel_takes_f32_agg(cuda_device):
    """The cell-block path hands K5 K4's float32 sums."""
    x, agg, node = _tail_inputs(65536, 128, cuda_device)
    agg = agg.float() + 1e-3 * torch.randn_like(agg.float())
    out = fused_step_tail(x, agg, node)
    ref = fused_step_tail_reference(x, agg, node)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    assert float(err.max()) <= 5e-2 and float(err.mean()) <= 2e-3, (
        float(err.max()), float(err.mean()))


@pytest.mark.cuda
def test_fused_tail_kernel_rejects_other_layouts(cuda_device):
    x, agg, node = _tail_inputs(64, 32, cuda_device)
    with pytest.raises(ValueError, match="latent = hidden = 128"):
        fused_step_tail(x, agg, node)
    x, agg, node = _tail_inputs(64, 128, cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        fused_step_tail(x, agg, node, dtype=torch.float32)


@pytest.mark.cuda
def test_rollout_on_the_card_goes_through_both_kernels(cuda_device):
    cfg = default_model_config(num_message_passing_steps=2)
    params_cpu = init_encode_process_decode(cfg, torch.Generator().manual_seed(0),
                                            device="cpu")
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(0),
                                        device=cuda_device)
    rng = np.random.default_rng(0)
    n = 8192
    pos = np.remainder(rng.uniform(0, 1, (1, n, 3))
                       + rng.normal(0, 5e-4, (5, n, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (5, n, 1))).astype(np.float32)
    kw = dict(num_neighbors=16, dtype=torch.bfloat16)
    cpu = rollout(params_cpu, cfg, pos, temp,
                  NormalizationStats.from_metadata(METADATA, device="cpu"), 2,
                  fused_tail=True, device="cpu", **kw)
    kernels.reset_launches()
    gpu = rollout(params, cfg, pos, temp,
                  NormalizationStats.from_metadata(METADATA, device=cuda_device), 2,
                  device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert kernels.launches == {**dict.fromkeys(kernels.KERNELS, 0),
                                "knn_select": 2, "fused_tail": 4}
    assert bool(gpu["neighbor_exactness"].all())
    np.testing.assert_allclose(gpu["Coordinates"].cpu().numpy(),
                               cpu["Coordinates"].numpy(), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_hybrid_rollout_on_the_card_goes_through_its_kernels(cuda_device):
    cfg = default_model_config(num_message_passing_steps=2)
    params_cpu = init_encode_process_decode(cfg, torch.Generator().manual_seed(0),
                                            device="cpu")
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(0),
                                        device=cuda_device)
    rng = np.random.default_rng(1)
    n = 8192
    pos = np.remainder(rng.uniform(0, 1, (1, n, 3))
                       + rng.normal(0, 5e-4, (5, n, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (5, n, 1))).astype(np.float32)
    kw = dict(num_neighbors=16, dtype=torch.bfloat16, aggregation="cellblock_hybrid")
    cpu = rollout(params_cpu, cfg, pos, temp,
                  NormalizationStats.from_metadata(METADATA, device="cpu"), 2,
                  fused_tail=True, device="cpu", **kw)
    kernels.reset_launches()
    gpu = rollout(params, cfg, pos, temp,
                  NormalizationStats.from_metadata(METADATA, device=cuda_device), 2,
                  device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert kernels.launches == {**dict.fromkeys(kernels.KERNELS, 0), "knn_codes": 2,
                                "s_decode": 2, "s_onehot": 2, "window_matmul": 4,
                                "fused_tail": 4}
    assert bool(gpu["neighbor_exactness"].all())
    np.testing.assert_array_equal(gpu["neighbor_exactness"].cpu().numpy(),
                                  cpu["neighbor_exactness"].numpy())
    np.testing.assert_allclose(gpu["Coordinates"].cpu().numpy(),
                               cpu["Coordinates"].numpy(), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("codes_only", [False, True])
def test_knn_kernel_takes_k_48(cuda_device, codes_only):
    """k above the old register cap of 32 runs K1 (the KT = 64 list)."""
    pos = torch.rand(20000, 3, generator=torch.Generator().manual_seed(6))
    k = 48
    grid = choose_cell_grid(pos.shape[0], k)
    kernels.reset_launches()
    out = pallas_cell_list_knn(pos.to(cuda_device), k, 1.0, grid, return_diagnostics=True,
                               codes_only=codes_only)
    cpu = pallas_cell_list_knn(pos, k, 1.0, grid, return_diagnostics=True,
                               codes_only=codes_only)
    torch.cuda.synchronize()
    assert kernels.launches["knn_codes" if codes_only else "knn_select"] == 1
    picks, cpicks = (out[1], cpu[1]) if codes_only else (out[0], cpu[0])
    assert torch.equal(picks.cpu(), cpicks)
    for a, b in zip(out[-1], cpu[-1]):
        assert torch.equal(a.cpu(), b)
    assert float(out[-1][2]) <= 0 and int(out[-1][0]) == 0  # certified


def _close(a, b, rel):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    assert err <= rel * scale, (err, scale)


def _mostly_close(a, b, rel, mean_rel):
    """At most 1e-5 of the entries off by more than ``rel`` of the largest
    magnitude (ReLU mask flips), mean error within ``mean_rel`` of the
    mean magnitude."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    err = (a - b).abs()
    off = int((err > rel * float(b.abs().max())).sum())
    assert off <= 1e-5 * b.numel(), (off, float(err.max()), float(b.abs().max()))
    assert float(err.mean()) <= mean_rel * float(b.abs().mean()), (
        float(err.mean()), float(b.abs().mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("agg_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [4099, 65536])
def test_fused_tail_bwd_kernel_matches_plain_version(cuda_device, agg_dtype, n):
    x, agg, node = _tail_inputs(n, 128, cuda_device)
    agg = agg.to(getattr(torch, agg_dtype))
    g = torch.randn(n, 128, generator=torch.Generator().manual_seed(7)).to(cuda_device)
    kernels.reset_launches()
    dx, dagg, grads = fused_step_tail_bwd(x, agg, g, node)
    ref_dx, ref_dagg, ref_grads = fused_step_tail_bwd_reference(x, agg, g, node)
    torch.cuda.synchronize()
    assert kernels.launches["fused_tail_bwd"] == 1
    assert dx.dtype == torch.float32 and dagg.dtype == agg.dtype
    for a, b in zip([dx, dagg, *grads], [ref_dx, ref_dagg, *ref_grads]):
        assert a.shape == b.shape
        _mostly_close(a, b, 1e-2, 1e-3)
    # Against autograd through the plain forward.
    leaves = [x, agg.float(), *[t for t in tree_leaves(node)]]
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    tnode = {"layers": tuple({"w": leaves[2 + 2 * i], "b": leaves[3 + 2 * i]} for i in range(3)),
             "ln": {"scale": leaves[8], "bias": leaves[9]}}
    out = fused_step_tail_reference(leaves[0], leaves[1], tnode)
    auto = torch.autograd.grad(out, leaves, g)
    mine = [dx, dagg, grads[0], *grads[1:]]
    theirs = [auto[0], auto[1], auto[2][:128], *auto[3:]]  # w_self rows of layer 0
    for a, b in zip(mine, theirs):
        _mostly_close(a, b, 3e-2, 1e-2)


def _reverse_inputs(device, cram):
    spec, cap, layout, _ = _decode_inputs(device, cram)
    n, k = 65536, 16
    pos = torch.rand(n, 3, generator=torch.Generator().manual_seed(4))
    if cram:
        pos[:cram] = 0.51 + 0.01 * pos[:cram]
    _, codes, spill = pallas_cell_list_knn(pos.to(device), k, 1.0, choose_cell_grid(n, k),
                                           codes_only=True)
    sc = cellblock.slot_codes(layout, codes, cap, spill, spec)
    packed = cellblock.reverse_candidates(cellblock.sender_packs(sc, cap, spec), layout, spec)
    return spec, cap, layout, packed, pos.to(device), codes, spill


@pytest.mark.cuda
@pytest.mark.parametrize("cram", [0, 60])
def test_reverse_table_kernel_matches_plain_version(cuda_device, cram):
    spec, cap, layout, packed, pos, codes, spill = _reverse_inputs(cuda_device, cram)
    kernels.reset_launches()
    s_rev = cellblock.reverse_table(packed, layout.window_starts, spec=spec)
    ref = cellblock.reverse_table_reference(packed, layout.window_starts, spec=spec)
    torch.cuda.synchronize()
    assert kernels.launches["reverse_table"] == 1
    assert torch.equal(s_rev, ref)
    plan = cellblock.build_cellblock(pos, None, 1.0, spec, with_reverse=True,
                                     neighbor_codes=codes, codes_cap=cap, codes_spill=spill)
    assert torch.equal(plan.s_rev_table, s_rev)
    assert int(plan.reverse_mismatch) == 0


@pytest.mark.cuda
def test_window_matmul_t_kernel_matches_plain_version(cuda_device):
    spec, _, layout, packed, _, _, _ = _reverse_inputs(cuda_device, 0)
    s_rev = cellblock.reverse_table(packed, layout.window_starts, spec=spec)
    g_pad = torch.randn(spec.num_padded, 128,
                        generator=torch.Generator().manual_seed(8)).bfloat16().to(cuda_device)
    kernels.reset_launches()
    out = cellblock.window_matmul_t(s_rev, g_pad, layout.window_starts, spec=spec)
    ref = cellblock.window_matmul_t_reference(s_rev, g_pad, layout.window_starts, spec=spec)
    torch.cuda.synchronize()
    assert kernels.launches["window_matmul_t"] == 1
    err = (out - ref).abs()
    assert float(err.max()) <= 1e-3 and float(err.mean()) <= 1e-5, (
        float(err.max()), float(err.mean()))


@pytest.mark.cuda
def test_latent_32_bf16_rollout_runs_on_the_card(cuda_device):
    """fused_tail=None resolves to off where K5 refuses the shape."""
    cfg = default_model_config(latent_size=32, mlp_hidden_size=32, num_message_passing_steps=2)
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(0),
                                        device=cuda_device)
    rng = np.random.default_rng(2)
    n = 8192
    pos = np.remainder(rng.uniform(0, 1, (1, n, 3))
                       + rng.normal(0, 5e-4, (5, n, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (5, n, 1))).astype(np.float32)
    kernels.reset_launches()
    out = rollout(params, cfg, pos, temp,
                  NormalizationStats.from_metadata(METADATA, device=cuda_device), 2,
                  num_neighbors=16, dtype=torch.bfloat16, device=cuda_device)
    torch.cuda.synchronize()
    assert kernels.launches["fused_tail"] == 0 and kernels.launches["knn_select"] == 2
    assert bool(torch.isfinite(out["Coordinates"]).all())
    with pytest.raises(ValueError, match="latent = hidden = 128"):
        rollout(params, cfg, pos, temp,
                NormalizationStats.from_metadata(METADATA, device=cuda_device), 1,
                num_neighbors=16, dtype=torch.bfloat16, fused_tail=True, device=cuda_device)


def _train_batch(n, seed):
    rng = np.random.default_rng(seed)
    pos = np.remainder(rng.uniform(0, 1, (1, n, 3))
                       + rng.normal(0, 5e-4, (6, n, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = (1.0 + rng.normal(0, 1e-3, (6, n, 1)).cumsum(0)).astype(np.float32)
    return {"positions": pos[None, :5], "temperatures": temp[None, :5],
            "target_positions": pos[None, 5], "target_temperatures": temp[None, 5]}


def _sgd_grads(params_before, params_after):
    return [b - a.detach() for b, a in zip(params_before, tree_leaves(params_after))]


@pytest.mark.cuda
@pytest.mark.parametrize("aggregation", ["gather", "cellblock_hybrid"])
def test_train_step_on_the_card_goes_through_its_kernels(cuda_device, aggregation):
    cfg = default_model_config(num_message_passing_steps=2)
    batch = _train_batch(8192, 3)
    tc = TrainConfig(aggregation=aggregation, compute_dtype="bfloat16", augment_prob=0.0,
                     noise_std=0.0)
    sgd = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
    runs = {}
    for dev in ("cpu", cuda_device):
        params = init_encode_process_decode(cfg, torch.Generator().manual_seed(0), device=dev)
        before = [t.detach().clone() for t in tree_leaves(params)]
        # The card resolves fused_tail=None to on (K5, K6); the CPU runs
        # their plain versions.
        dtc = dataclasses.replace(tc, fused_tail=True) if dev == "cpu" else tc
        step = make_train_step(cfg, NormalizationStats.from_metadata(METADATA, device=dev),
                               dtc, sgd)
        kernels.reset_launches()
        params, _, metrics = step(params, sgd.init(params), batch, torch.Generator(device=dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
        runs[str(dev)] = (float(metrics["loss"]), _sgd_grads(before, params),
                          metrics)
    expected = ({"knn_select": 1, "fused_tail": 2, "fused_tail_bwd": 2}
                if aggregation == "gather" else
                {"knn_codes": 1, "s_decode": 1, "s_onehot": 1, "reverse_table": 1,
                 "window_matmul": 2, "window_matmul_t": 2, "fused_tail": 2,
                 "fused_tail_bwd": 2})
    assert launches == {**dict.fromkeys(kernels.KERNELS, 0), **expected}
    (cpu_loss, cpu_grads, _), (loss, grads, metrics) = runs["cpu"], runs[str(cuda_device)]
    assert np.isfinite(loss) and abs(loss - cpu_loss) <= 1e-3 * abs(cpu_loss)
    if aggregation == "cellblock_hybrid":
        assert float(metrics["cellblock_violations"]) == 0
    for mine, theirs in zip(grads, cpu_grads):
        scale = float(theirs.abs().max())
        if scale:
            _close(mine, theirs, 3e-2)
