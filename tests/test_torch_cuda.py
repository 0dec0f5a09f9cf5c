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
"""

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
    fused_step_tail_reference,
)
from cosmology_gnn_simulation_tpu_torch.ops.neighbors import knn_periodic
from cosmology_gnn_simulation_tpu_torch.ops.pallas_knn import (
    codes_packing_cap,
    pallas_cell_list_knn,
)
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_map

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
    assert kernels.launches == {"knn_select": 0, "knn_codes": 2, "s_decode": 2,
                                "s_onehot": 2, "window_matmul": 4, "fused_tail": 4}
    assert bool(gpu["neighbor_exactness"].all())
    np.testing.assert_array_equal(gpu["neighbor_exactness"].cpu().numpy(),
                                  cpu["neighbor_exactness"].numpy())
    np.testing.assert_allclose(gpu["Coordinates"].cpu().numpy(),
                               cpu["Coordinates"].numpy(), atol=1e-5, rtol=0)
