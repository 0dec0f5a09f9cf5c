"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
file imports no JAX, so it runs on a machine that has none:

    python -m pytest -o addopts='' --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 is exact (equal neighbor ids, bit-equal k-th distances and
certificate). K5 sums on tensor cores in another order than the plain
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
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import CellGrid, choose_cell_grid
from cosmology_gnn_simulation_tpu_torch.ops.fused_step import (
    fused_step_tail,
    fused_step_tail_reference,
)
from cosmology_gnn_simulation_tpu_torch.ops.neighbors import knn_periodic
from cosmology_gnn_simulation_tpu_torch.ops.pallas_knn import pallas_cell_list_knn
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
    assert kernels.launches == {"knn_select": 2, "fused_tail": 4}
    assert bool(gpu["neighbor_exactness"].all())
    np.testing.assert_allclose(gpu["Coordinates"].cpu().numpy(),
                               cpu["Coordinates"].numpy(), atol=1e-5, rtol=0)
