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
K7 is exact (integer counts: equal tables and totals); K4^T as K4. K2, K3
(with and without its count) and K7 run at the flagship spec on a uniform
frame, a spill frame and the two clustered frames where the certificate is
false, on the aux spec, two small edge specs and two wide ones (rev_lanes
384 and 640: K7's generic row width); K1's modes and K8 on the clustered
frames too.
K1'' (ids and codes together) and K8 (the dense-query search) are exact:
equal ids, codes and lanes, bit-equal k-th distances, equal plans and
certificates. K9 (the brute-force k-NN gated on the device) is exact too:
equal ids and bit-equal squared distances, and a set gate leaves its
output buffers bit for bit.
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
from cosmology_gnn_simulation_tpu_torch.ops.neighbors import (
    knn_periodic,
    knn_periodic_reference,
)
from cosmology_gnn_simulation_tpu_torch.ops.pallas_knn import (
    codes_packing_cap,
    pallas_cell_list_knn,
)
from cosmology_gnn_simulation_tpu_torch.rollout import one_step_prediction, rollout
from cosmology_gnn_simulation_tpu_torch.training import TrainConfig, make_train_step
from cosmology_gnn_simulation_tpu_torch.training.trainer import Optimizer
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves, tree_map
from test_torch_knn_select_schedule import CLUSTERED, clustered_positions
from test_torch_reverse_mismatch import drop_one_edge

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


_KNN_CASES = ["uniform", "spill", "lattice", *CLUSTERED]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _KNN_CASES)
def test_knn_kernel_matches_plain_version(cuda_device, case):
    pos, k, grid = _codes_case(case)
    idx, diag = pallas_cell_list_knn(pos.to(cuda_device), k, 1.0, grid,
                                     return_diagnostics=True)
    cidx, cdiag = pallas_cell_list_knn(pos, k, 1.0, grid, return_diagnostics=True)
    torch.cuda.synchronize()
    assert torch.equal(idx.cpu(), cidx)
    for a, b in zip(diag, cdiag):
        assert torch.equal(a.cpu(), b)
    if case in CLUSTERED:  # uncertified: the spill block overflows
        assert int(diag[0]) > 0
    elif case != "lattice":  # ties: brute force may pick another equal-distance set
        ref = knn_periodic_reference(pos.to(cuda_device), k, 1.0)
        assert all(set(a) == set(b) for a, b in zip(idx.tolist(), ref.tolist()))


def _codes_case(case):
    """(positions, k, grid): uniform; a cell crammed past capacity (spill);
    the uniform frame on the 2^-10 lattice (many exactly equal distances);
    the clustered frames at N = 65,536 (spill block overflowing, rows short
    of k candidates)."""
    if case in CLUSTERED:
        n = 65536
        return torch.from_numpy(clustered_positions(n, case)), 16, choose_cell_grid(n, 16)
    if case == "spill":
        return _spill_positions(), 8, CellGrid(8, 16)
    pos = torch.rand(20000, 3, generator=torch.Generator().manual_seed(0))
    if case == "lattice":
        pos = torch.remainder(torch.round(pos * 1024) / 1024, 1.0)
    return pos, 16, choose_cell_grid(pos.shape[0], 16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _KNN_CASES)
def test_knn_codes_kernel_matches_plain_version(cuda_device, case):
    pos, k, grid = _codes_case(case)
    n = pos.shape[0]
    dpos = pos.to(cuda_device)
    cap, _, spill_cap = pallas_knn.spill_layout(n, k, grid)
    box = torch.tensor(1.0, device=cuda_device)
    t = pallas_knn.build_table(dpos, grid.grid_size, cap, box)
    spill = pallas_knn.build_spill(dpos, t.particle_rank, cap, spill_cap)
    # The kernel takes the box as a host number, the plain version as f32.
    args = dict(k=k, n=n, g=grid.grid_size, mi_start=pallas_knn.min_image_start(cap, spill_cap))
    planes = (t.x, t.y, t.z, t.ids)
    kernels.reset_launches()
    codes, kth = pallas_knn.knn_codes(planes, spill, box=1.0, **args)
    ref_codes, ref_kth = pallas_knn.knn_codes_reference(planes, spill, box=box, **args)
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


# The plan kernels' cases (K2, K3, K7): name -> (particles, k, spec): None
# for the chooser's spec of (n, k), "aux" for the chooser's spec of n alone
# (grid 14), a _WINDOW_SPECS name, or CellBlockSpec keywords. The k-NN runs
# on the spec's grid (K1' codes decode only there).
_PLAN_CASES = {
    "flagship": (65536, 16, None),
    "spill": (65536, 16, None),  # 60 particles crammed into one cell
    "clustered95": (65536, 16, None),
    "clustered30": (65536, 16, None),
    "aux": (65536, 16, "aux"),
    "small": (300, 8, "small"),  # QB 32, W 96
    "w8": (200, 12, "w8"),  # W 8, rev_lanes 128; k 12 takes K2's generic path
    # rev_lanes 384 and 640: K7's generic row width (a warp a row, in passes).
    "qb288": (2000, 16, dict(grid_size=3, col_capacity=288, query_block=288, window=384,
                             wrap_cap=48)),
    "qb544": (3000, 16, dict(grid_size=3, col_capacity=544, query_block=544, window=640,
                             wrap_cap=48)),
    # The variable layout (the chooser's variable spec): tiles take their
    # column from the prefixes, windows can reach past their column's span;
    # on the spill frame, and with a budget of half the particles (columns
    # past it own no slots: the overflow counts them).
    "variable": (65536, 16, "variable"),
    "variable_spill": (65536, 16, "variable"),
    "variable_tight": (65536, 16, "variable_tight"),
}

# reverse_mismatch of each case's plan as the plain path builds it on the CPU
# (0 wherever the transpose certificate holds); the card must give the same.
_PLAN_MISMATCH = {"clustered30": 1042, "clustered95": 23, "w8": -22}


def _plan_inputs(case, device, codes_layout="particle"):
    """(spec, codes cap, layout, codes, spill tables, positions) of one
    plan-kernel case on ``device``: particle-order codes, or K1''s
    cell-table codes and the three-element spill info."""
    n, k, spec_name = _PLAN_CASES[case]
    if case in CLUSTERED:
        pos = torch.from_numpy(clustered_positions(n, case))
    else:
        pos = torch.rand(n, 3, generator=torch.Generator().manual_seed(4))
    if case.endswith("spill"):
        pos[:60] = 0.51 + 0.01 * pos[:60]
    if spec_name is None:
        spec, grid = cellblock.choose_cellblock_spec(n, k), choose_cell_grid(n, k)
    elif isinstance(spec_name, str) and spec_name.startswith("variable"):
        spec, grid = cellblock.choose_cellblock_spec(n, k, variable=True), choose_cell_grid(n, k)
        if spec_name == "variable_tight":
            spec = spec._replace(slot_budget=n // 2 // spec.query_block * spec.query_block)
    else:
        if spec_name == "aux":
            spec = cellblock.choose_cellblock_spec(n)
        else:
            kw = spec_name if isinstance(spec_name, dict) else _WINDOW_SPECS[spec_name][0]
            spec = cellblock.CellBlockSpec(h_block=128, **kw)
        g = spec.grid_size
        grid = CellGrid(g, max(8, -(-2 * n // g**3)))
    pos = pos.to(device)
    _, codes, spill = pallas_cell_list_knn(pos, k, 1.0, grid, codes_only=True,
                                           codes_layout=codes_layout)
    layout = cellblock.cellblock_layout(pos, 1.0, spec)
    return spec, codes_packing_cap(n, k, grid), layout, codes, spill, pos


_TABLE_CASES = ["flagship", "spill", *CLUSTERED, "variable", "variable_spill", "w8"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _TABLE_CASES)
def test_s_decode_on_table_rows_matches_plain_version(cuda_device, case):
    """The table codes layout: K1''s cell-table output and spill picks on
    the card equal the CPU plain path's; K2 reading table rows and the spill
    picks through its row map equals its plain version on the same inputs
    and K2 on the particle-order codes of the same frame (offsets and
    dropped edges)."""
    spec, cap, layout, codes, spill, _ = _plan_inputs(case, cuda_device, "table")
    *_, cpu_codes, cpu_spill, _ = _plan_inputs(case, torch.device("cpu"), "table")
    assert torch.equal(codes.cpu(), cpu_codes)
    assert (spill is None) == (cpu_spill is None)
    for a, b in zip(spill or (), cpu_spill or ()):
        assert torch.equal(a.cpu(), b)
    width = spec.s_width
    kernels.reset_launches()
    offsets, dropped = cellblock.s_decode(codes, spill, layout, spec, cap, "table")
    torch.cuda.synchronize()
    assert kernels.launches["s_decode"] == 1
    ref = cellblock.s_decode_reference(
        *cellblock.s_decode_inputs(layout, codes, cap, spill, spec, "table"), spec=spec,
        codes_cap=cap)
    assert torch.equal(offsets, ref)
    assert int(dropped) == int((ref == width + 1).sum())
    _, pcap, _, pcodes, pspill, _ = _plan_inputs(case, cuda_device)
    p_offsets, p_dropped = cellblock.s_decode(pcodes, pspill, layout, spec, pcap)
    assert torch.equal(offsets, p_offsets) and int(dropped) == int(p_dropped)
    if case.endswith("spill"):
        assert spill is not None and bool((spill[1] < 2**20).any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_s_decode_and_onehot_kernels_match_plain_versions(cuda_device, case):
    """K2 (codes to slots, normalization, neighbor starts and decode in one
    kernel) and K3 with and without its count, against their plain versions
    on the same inputs: offsets, dropped edges, S and its total equal."""
    spec, cap, layout, codes, spill, _ = _plan_inputs(case, cuda_device)
    width = spec.s_width
    kernels.reset_launches()
    offsets, dropped = cellblock.s_decode(codes, spill, layout, spec, cap)
    s_table, s_total = cellblock.s_onehot(offsets, width=width, with_total=True)
    uncounted = cellblock.s_onehot(offsets, width=width)
    ref = cellblock.s_decode_reference(
        *cellblock.s_decode_inputs(layout, codes, cap, spill, spec), spec=spec, codes_cap=cap)
    ref_s = cellblock.s_onehot_reference(offsets, width=width)
    torch.cuda.synchronize()
    assert kernels.launches["s_decode"] == 1 and kernels.launches["s_onehot"] == 2
    assert torch.equal(offsets, ref)
    assert int(dropped) == int((ref == width + 1).sum())
    assert torch.equal(s_table, ref_s) and torch.equal(uncounted, ref_s)
    assert int(s_total) == int(s_table.sum(dtype=torch.int64)) == int((offsets < width).sum())
    if case == "w8":  # windows of 8 rows miss most senders
        assert int(dropped) > 0
    if case in CLUSTERED or case == "variable_tight":  # uncertified: columns overflow
        assert int(layout.overflow) > 0


# Synthetic window-matmul specs on the edges of the kernels' contract, with
# the latent width H: the JAX tests' SPEC (QB 32, W 96: a partial 64-row
# stage; H 16), the aux spec's QB 224 and W 384 with a ragged second
# 128-column block (H 136), W 8 (72-byte S rows, 8-byte copies; H 8), and
# config 4's QB 224, W 384 and H 256 (the persistent kernel's 128-row items:
# a tile of one full and one 96-row slice) and a ragged H 200 that ends
# inside an item's 256 columns. All but "small" hold sparse counts up to 127
# and candidates on a 1/16 lattice, so every sum is exact.
_WINDOW_SPECS = {
    "small": (dict(grid_size=4, col_capacity=32, query_block=32, window=96, wrap_cap=32), 16),
    "h136": (dict(grid_size=3, col_capacity=224, query_block=224, window=384, wrap_cap=80), 136),
    "w8": (dict(grid_size=3, col_capacity=32, query_block=32, window=8, wrap_cap=16), 8),
    "h256": (dict(grid_size=3, col_capacity=224, query_block=224, window=384, wrap_cap=80), 256),
    "h200": (dict(grid_size=3, col_capacity=224, query_block=224, window=384, wrap_cap=80), 200),
}
_WINDOW_SHAPES = ["flagship", "aux", *_WINDOW_SPECS]
# The shapes the persistent kernel takes, whose lattice sums it must match
# bit for bit.
_WINDOW_EXACT = ("h256", "h200")


def _aux_plan(device):
    """The aux route's plan with its reverse table at N = 65,536: the
    chooser's spec without k (grid 14) from K1's neighbor ids (grid 19)."""
    n, k = 65536, 16
    pos = torch.rand(n, 3, generator=torch.Generator().manual_seed(4)).to(device)
    spec = cellblock.choose_cellblock_spec(n)
    ids = pallas_cell_list_knn(pos, k, 1.0, choose_cell_grid(n, k))
    return spec, cellblock.build_cellblock(pos, ids, 1.0, spec, with_reverse=True)


def _window_inputs(shape, device, transpose):
    """(spec, S or with ``transpose`` S_rev, window starts, bf16 candidates)
    of one window-matmul case on ``device``."""
    gen = torch.Generator().manual_seed(5)
    if shape == "flagship":
        spec, cap, layout, codes, spill, _ = _plan_inputs("flagship", device)
        if transpose:
            table, _ = cellblock.reverse_table(_packs(layout, codes, cap, spill, spec), layout,
                                               spec)
            gen = torch.Generator().manual_seed(8)
        else:
            table = cellblock.s_onehot(cellblock.s_decode(codes, spill, layout, spec, cap)[0],
                                       width=spec.s_width)
        starts, h = layout.window_starts, 128
        z_pad = torch.randn(spec.num_padded, h, generator=gen)
    elif shape == "aux":
        spec, plan = _aux_plan(device)
        table = plan.s_rev_table if transpose else plan.s_table
        starts, h = plan.window_starts, 128
        z_pad = torch.randn(spec.num_padded, h, generator=gen)
    else:
        spec_kw, h = _WINDOW_SPECS[shape]
        spec = cellblock.CellBlockSpec(h_block=128, **spec_kw)
        t, w = spec.num_tiles, spec.window
        shape_s = (t, spec.s_width, spec.rev_lanes) if transpose else (spec.num_slots,
                                                                       spec.s_width)
        table = torch.randint(0, 3, shape_s, generator=gen, dtype=torch.int8)
        starts = (torch.randint(0, spec.padded_col - w + 1, (t, 9), generator=gen)
                  + torch.arange(9) * spec.padded_col).to(torch.int32)
        if shape == "small":
            z_pad = torch.randn(spec.num_padded, h, generator=gen)
        else:
            # Sparse counts up to 127 (and, in S_rev, lanes past QB set,
            # which the kernel must ignore); a window at the last legal
            # row; candidates on a 1/16 lattice, so every sum is exact.
            live = torch.rand(shape_s, generator=gen) < 0.02
            table = torch.where(live, torch.randint(1, 128, shape_s, generator=gen,
                                                    dtype=torch.int8), 0).to(torch.int8)
            table.view(-1)[:4] = 127
            starts[-1, -1] = spec.num_padded - w
            z_pad = torch.randint(-64, 65, (spec.num_padded, h), generator=gen) / 16.0
        table, starts = table.to(device), starts.to(device)
    return spec, table, starts, z_pad.bfloat16().to(device)


def _assert_window_close(out, ref):
    err = (out - ref).abs()
    assert float(err.max()) <= 1e-3 and float(err.mean()) <= 1e-5, (
        float(err.max()), float(err.mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _WINDOW_SHAPES)
def test_window_matmul_kernel_matches_plain_version(cuda_device, shape):
    spec, s_table, starts, z_pad = _window_inputs(shape, cuda_device, transpose=False)
    kernels.reset_launches()
    out = cellblock.window_matmul(s_table, z_pad, starts, spec=spec)
    ref = cellblock.window_matmul_reference(s_table, z_pad, starts, spec=spec)
    torch.cuda.synchronize()
    assert kernels.launches["window_matmul"] == 1
    _assert_window_close(out, ref)
    if shape in _WINDOW_EXACT:
        assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose, shape", [
    pytest.param(False, "flagship", id="False"),
    pytest.param(True, "flagship", id="True"),
    *(pytest.param(t, shape, id=f"{shape}-{t}") for shape in _WINDOW_EXACT for t in (False, True)),
])
def test_window_matmul_launches_are_bit_equal(cuda_device, transpose, shape):
    spec, table, starts, z_pad = _window_inputs(shape, cuda_device, transpose)
    fn = cellblock.window_matmul_t if transpose else cellblock.window_matmul
    first = fn(table, z_pad, starts, spec=spec)
    second = fn(table, z_pad, starts, spec=spec)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
def test_window_matmul_rejects_shapes_outside_its_contract(cuda_device, transpose):
    spec = cellblock.CellBlockSpec(grid_size=3, col_capacity=48, query_block=48, window=96,
                                   wrap_cap=32, h_block=128)
    table = torch.zeros((spec.num_tiles, spec.s_width, spec.rev_lanes) if transpose
                        else (spec.num_slots, spec.s_width), dtype=torch.int8,
                        device=cuda_device)
    starts = torch.zeros((spec.num_tiles, 9), dtype=torch.int32, device=cuda_device)
    z_pad = torch.zeros((spec.num_padded, 16), dtype=torch.bfloat16, device=cuda_device)
    fn = cellblock.window_matmul_t if transpose else cellblock.window_matmul
    kernels.reset_launches()
    with pytest.raises(ValueError, match="query_block % 32"):
        fn(table, z_pad, starts, spec=spec)
    with pytest.raises(ValueError, match="H % 8"):
        fn(table, z_pad[:, :12], starts, spec=spec._replace(query_block=32, col_capacity=32))
    assert kernels.launches["window_matmul_t" if transpose else "window_matmul"] == 0


def _tail_inputs(n, latent, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    node = init_mlp(gen, 2 * latent, latent, 2, latent, layer_norm=True)
    node["ln"] = {"scale": torch.rand(latent, generator=gen) + 0.5,
                  "bias": torch.randn(latent, generator=gen) * 0.1}
    node = tree_map(lambda t: t.to(device), node)
    x = torch.randn(n, latent, generator=gen).to(device)
    agg = torch.randn(n, latent, generator=gen).bfloat16().to(device)
    return x, agg, node


# Row counts at the edges of the kernels' 64-row tiles and of a persistent
# grid with fewer tiles than SMs (K5 pairs tiles per block).
_TAIL_ROWS = [1, 16, 63, 64, 65, 4099, 65536]


@pytest.mark.cuda
@pytest.mark.parametrize("agg_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", _TAIL_ROWS)
def test_fused_tail_kernel_matches_plain_version(cuda_device, n, agg_dtype):
    x, agg, node = _tail_inputs(n, 128, cuda_device)
    agg = agg.to(getattr(torch, agg_dtype))
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


def _mostly_close(a, b, rel, mean_rel, off_share=1e-5):
    """At most ``off_share`` of the entries off by more than ``rel`` of the
    largest magnitude (ReLU mask flips), mean error within ``mean_rel`` of
    the mean magnitude."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    err = (a - b).abs()
    off = int((err > rel * float(b.abs().max())).sum())
    assert off <= off_share * b.numel(), (off, float(err.max()), float(b.abs().max()))
    assert float(err.mean()) <= mean_rel * float(b.abs().mean()), (
        float(err.mean()), float(b.abs().mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("agg_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [n for n in _TAIL_ROWS if n != 16])
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


@pytest.mark.cuda
@pytest.mark.parametrize("agg_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [4099, 65536])
def test_fused_tail_bwd_launches_are_bit_equal(cuda_device, agg_dtype, n):
    """The blocks' weight-gradient partials are summed in a fixed order and
    nothing is added by atomics, so two launches agree to the bit."""
    x, agg, node = _tail_inputs(n, 128, cuda_device)
    agg = agg.to(getattr(torch, agg_dtype))
    g = torch.randn(n, 128, generator=torch.Generator().manual_seed(7)).to(cuda_device)
    first = fused_step_tail_bwd(x, agg, g, node)
    second = fused_step_tail_bwd(x, agg, g, node)
    torch.cuda.synchronize()
    for a, b in zip([first[0], first[1], *first[2]], [second[0], second[1], *second[2]]):
        assert torch.equal(a, b)


# The width-general K5 and K6 (fused_tail_wide.cu, fused_tail_wide_bwd.cu):
# width 256 with either carry, width 128 with a bf16 carry; n at the edges
# of their 64-row warpgroup tiles and 128-row block tiles (127, 128, 129,
# 255, 257, and 385: an odd count of block tiles). A bf16 carry rounds the output (and
# dx) to bf16 on both sides, from f32 values that differ in the last bits:
# one bf16 ulp at |v| < 8 is 2^-5, so the forward's maximum is 1e-1 there.
# At width 256 the pre-activations sum twice the terms, and more ReLU masks
# flip: 202 of dagg's 16.8 M entries at n = 65,536 (1.2e-5; on an H100), so
# the backward allows 5e-5 of the entries off there.
_WIDE_CASES = [(128, "bfloat16"), (256, "float32"), (256, "bfloat16")]
_WIDE_NS = [1, 63, 65, 127, 128, 129, 255, 257, 385, 4099, 65536]


def _wide_inputs(n, width, x_dtype, agg_dtype, device):
    x, agg, node = _tail_inputs(n, width, device)
    return x.to(getattr(torch, x_dtype)), agg.to(getattr(torch, agg_dtype)), node


@pytest.mark.cuda
@pytest.mark.parametrize("agg_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("width,x_dtype", _WIDE_CASES)
@pytest.mark.parametrize("n", _WIDE_NS)
def test_fused_tail_wide_kernel_matches_plain_version(cuda_device, n, width, x_dtype,
                                                      agg_dtype):
    x, agg, node = _wide_inputs(n, width, x_dtype, agg_dtype, cuda_device)
    kernels.reset_launches()
    out = fused_step_tail(x, agg, node)
    ref = fused_step_tail_reference(x, agg, node)
    torch.cuda.synchronize()
    assert kernels.launches["fused_tail_wide"] == 1 and kernels.launches["fused_tail"] == 0
    assert out.dtype == x.dtype and out.shape == (n, width)
    err = (out.float() - ref.float()).abs()
    tol_max, tol_mean = (5e-2, 2e-3) if x_dtype == "float32" else (1e-1, 4e-3)
    assert float(err.max()) <= tol_max and float(err.mean()) <= tol_mean, (
        float(err.max()), float(err.mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("agg_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("width,x_dtype", _WIDE_CASES)
@pytest.mark.parametrize("n", _WIDE_NS)
def test_fused_tail_wide_bwd_kernel_matches_plain_version(cuda_device, n, width, x_dtype,
                                                          agg_dtype):
    x, agg, node = _wide_inputs(n, width, x_dtype, agg_dtype, cuda_device)
    g = torch.randn(n, width, generator=torch.Generator().manual_seed(7)).to(cuda_device)
    g = g.to(x.dtype)
    kernels.reset_launches()
    dx, dagg, grads = fused_step_tail_bwd(x, agg, g, node)
    ref_dx, ref_dagg, ref_grads = fused_step_tail_bwd_reference(x, agg, g, node)
    torch.cuda.synchronize()
    assert kernels.launches["fused_tail_wide_bwd"] == 1
    assert dx.dtype == x.dtype and dagg.dtype == agg.dtype
    for a, b in zip([dx, dagg, *grads], [ref_dx, ref_dagg, *ref_grads]):
        assert a.shape == b.shape
        _mostly_close(a, b, 1e-2, 1e-3, off_share=5e-5 if width == 256 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("width,x_dtype", _WIDE_CASES)
def test_fused_tail_wide_launches_are_bit_equal(cuda_device, width, x_dtype):
    """Each row's sums run in a fixed order: two launches agree to the bit."""
    x, agg, node = _wide_inputs(4099, width, x_dtype, "float32", cuda_device)
    first = fused_step_tail(x, agg, node)
    second = fused_step_tail(x, agg, node)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("width,x_dtype", _WIDE_CASES)
def test_fused_tail_wide_bwd_launches_are_bit_equal(cuda_device, width, x_dtype):
    x, agg, node = _wide_inputs(4099, width, x_dtype, "float32", cuda_device)
    g = torch.randn(4099, width, generator=torch.Generator().manual_seed(7)).to(cuda_device)
    g = g.to(x.dtype)
    first = fused_step_tail_bwd(x, agg, g, node)
    second = fused_step_tail_bwd(x, agg, g, node)
    torch.cuda.synchronize()
    for a, b in zip([first[0], first[1], *first[2]], [second[0], second[1], *second[2]]):
        assert torch.equal(a, b)


def _packs(layout, codes, cap, spill, spec):
    return cellblock.sender_packs(cellblock.slot_codes(layout, codes, cap, spill, spec), layout,
                                  cap, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_reverse_table_kernel_matches_plain_version(cuda_device, case):
    """K7 from the sender packs (read through pad_src, main-image rows
    computed in the kernel) against its plain version on the padded
    candidates: S_rev and its total equal; the plan's certificate from the
    two kernels' counts equal to the plain tables' sums."""
    spec, cap, layout, codes, spill, pos = _plan_inputs(case, cuda_device)
    packs = _packs(layout, codes, cap, spill, spec)
    kernels.reset_launches()
    s_rev, total = cellblock.reverse_table(packs, layout, spec)
    ref = cellblock.reverse_table_reference(cellblock.reverse_candidates(packs, layout, spec),
                                            layout.window_starts, layout.tile_pack_base,
                                            layout.window_lims, spec=spec)
    torch.cuda.synchronize()
    assert kernels.launches["reverse_table"] == 1
    assert torch.equal(s_rev, ref)
    assert int(total) == int(ref.sum(dtype=torch.int64)) > 0
    plan = cellblock.build_cellblock(pos, None, 1.0, spec, with_reverse=True,
                                     neighbor_codes=codes, codes_cap=cap, codes_spill=spill)
    assert torch.equal(plan.s_rev_table, s_rev)
    mismatch = int(plan.s_table.sum(dtype=torch.int64)) - int(ref.sum(dtype=torch.int64))
    assert int(plan.reverse_mismatch) == mismatch == _PLAN_MISMATCH.get(case, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["packs", "offsets"])
def test_reverse_mismatch_fires_on_the_card(cuda_device, side, monkeypatch):
    """One edge dropped from the sender packs before the reverse build (+1)
    or from S's offsets (-1): the kernels' two counts disagree by it."""
    spec, cap, layout, codes, spill, pos = _plan_inputs("flagship", cuda_device)
    drop_one_edge(monkeypatch, side, spec)
    plan = cellblock.build_cellblock(pos, None, 1.0, spec, with_reverse=True,
                                     neighbor_codes=codes, codes_cap=cap, codes_spill=spill)
    assert int(plan.reverse_mismatch) == (1 if side == "packs" else -1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _WINDOW_SHAPES)
def test_window_matmul_t_kernel_matches_plain_version(cuda_device, shape):
    spec, s_rev, starts, g_pad = _window_inputs(shape, cuda_device, transpose=True)
    kernels.reset_launches()
    out = cellblock.window_matmul_t(s_rev, g_pad, starts, spec=spec)
    ref = cellblock.window_matmul_t_reference(s_rev, g_pad, starts, spec=spec)
    torch.cuda.synchronize()
    assert kernels.launches["window_matmul_t"] == 1
    _assert_window_close(out, ref)
    if shape in _WINDOW_EXACT:
        assert torch.equal(out, ref)


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", _KNN_CASES)
def test_knn_dual_kernel_matches_plain_version(cuda_device, case):
    """K1'': ids equal to K1's ids mode, codes and kth to its plain version."""
    pos, k, grid = _codes_case(case)
    n = pos.shape[0]
    dpos = pos.to(cuda_device)
    cap, _, spill_cap = pallas_knn.spill_layout(n, k, grid)
    box = torch.tensor(1.0, device=cuda_device)
    t = pallas_knn.build_table(dpos, grid.grid_size, cap, box)
    spill = pallas_knn.build_spill(dpos, t.particle_rank, cap, spill_cap)
    args = dict(k=k, n=n, g=grid.grid_size, mi_start=pallas_knn.min_image_start(cap, spill_cap))
    planes = (t.x, t.y, t.z, t.ids)
    kernels.reset_launches()
    ids, codes, kth = pallas_knn.knn_dual(planes, spill, box=1.0, **args)
    k1_ids, k1_kth = pallas_knn.knn_select(planes, spill, box=1.0, **args)
    ref_ids, ref_codes, ref_kth = pallas_knn.knn_dual_reference(planes, spill, box=box, **args)
    torch.cuda.synchronize()
    assert kernels.launches["knn_dual"] == 1
    assert torch.equal(ids, k1_ids) and torch.equal(ids, ref_ids)
    assert torch.equal(codes, ref_codes)
    assert torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32))
    assert torch.equal(kth.view(torch.int32), k1_kth.view(torch.int32))
    out = pallas_cell_list_knn(dpos, k, 1.0, grid, return_diagnostics=True, with_codes=True)
    cpu = pallas_cell_list_knn(pos, k, 1.0, grid, return_diagnostics=True, with_codes=True)
    for a, b in zip(out[:2], cpu[:2]):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(out[-1], cpu[-1]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [500_000, 600_000])
def test_knn_dual_kernel_packs_or_carries_the_lane(cuda_device, n):
    """K1'' packs id << lane_bits | lane into its key's payload where the
    ids fit beside the lanes (n <= 2^19 with the 8,064 candidate lanes of
    grid 3, capacity 296: 13 lane bits) and carries the lane as a value past
    that; both equal the plain version."""
    pos = torch.rand(n, 3, generator=torch.Generator().manual_seed(6)).to(cuda_device)
    k, grid = 16, CellGrid(3, 296)
    cap, num_cand, spill_cap = pallas_knn.spill_layout(n, k, grid)
    assert (cap, num_cand) == (296, 8064)
    box = torch.tensor(1.0, device=cuda_device)
    t = pallas_knn.build_table(pos, grid.grid_size, cap, box)
    spill = pallas_knn.build_spill(pos, t.particle_rank, cap, spill_cap)
    args = dict(k=k, n=n, g=grid.grid_size, mi_start=pallas_knn.min_image_start(cap, spill_cap))
    planes = (t.x, t.y, t.z, t.ids)
    ids, codes, kth = pallas_knn.knn_dual(planes, spill, box=1.0, **args)
    ref_ids, ref_codes, ref_kth = pallas_knn.knn_dual_reference(planes, spill, box=box, **args)
    torch.cuda.synchronize()
    assert torch.equal(ids, ref_ids) and torch.equal(codes, ref_codes)
    assert torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32))


def _flat(out):
    """The tensors of a (nested) k-NN result, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out if part is not None for t in _flat(part)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ids", "codes_only", "with_codes"])
def test_cell_list_knn_is_captured_in_a_cuda_graph(cuda_device, mode):
    """The whole K1 search (table build, kernel, reorder, spill solve,
    certificate) reads nothing back from the device, so it is captured in a
    CUDA graph; a replay equals the eager call, on the captured positions
    and on new ones copied into the same tensor."""
    n, k = 20000, 16
    gen = torch.Generator().manual_seed(3)
    pos = torch.rand(n, 3, generator=gen).to(cuda_device)
    grid = choose_cell_grid(n, k)
    kw = {"ids": {}, "codes_only": {"codes_only": True}, "with_codes": {"with_codes": True}}[mode]
    name = {"ids": "knn_select", "codes_only": "knn_codes", "with_codes": "knn_dual"}[mode]

    def run():
        return pallas_cell_list_knn(pos, k, 1.0, grid, return_diagnostics=True, **kw)

    eager = _flat(run())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    kernels.reset_launches()
    with torch.cuda.graph(graph):
        captured = _flat(run())
    assert kernels.launches[name] == 1
    graph.replay()
    torch.cuda.synchronize()
    assert len(captured) == len(eager)
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)
    pos.copy_(torch.rand(n, 3, generator=gen).to(cuda_device))
    graph.replay()
    fresh = _flat(run())
    torch.cuda.synchronize()
    for a, b in zip(captured, fresh):
        assert torch.equal(a, b)
    assert not torch.equal(captured[0], eager[0])


def _dense_frame(case, n=65536):
    if case in CLUSTERED:
        return torch.from_numpy(clustered_positions(n, case))
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 1, (n, 3))
    if case == "truncating":
        # 300 particles in one cell: its tiles' windows outgrow w_eff.
        pos[:300] = 0.41 + 0.05 * rng.uniform(0, 1, (300, 3))
    if case == "lattice":  # many exactly equal distances
        pos = np.remainder(np.round(pos * 1024) / 1024, 1.0)
    return torch.tensor(pos, dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "truncating", "lattice", "uniform_k48",
                                  "lattice_k48", *CLUSTERED])
def test_dense_select_kernel_matches_plain_version(cuda_device, case):
    """K8 against its plain version at the flagship spec on the live rows
    the plan passes (padding rows the no-pick lane), and the dense plan on
    the card against the CPU plain path (S, certificate, S_rev)."""
    frame, _, wide = case.partition("_k")
    pos = _dense_frame(frame)
    n, k = pos.shape[0], int(wide or 16)
    spec = cellblock.choose_cellblock_spec(n, 16)
    dspec = cellblock.choose_dense_search_spec(n, spec)
    dpos = pos.to(cuda_device)
    layout = cellblock.cellblock_layout(dpos, 1.0, spec)
    ds = cellblock.dense_search_inputs(layout, dpos[layout.order], 1.0, spec, dspec)
    args = dict(k=k, query_block=dspec.query_block, w_eff=ds.w_eff)
    kernels.reset_launches()
    lanes, kth = cellblock.dense_select(ds.table, ds.queries, ds.windows, 1.0, ds.rows, **args)
    ref_lanes, ref_kth = cellblock.dense_select_reference(ds.table, ds.queries, ds.windows,
                                                          1.0, **args)
    torch.cuda.synchronize()
    assert kernels.launches["dense_select"] == 1
    live = (torch.arange(dspec.query_block, device=cuda_device) < ds.rows[:, None]).reshape(-1)
    assert not bool(live.all())
    assert torch.equal(lanes[live], ref_lanes[live])
    assert torch.equal(kth[live].view(torch.int32), ref_kth[live].view(torch.int32))
    assert bool((lanes[~live] == 9 * ds.w_eff).all()) and bool((kth[~live] == 1e30).all())
    if wide:
        return
    plan = cellblock.build_cellblock(dpos, None, 1.0, spec, with_reverse=True,
                                     dense_search=dspec, num_neighbors=k)
    cpu = cellblock.build_cellblock(pos, None, 1.0, spec, with_reverse=True,
                                    dense_search=dspec, num_neighbors=k)
    for field in ("s_table", "s_rev_table", "overflow", "dropped_edges",
                  "reverse_mismatch", "search_window_overflow", "search_excess"):
        assert torch.equal(getattr(plan, field).cpu(), getattr(cpu, field)), field
    if case == "truncating":
        assert int(plan.search_window_overflow) > 0
    elif case in CLUSTERED:
        assert int(plan.overflow) > 0
    elif case == "uniform":
        assert int(plan.search_window_overflow) == 0 and float(plan.search_excess) <= 0
        assert int(plan.reverse_mismatch) == 0


def _route_inputs(seed, n=8192):
    rng = np.random.default_rng(seed)
    pos = np.remainder(rng.uniform(0, 1, (1, n, 3))
                       + rng.normal(0, 5e-4, (5, n, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (5, n, 1))).astype(np.float32)
    return pos, temp


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["dense", "aux"])
def test_dense_and_aux_rollouts_on_the_card_go_through_their_kernels(cuda_device, route):
    cfg = default_model_config(num_message_passing_steps=2)
    pos, temp = _route_inputs(4)
    n = pos.shape[1]
    kw = dict(num_neighbors=16, dtype=torch.bfloat16, aggregation="cellblock_hybrid")
    if route == "dense":
        kw["cellblock_search"] = "dense"
        expected = {"dense_select": 2}
    else:
        # The spec's own grid (7) is not the k-NN grid (9): plans from ids.
        kw["cellblock_spec"] = cellblock.choose_cellblock_spec(n)
        expected = {"knn_dual": 2}
    runs = {}
    for dev in ("cpu", cuda_device):
        params = init_encode_process_decode(cfg, torch.Generator().manual_seed(0), device=dev)
        kernels.reset_launches()
        runs[str(dev)] = rollout(params, cfg, pos, temp,
                                 NormalizationStats.from_metadata(METADATA, device=dev), 2,
                                 device=dev, fused_tail=True if dev == "cpu" else None, **kw)
    torch.cuda.synchronize()
    assert kernels.launches == {**dict.fromkeys(kernels.KERNELS, 0), **expected,
                                "s_onehot": 2, "window_matmul": 4, "fused_tail": 4}
    gpu, cpu = runs[str(cuda_device)], runs["cpu"]
    assert bool(gpu["neighbor_exactness"].all())
    np.testing.assert_array_equal(gpu["neighbor_exactness"].cpu().numpy(),
                                  cpu["neighbor_exactness"].numpy())
    np.testing.assert_allclose(gpu["Coordinates"].cpu().numpy(),
                               cpu["Coordinates"].numpy(), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["gather", "codes", "aux"])
def test_one_step_prediction_on_the_card_is_the_first_rollout_frame(cuda_device, route):
    cfg = default_model_config(num_message_passing_steps=2)
    pos, temp = _route_inputs(5)
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(0),
                                        device=cuda_device)
    stats = NormalizationStats.from_metadata(METADATA, device=cuda_device)
    kw = dict(num_neighbors=16, dtype=torch.bfloat16, device=cuda_device,
              aggregation="gather" if route == "gather" else "cellblock_hybrid")
    if route == "aux":
        kw["cellblock_spec"] = cellblock.choose_cellblock_spec(pos.shape[1])
    new_pos, new_temp = one_step_prediction(params, cfg, pos, temp, stats, **kw)
    ref = rollout(params, cfg, pos, temp, stats, 1, **kw)
    assert new_pos.shape == (pos.shape[1], 3) and new_temp.shape == (pos.shape[1], 1)
    np.testing.assert_allclose(new_pos.cpu().numpy(), ref["Coordinates"][-1].cpu().numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(new_temp.cpu().numpy(),
                               ref["InternalEnergy"][-1].cpu().numpy(), atol=1e-6, rtol=0)


_BRUTE_CASES = ["uniform", "clustered30", "lattice", "queries"]


def _brute_case(case, n=65536):
    """(reference set, queries or None): a uniform frame; the clustered30
    frame (the certificate fails there); the uniform frame on the 2^-10
    lattice (exactly equal distances: the tie order); 10,000 separate
    queries against the uniform frame."""
    if case == "clustered30":
        return torch.from_numpy(clustered_positions(n, case)), None
    pos = torch.rand(n, 3, generator=torch.Generator().manual_seed(7))
    if case == "lattice":
        return torch.remainder(torch.round(pos * 1024) / 1024, 1.0), None
    if case == "queries":
        return pos, torch.rand(10000, 3, generator=torch.Generator().manual_seed(8))
    return pos, None


@pytest.mark.cuda
@pytest.mark.parametrize("case", _BRUTE_CASES)
def test_knn_brute_kernel_matches_plain_version(cuda_device, case):
    pos, queries = (None if t is None else t.to(cuda_device) for t in _brute_case(case))
    ref_ids, ref_d2 = knn_periodic_reference(pos, 48, 1.0, queries=queries,
                                             return_distances=True)
    for k in (16, 48):
        kernels.reset_launches()
        ids, d2 = knn_periodic(pos, k, 1.0, queries=queries, return_distances=True)
        torch.cuda.synchronize()
        assert kernels.launches["knn_brute"] == 1
        assert torch.equal(ids, ref_ids[:, :k])
        assert torch.equal(d2.view(torch.int32), ref_d2[:, :k].contiguous().view(torch.int32))


@pytest.mark.cuda
def test_knn_brute_gate_keeps_or_overwrites_the_buffer(cuda_device):
    pos = torch.from_numpy(clustered_positions(8192, "clustered30")).to(cuda_device)
    ids = torch.full((8192, 16), -7, dtype=torch.int64, device=cuda_device)
    d2 = torch.full((8192, 16), -1.5, device=cuda_device)
    before = (ids.clone(), d2.clone())
    gate = torch.ones((), dtype=torch.bool, device=cuda_device)
    out = knn_periodic(pos, 16, 1.0, return_distances=True, skip_if=gate, out=(ids, d2))
    torch.cuda.synchronize()
    assert out[0] is ids and out[1] is d2
    assert torch.equal(ids, before[0]) and torch.equal(d2.view(torch.int32),
                                                       before[1].view(torch.int32))
    gate.fill_(False)
    knn_periodic(pos, 16, 1.0, return_distances=True, skip_if=gate, out=(ids, d2))
    ref_ids, ref_d2 = knn_periodic_reference(pos, 16, 1.0, return_distances=True)
    assert torch.equal(ids, ref_ids) and torch.equal(d2.view(torch.int32),
                                                     ref_d2.view(torch.int32))
    with pytest.raises(ValueError, match="skip_if needs the buffer"):
        knn_periodic(pos, 16, 1.0, skip_if=gate)
    with pytest.raises(ValueError, match="contiguous"):
        knn_periodic(pos, 16, 1.0, skip_if=gate, out=torch.empty((8192, 16), dtype=torch.int32,
                                                                  device=cuda_device))


@pytest.mark.cuda
def test_fallback_rollout_on_the_card_goes_through_its_kernels(cuda_device):
    """On a clustered window (certificate false every step) the fallback
    runs K1, K9 and K5 each step, equals the brute-force rollout and the
    CPU plain path; on a uniform one K9 runs gated and changes nothing."""
    cfg = default_model_config(num_message_passing_steps=2)
    n = 8192
    rng = np.random.default_rng(9)
    base = clustered_positions(n, "clustered30")[None]
    pos = np.remainder(base + rng.normal(0, 5e-4, (5, n, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (5, n, 1))).astype(np.float32)
    upos, utemp = _route_inputs(6)
    kw = dict(num_neighbors=16, dtype=torch.bfloat16)
    runs, launches = {}, {}
    for label, dev, p, t, extra in (
            ("cpu", "cpu", pos, temp, dict(exactness_guard="fallback", fused_tail=True)),
            ("fallback", cuda_device, pos, temp, dict(exactness_guard="fallback")),
            ("bruteforce", cuda_device, pos, temp, dict(neighbor_method="bruteforce")),
            ("uniform fallback", cuda_device, upos, utemp, dict(exactness_guard="fallback")),
            ("uniform flag", cuda_device, upos, utemp, {})):
        params = init_encode_process_decode(cfg, torch.Generator().manual_seed(0), device=dev)
        kernels.reset_launches()
        runs[label] = rollout(params, cfg, p, t,
                              NormalizationStats.from_metadata(METADATA, device=dev), 2,
                              device=dev, **kw, **extra)
        torch.cuda.synchronize()
        launches[label] = dict(kernels.launches)
    zero = dict.fromkeys(kernels.KERNELS, 0)
    assert launches["fallback"] == {**zero, "knn_select": 2, "knn_brute": 2, "fused_tail": 4}
    assert launches["bruteforce"] == {**zero, "knn_brute": 2, "fused_tail": 4}
    assert launches["uniform fallback"] == launches["fallback"]
    assert not runs["fallback"]["neighbor_exactness"].any()
    np.testing.assert_array_equal(runs["fallback"]["neighbor_exactness"].cpu().numpy(),
                                  runs["cpu"]["neighbor_exactness"].numpy())
    np.testing.assert_allclose(runs["fallback"]["Coordinates"].cpu().numpy(),
                               runs["bruteforce"]["Coordinates"].cpu().numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(runs["fallback"]["Coordinates"].cpu().numpy(),
                               runs["cpu"]["Coordinates"].numpy(), atol=1e-5, rtol=0)
    assert runs["uniform fallback"]["neighbor_exactness"].all()
    for key in ("Coordinates", "InternalEnergy", "neighbor_exactness"):
        assert torch.equal(runs["uniform fallback"][key], runs["uniform flag"][key])


@pytest.mark.cuda
@pytest.mark.parametrize("reneighbor_every", [1, 2])
def test_sorted_state_rollout_on_the_card_is_bit_equal(cuda_device, reneighbor_every):
    cfg = default_model_config(num_message_passing_steps=2)
    pos, temp = _route_inputs(7)
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(0),
                                        device=cuda_device)
    stats = NormalizationStats.from_metadata(METADATA, device=cuda_device)
    runs = {state: rollout(params, cfg, pos, temp, stats, 4, num_neighbors=16,
                           dtype=torch.bfloat16, sorted_state=state,
                           reneighbor_every=reneighbor_every, device=cuda_device)
            for state in ("on", "off")}
    for key in runs["off"]:
        assert torch.equal(runs["on"][key], runs["off"][key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [0, 1, 2, 3])
def test_slab_plan_kernels_match_plain_versions(cuda_device, shard):
    """One halo shard's open-slab plan (N = 4,096, k = 4, 4 shards: the
    candidate set built on the host, a validity mask, a per-dimension box,
    the ring clamped in x) with its reverse table: K3 and K7 equal to their
    plain versions (S, S_rev, totals), the plan's S and S_rev equal to them
    and its certificate counts 0; K4 and K4^T within K4's tolerances."""
    from cosmology_gnn_simulation_tpu_torch.ops.cell_list import cell_list_knn
    from cosmology_gnn_simulation_tpu_torch.parallel import halo

    n, k, p = 4096, 4, 4
    rng = np.random.default_rng(31)
    pos = rng.uniform(0, 1, (5, n, 3)).astype(np.float32)
    hc = halo.choose_halo_config(n, k, p)
    spec = cellblock.choose_cellblock_spec_halo(n, hc.grid_size, hc.slab_layers,
                                                hc.halo_layers, p)
    part = halo.partition_windows(pos, np.ones((5, n, 1), np.float32), hc, 1.0)
    cand, valid, _ = halo.shard_candidates(part["positions"][-1], part["valid"], hc, 1.0, shard)
    local, box_local = halo.slab_frame(cand, hc, spec.gx, 1.0, shard)
    cand_t, valid_t = torch.from_numpy(cand).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    local_t = torch.from_numpy(local).to(cuda_device)
    box_t = torch.from_numpy(box_local).to(cuda_device)
    cap, m = hc.local_capacity, cand.shape[0]
    idx = cell_list_knn(cand_t, k, 1.0, CellGrid(hc.grid_size, hc.cell_capacity),
                        queries=cand_t[:cap], valid=valid_t)
    nbr = torch.cat([idx, torch.full((m - cap, k), m, dtype=idx.dtype, device=cuda_device)])
    layout = cellblock.cellblock_layout(local_t, box_t, spec, valid_t)
    senders = cellblock.aux_slot_senders(layout, nbr, spec)
    offsets, _ = cellblock.aux_offsets(senders, layout, spec)
    packs = (senders // spec.grid_size).to(torch.int32)
    kernels.reset_launches()
    s_table, s_total = cellblock.s_onehot(offsets, width=spec.s_width, with_total=True)
    s_rev, rev_total = cellblock.reverse_table(packs, layout, spec)
    torch.cuda.synchronize()
    assert kernels.launches["s_onehot"] == kernels.launches["reverse_table"] == 1
    ref_s = cellblock.s_onehot_reference(offsets, width=spec.s_width)
    ref_rev = cellblock.reverse_table_reference(
        cellblock.reverse_candidates(packs, layout, spec), layout.window_starts,
        layout.tile_pack_base, layout.window_lims, spec=spec)
    assert torch.equal(s_table, ref_s) and torch.equal(s_rev, ref_rev)
    assert int(s_total) == int(rev_total) == int(ref_s.sum(dtype=torch.int64)) > 0
    plan = cellblock.build_cellblock(local_t, nbr, box_t, spec, with_reverse=True, valid=valid_t)
    assert torch.equal(plan.s_table, ref_s) and torch.equal(plan.s_rev_table, ref_rev)
    assert int(plan.overflow) == int(plan.dropped_edges) == int(plan.reverse_mismatch) == 0
    z_pad = torch.randn(spec.num_padded, 128, generator=torch.Generator().manual_seed(shard))
    z_pad = z_pad.bfloat16().to(cuda_device)
    _assert_window_close(cellblock.window_matmul(s_table, z_pad, layout.window_starts, spec=spec),
                         cellblock.window_matmul_reference(s_table, z_pad, layout.window_starts,
                                                           spec=spec))
    _assert_window_close(
        cellblock.window_matmul_t(s_rev, z_pad, layout.window_starts, spec=spec),
        cellblock.window_matmul_t_reference(s_rev, z_pad, layout.window_starts, spec=spec))


@pytest.mark.cuda
def test_halo_exchange_and_plan_on_two_gloo_ranks_sharing_the_card(cuda_device, tmp_path):
    """Two gloo ranks on cuda:0 (how the card runs P >= 2 halo shards): the
    ring permute of CUDA tensors, staged through pinned host buffers, and
    its backward bit-equal to the CPU tensors' permute; one
    ``featurize_halo`` slab plan per rank (N = 4,096, k = 4), K3 once, its S
    equal to K3's plain version and K4 on it within K4's tolerances."""
    import torch_halo_workers as hw
    import torch_sharded_workers as workers
    from cosmology_gnn_simulation_tpu_torch.convert import params_to_numpy
    from cosmology_gnn_simulation_tpu_torch.parallel import halo

    n, k, p = 4096, 4, 2
    model = dict(window_size=5, latent_size=16, mlp_hidden_size=16, mlp_num_hidden_layers=1,
                 num_message_passing_steps=2)
    params = params_to_numpy(init_encode_process_decode(
        default_model_config(**model), torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(41)
    pos = np.remainder(rng.uniform(0, 1, (1, n, 3)) + rng.normal(0, 5e-4, (5, n, 3)).cumsum(0),
                       1.0).astype(np.float32)
    hc = halo.choose_halo_config(n, k, p)
    spec = cellblock.choose_cellblock_spec_halo(n, hc.grid_size, hc.slab_layers, hc.halo_layers,
                                                p)
    part = halo.partition_windows(pos, np.ones((5, n, 1), np.float32), hc, 1.0)
    cases = [("card", hw.permute_case, (1, p), dict(seed=7, device="cuda")),
             ("cpu", hw.permute_case, (1, p), dict(seed=7)),
             ("plan", hw.card_plan_case, (1, p),
              dict(model=model, meta=METADATA, params=params, hc=tuple(hc), part=part, k=k,
                   spec=spec))]
    ranks = workers.Ranks(p, str(tmp_path / "rendezvous"), cases).results()
    for rank in range(p):
        card, cpu = ranks[rank]["card"], ranks[rank]["cpu"]
        for shift in (1, -1):
            for got, want in zip(card[shift], cpu[shift]):
                np.testing.assert_array_equal(got, want)
        assert card["collectives"]["ppermute"] == cpu["collectives"]["ppermute"] == 4
        # Four permutes of [5, 3] float32, each down and up.
        assert card["staged"] == 4 * 2 * 5 * 3 * 4 and cpu["staged"] == 0
        plan = ranks[rank]["plan"]
        assert plan["launches"] == {"s_onehot": 1}
        assert plan["s_equal"] and plan["edges"] > 0 and plan["overflow"] == (0, 0)
        _assert_window_close(*plan["k4"])


@pytest.mark.cuda
def test_pinned_native_batches_upload_while_the_next_is_built(cuda_device, tmp_path):
    """The native loader feeding the card: every batch's buffers are fresh
    pinned tensors, the train step's ``_prepare`` uploads them with
    ``non_blocking=True`` and drops them while the loader builds the next
    batch into new ones (no synchronization in between), and after one
    synchronize every upload equals, bit for bit, the pageable loader's
    batch of the same windows."""
    from cosmology_gnn_simulation_tpu_torch.data import native_loader
    from cosmology_gnn_simulation_tpu_torch.data.synthetic import generate_synthetic_simulation
    from cosmology_gnn_simulation_tpu_torch.training.trainer import _prepare

    sim = generate_synthetic_simulation(num_snapshots=12, num_particles=65536, seed=4)
    cache = native_loader.write_cache(sim, str(tmp_path / "sim.cgnn"))
    pinned = native_loader.NativeSequenceLoader([cache], 5, pin_memory=True)
    pageable = native_loader.NativeSequenceLoader([cache], 5)
    cfg = default_model_config(latent_size=16, mlp_hidden_size=16, mlp_num_hidden_layers=1,
                               num_message_passing_steps=1)
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(0), cuda_device)
    kw = dict(shuffle=True, seed=1, drop_remainder=False)
    uploads = []
    for batch in pinned.batches(2, **kw):
        assert all(value.is_pinned() for value in batch.values())
        uploads.append(_prepare(params, batch, cfg, TrainConfig(), None)[0])
        del batch  # the allocator must hold each block until its copy is done
    torch.cuda.synchronize()
    want = list(pageable.batches(2, **kw))
    assert len(uploads) == len(want) == 4  # 7 windows: 3 full batches and a tail
    for got, ref in zip(uploads, want):
        for key, value in ref.items():
            assert torch.equal(got[key].cpu(), torch.from_numpy(value)), key
    pinned.close()
    pageable.close()
