"""The port's cell-list k-NN (the plain paths of kernel K1 and of its codes
mode K1') and brute force, held against the JAX package on identical numpy
inputs.

JAX's ``pallas_cell_list_knn`` runs in interpret mode here. Neighbor sets,
the overflow count and the certificate's verdict must be equal. On positions
drawn from a dyadic lattice (multiples of 2^-10 in a box of 1, grid 8) every
difference, square, sum and window margin is exact in float32, so the k-th
distance reductions (``max_d2``, ``max_excess``) must be bit-equal and the
neighbor rows equal in order, ties included. On continuous positions they
agree to 4 float32 ulps, not bit for bit: XLA:CPU contracts the kernel's
``d2 + delta * delta`` into FMAs, while the port, like its CUDA kernel,
rounds the product and the sum separately.

The codes mode (``codes_only``) is held the same way: on the lattice its
codes are bit-equal to JAX's in order, ties included (smallest lane wins);
on continuous positions the code sets of every row are equal, and the S
table the plan build makes from them is bit-equal.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu.ops.cell_list import CellGrid as JaxCellGrid
from cosmology_gnn_simulation_tpu.ops.neighbors import knn_periodic as jax_knn_periodic
from cosmology_gnn_simulation_tpu.ops.pallas_knn import (
    pallas_cell_list_knn as jax_pallas_cell_list_knn,
)
from cosmology_gnn_simulation_tpu_torch.ops import cellblock, pallas_knn
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import (
    CellGrid,
    choose_cell_grid,
    poisson_occupancy_capacity,
)
from cosmology_gnn_simulation_tpu_torch.ops.neighbors import knn_periodic
from cosmology_gnn_simulation_tpu_torch.ops.pallas_knn import (
    codes_packing_cap,
    knn_codes,
    knn_codes_reference,
    knn_select,
    knn_select_reference,
    pallas_cell_list_knn,
)

ULP_TOLERANCE = 4


def _sets_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    bad = [i for i, (x, y) in enumerate(zip(a, b)) if set(x.tolist()) != set(y.tolist())]
    assert not bad, f"{len(bad)} rows differ, first {bad[:5]}"


def _close_ulps(a, b, ref_scale):
    tol = ULP_TOLERANCE * np.spacing(np.float32(abs(ref_scale)))
    assert abs(float(a) - float(b)) <= tol, (float(a), float(b), tol)


def _uniform(seed, n):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)


def _spill(seed):
    """One cell crammed past the table capacity (the JAX spill test's layout)."""
    rng = np.random.default_rng(seed)
    bg = rng.uniform(0, 1, (2048, 3))
    cram = 0.44 + 0.04 * rng.uniform(0, 1, (40, 3))
    return np.concatenate([bg, cram]).astype(np.float32)


def _corners(seed):
    """Particles hugging every face and corner: their neighborhoods cross the
    periodic boundary in all three axes."""
    rng = np.random.default_rng(seed)
    eps = np.array([0.001, 0.999])
    corners = np.stack(np.meshgrid(eps, eps, eps), -1).reshape(-1, 3)
    faces = rng.uniform(0, 1, (64, 3))
    faces[np.arange(64), rng.integers(0, 3, 64)] = rng.choice([0.0005, 0.9995], 64)
    return np.concatenate([corners, faces, rng.uniform(0, 1, (2600, 3))]).astype(np.float32)


LATTICE = 1024


def _lattice(seed, n, cram=0):
    """Positions on the 2^-10 lattice; ``cram`` of them packed into one
    cell of the 8^3 grid, past its table capacity."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, LATTICE, (n, 3))
    pos[:cram] = 450 + rng.integers(0, 40, (cram, 3))
    return (pos / LATTICE).astype(np.float32)


def _lattice_grid(n):
    return (8, poisson_occupancy_capacity(n / 8**3, 8**3))


# name: (positions, k, grid spec or None for choose_cell_grid, bit-exact)
CASES = {
    "uniform": (lambda: _uniform(0, 3000), 8, None, False),
    # k above the kernel's old register cap of 32 (its KT = 64 list).
    "uniform_k48": (lambda: _uniform(3, 3000), 48, None, False),
    "spill": (lambda: _spill(1234), 8, (8, 16), False),
    "cross_boundary": (lambda: _corners(7), 8, None, False),
    "lattice": (lambda: _lattice(11, 4096), 8, _lattice_grid(4096), True),
    "lattice_spill": (lambda: _lattice(12, 4096, cram=40), 8, _lattice_grid(4096), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cell_list_knn_matches_jax_kernel(case):
    make, k, grid_spec, bit_exact = CASES[case]
    pos = make()
    n = pos.shape[0]
    grid = CellGrid(*grid_spec) if grid_spec else choose_cell_grid(n, k)
    jidx, (jovf, jmax_d2, jexcess) = jax_pallas_cell_list_knn(
        jnp.asarray(pos), k, 1.0, JaxCellGrid(*grid), return_diagnostics=True,
        interpret=True,
    )
    idx, (ovf, max_d2, excess) = pallas_cell_list_knn(
        torch.from_numpy(pos), k, 1.0, grid, return_diagnostics=True
    )
    _sets_equal(idx, jidx)
    assert int(ovf) == int(jovf)
    if bit_exact:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert np.float32(max_d2) == np.float32(jmax_d2)
        assert np.float32(excess) == np.float32(jexcess)
    else:
        _close_ulps(max_d2, jmax_d2, jmax_d2)
        _close_ulps(excess, jexcess, jmax_d2)
    assert (float(excess) <= 0) == (float(jexcess) <= 0)
    if case.endswith("spill"):
        # The cram really overflows the table into the spill block.
        cap, _, spill_cap = pallas_knn.spill_layout(n, k, grid)
        assert spill_cap > 0
        table = pallas_knn.build_table(torch.from_numpy(pos), grid.grid_size, cap,
                                       torch.tensor(1.0))
        assert int(table.overflow) > 0
    # Brute force stays the yardstick of exactness.
    _sets_equal(idx, knn_periodic(torch.from_numpy(pos), k, 1.0))


def _s_table(pos, codes, spill, k, grid):
    """The plan build's S table from one side's codes (same spec both sides)."""
    n, g = pos.shape[0], grid.grid_size
    spec = cellblock._plan_spec(g, n / g**2, n / g**3, 256, None)
    plan = cellblock.build_cellblock(
        torch.from_numpy(pos), None, 1.0, spec, neighbor_codes=codes,
        codes_cap=codes_packing_cap(n, k, grid), codes_spill=spill,
    )
    return plan.s_table, int(plan.dropped_edges)


@pytest.mark.parametrize("case", sorted(CASES))
def test_codes_mode_matches_jax_kernel(case):
    make, k, grid_spec, bit_exact = CASES[case]
    pos = make()
    n = pos.shape[0]
    grid = CellGrid(*grid_spec) if grid_spec else choose_cell_grid(n, k)
    jnone, jcodes, jspill, (jovf, jmax_d2, jexcess) = jax_pallas_cell_list_knn(
        jnp.asarray(pos), k, 1.0, JaxCellGrid(*grid), return_diagnostics=True,
        with_codes=True, codes_only=True, interpret=True,
    )
    none, codes, spill, (ovf, max_d2, excess) = pallas_cell_list_knn(
        torch.from_numpy(pos), k, 1.0, grid, return_diagnostics=True, codes_only=True
    )
    assert none is None and jnone is None
    assert codes.dtype == torch.int32 and codes.shape == (n, k)
    assert (spill is None) == (jspill is None)
    if spill is not None:
        for a, b in zip(spill, jspill):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(ovf) == int(jovf)
    jcodes = torch.from_numpy(np.array(jcodes))
    if bit_exact:
        assert torch.equal(codes, jcodes)
        assert np.float32(max_d2) == np.float32(jmax_d2)
        assert np.float32(excess) == np.float32(jexcess)
    else:
        _sets_equal(codes, jcodes)
        _close_ulps(max_d2, jmax_d2, jmax_d2)
        _close_ulps(excess, jexcess, jmax_d2)
        tspill = None if spill is None else tuple(torch.from_numpy(np.array(t)) for t in jspill)
        s_port, drop_port = _s_table(pos, codes, spill, k, grid)
        s_jax, drop_jax = _s_table(pos, jcodes, tspill, k, grid)
        assert torch.equal(s_port, s_jax) and drop_port == drop_jax
    assert (float(excess) <= 0) == (float(jexcess) <= 0)
    if case.endswith("spill"):
        cap = codes_packing_cap(n, k, grid)
        assert int((codes >= 27 * cap).sum()) > 0  # picks reach the spill block


def test_knn_codes_wrapper_takes_plain_version_on_cpu():
    pos = torch.from_numpy(_spill(9))
    n, k = pos.shape[0], 8
    grid = CellGrid(8, 16)
    cap, _, spill_cap = pallas_knn.spill_layout(n, k, grid)
    box = torch.tensor(1.0)
    t = pallas_knn.build_table(pos, grid.grid_size, cap, box)
    spill = pallas_knn.build_spill(pos, t.particle_rank, cap, spill_cap)
    args = dict(k=k, n=n, g=grid.grid_size, box=box,
                mi_start=pallas_knn.min_image_start(cap, spill_cap))
    planes = (t.x, t.y, t.z, t.ids)
    codes, kth = knn_codes(planes, spill, **args)
    ref_codes, ref_kth = knn_codes_reference(planes, spill, **args)
    assert torch.equal(codes, ref_codes) and torch.equal(kth, ref_kth)
    sentinel = 27 * cap + spill_cap
    empty_rows = t.ids.reshape(-1) == n
    assert (codes[empty_rows] == sentinel).all() and (kth[empty_rows] == 1e30).all()
    assert bool((codes[~empty_rows] < sentinel).all())
    # The same selection as the ids mode: each row's lanes name the same
    # particles as its ids (continuous data has no distance ties).
    ids, ids_kth = knn_select_reference(planes, spill, **args)
    assert torch.equal(kth, ids_kth)
    rows = torch.nonzero(~empty_rows).squeeze(1)
    cand_ids = pallas_knn.candidate_rows(planes, spill, rows // cap, grid.grid_size, box)[3]
    lane_ids = torch.gather(cand_ids, 1, codes[rows].long())
    assert torch.equal(lane_ids.sort(1).values, ids[rows].sort(1).values)


@pytest.mark.parametrize("box", [1.0, 3.7])
def test_bruteforce_matches_jax(box):
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, box, (1000, 3)).astype(np.float32)
    idx, d2 = knn_periodic(torch.from_numpy(pos), 8, box, query_tile=128,
                           return_distances=True)
    jidx, jd2 = jax_knn_periodic(jnp.asarray(pos), 8, box, query_tile=128,
                                 return_distances=True)
    _sets_equal(idx, jidx)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6, atol=1e-12)
    assert (idx[:, 0] == torch.arange(1000)).all()  # self first


def test_bruteforce_smallest_index_wins_ties():
    # A lattice: many exactly equal distances.
    g = np.arange(6, dtype=np.float32) / 6
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    idx = knn_periodic(torch.from_numpy(pos), 7, 1.0)
    jidx = jax_knn_periodic(jnp.asarray(pos), 7, 1.0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_knn_select_wrapper_takes_plain_version_on_cpu():
    pos = torch.from_numpy(_uniform(5, 1500))
    n, k = pos.shape[0], 8
    grid = choose_cell_grid(n, k)
    cap, _, spill_cap = pallas_knn.spill_layout(n, k, grid)
    box = torch.tensor(1.0)
    t = pallas_knn.build_table(pos, grid.grid_size, cap, box)
    spill = pallas_knn.build_spill(pos, t.particle_rank, cap, spill_cap)
    args = dict(k=k, n=n, g=grid.grid_size, box=box,
                mi_start=pallas_knn.min_image_start(cap, spill_cap))
    planes = (t.x, t.y, t.z, t.ids)
    ids, kth = knn_select(planes, spill, **args)
    ref_ids, ref_kth = knn_select_reference(planes, spill, **args)
    assert torch.equal(ids, ref_ids) and torch.equal(kth, ref_kth)
    # Empty table rows are sentinel rows.
    empty_rows = t.ids.reshape(-1) == n
    assert (ids[empty_rows] == n).all() and (kth[empty_rows] == 1e30).all()


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        # The card's machine may lack h5py, matplotlib and tqdm: importing
        # the port must not need them (torch imports tqdm only if present).
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('h5py', 'matplotlib', 'tqdm'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import cosmology_gnn_simulation_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('training.trainer', 'training.losses', 'ops.aggregation', 'ops.noise',\n"
        "          'cli.train', 'data.dataset', 'utils.checkpoint', 'metadata', 'evaluation',\n"
        "          'cli.one_step_test', 'cli.render_rollout', 'cli.rollout_conversion'):\n"
        "    assert p.__name__ + '.' + m in sys.modules, m\n"
        # Run this slice's routes on the CPU too: the dense search, the plain
        # cell list, the dual-mode k-NN and the plans from neighbor ids.
        "import torch\n"
        "from cosmology_gnn_simulation_tpu_torch.ops import cell_list, cellblock, pallas_knn\n"
        "pos = torch.rand(600, 3, generator=torch.Generator().manual_seed(0))\n"
        "grid = cell_list.choose_cell_grid(600, 8)\n"
        "spec = cellblock.choose_cellblock_spec(600, 8)\n"
        "cellblock.build_cellblock(pos, None, 1.0, spec, with_reverse=True, num_neighbors=8,\n"
        "    dense_search=cellblock.choose_dense_search_spec(600, spec))\n"
        "ids = cell_list.cell_list_knn(pos, 8, 1.0, grid)\n"
        "pallas_knn.pallas_cell_list_knn(pos, 8, 1.0, grid, with_codes=True)\n"
        "cellblock.build_cellblock(pos, ids, 1.0, cellblock.choose_cellblock_spec(600),\n"
        "    with_reverse=True)\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] in ('cosmology_gnn_simulation_tpu', 'orbax')]\n"
        "assert not bad, bad\n"
        "lazy = [m for m in sys.modules if m.split('.')[0] in ('h5py', 'matplotlib', 'tqdm')]\n"
        "assert not lazy, lazy\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

