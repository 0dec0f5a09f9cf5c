"""The port's window matmul (K4) and its S^T mode (K4^T) held against the
JAX package's ``cellblock._window_matmul`` (the Pallas kernel in interpret
mode, bf16 carry) at the edges of the CUDA kernel's tiling: the aux spec's
QB 224 and W 384 with a ragged second 128-column block (H 136), and W 8 (a
72-byte S row) with H 8; counts up to 127 and a window at the last row JAX
can start one (its starts are floored to 16 rows).

The candidates lie on a 1/16 lattice and the counts are sparse, so every
product and every float32 sum is exact on both sides: the 1e-5 tolerance of
the other parity tests holds with room to spare. K4^T at W 8 is held against
JAX's forward mode on S = S_rev transposed, the same sums (three JAX
compiles in all). CPU tensors take the plain versions and launch nothing.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu.ops import cellblock as jcb
from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.ops import cellblock

CASES = {
    # The aux spec's QB and W (9 tiles of one 224-slot column each).
    "qb224_w384_h136": (dict(grid_size=3, col_capacity=224, query_block=224, window=384,
                             wrap_cap=80, h_block=128), 136),
    "qb32_w8_h8": (dict(grid_size=3, col_capacity=32, query_block=32, window=8, wrap_cap=16,
                        h_block=128), 8),
}


@functools.cache
def _inputs(name):
    """(spec kwargs, H, S [slots, 9W], S_rev [T, 9W, rev_lanes], starts
    [T, 9], z_pad [num_padded, H]) as numpy; S is S_rev transposed."""
    spec_kw, h = CASES[name]
    spec = cellblock.CellBlockSpec(**spec_kw)
    t, qb, w = spec.num_tiles, spec.query_block, spec.window
    rng = np.random.default_rng(17)
    s_rev = np.where(rng.random((t, spec.s_width, spec.rev_lanes)) < 0.02,
                     rng.integers(1, 128, (t, spec.s_width, spec.rev_lanes)), 0).astype(np.int8)
    s_rev[:, :, qb:] = 0  # lanes past QB are never set
    s_rev[0, :4, 0] = 127
    s = np.ascontiguousarray(s_rev[:, :, :qb].transpose(0, 2, 1)).reshape(t * qb, spec.s_width)
    last = (spec.num_padded - w) // 16 * 16
    starts = rng.integers(0, last // 16 + 1, (t, 9)).astype(np.int32) * 16
    starts[-1, -1] = last
    z_pad = (rng.integers(-64, 65, (spec.num_padded, h)) / 16.0).astype(np.float32)
    return spec_kw, h, s, s_rev, starts, z_pad


@functools.cache
def _jax_window_matmul(name, transpose):
    spec_kw, _, s, s_rev, starts, z_pad = _inputs(name)
    out = jcb._window_matmul(
        jnp.asarray(s_rev if transpose else s), jnp.asarray(z_pad),
        jnp.arange(z_pad.shape[0]), jnp.asarray(starts), jcb.CellBlockSpec(**spec_kw),
        jnp.float32, jnp.bfloat16, True, s_rev3=transpose,
    )
    return np.asarray(out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_matmul_plain_matches_jax(name):
    spec_kw, _, s, _, starts, z_pad = _inputs(name)
    got = cellblock.window_matmul_reference(
        torch.from_numpy(s), torch.from_numpy(z_pad).bfloat16(), torch.from_numpy(starts),
        spec=cellblock.CellBlockSpec(**spec_kw))
    np.testing.assert_allclose(got.numpy(), _jax_window_matmul(name, False), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_matmul_t_plain_matches_jax(name):
    spec_kw, _, _, s_rev, starts, z_pad = _inputs(name)
    got = cellblock.window_matmul_t_reference(
        torch.from_numpy(s_rev), torch.from_numpy(z_pad).bfloat16(), torch.from_numpy(starts),
        spec=cellblock.CellBlockSpec(**spec_kw))
    # The S_rev mode of JAX's kernel at the aux shape; its forward mode on
    # S (the same sums) at W 8.
    want = _jax_window_matmul(name, name == "qb224_w384_h136")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_tensors_take_the_plain_versions(name):
    spec_kw, _, s, s_rev, starts, z_pad = _inputs(name)
    spec = cellblock.CellBlockSpec(**spec_kw)
    z, st = torch.from_numpy(z_pad).bfloat16(), torch.from_numpy(starts)
    before = dict(kernels.launches)
    out = cellblock.window_matmul(torch.from_numpy(s), z, st, spec=spec)
    out_t = cellblock.window_matmul_t(torch.from_numpy(s_rev), z, st, spec=spec)
    assert kernels.launches == before
    assert torch.equal(out, cellblock.window_matmul_reference(torch.from_numpy(s), z, st,
                                                              spec=spec))
    assert torch.equal(out_t, cellblock.window_matmul_t_reference(torch.from_numpy(s_rev), z,
                                                                  st, spec=spec))
    # S and S_rev hold the same counts, so the two modes agree exactly.
    assert torch.equal(out, out_t)


@pytest.mark.parametrize("h, w, kernel", [
    (256, 384, "persistent"),  # config 4
    (136, 384, "persistent"),
    (264, 256, "persistent"),  # two 256-column blocks
    (128, 256, "persistent"),  # the flagship
    (128, 384, "persistent"),  # the aux spec and the config-5 slab
    (64, 96, "persistent"),
    (16, 96, "tiled"),         # H < 64: a 64-column box wider than the candidates
    (256, 8, "tiled"),         # W % 16 != 0: no TMA map of S
])
def test_window_kernel_is_picked_by_shape(h, w, kernel):
    assert cellblock.window_kernel(h, w) == kernel
    assert kernel in cellblock.WINDOW_KERNELS
