"""The step tail's plain forward and backward (the CPU path of kernels K5
and K6) at row counts on either side of the CUDA kernels' 64-row tiles
(1, 65, 191: a tile of one row, one row past a tile, three tiles with a
ragged last one), held against the JAX package's ``fused_step_tail`` (the
Pallas ``_tail_kernel``, interpret mode) and its ``jax.vjp`` (the Pallas
``_tail_bwd_kernel``), on identical numpy inputs, with the kernels' layout:
latent = hidden = 128, one hidden Linear, bf16 operands, weights from
``convert.params_from_jax``.

Each (n, agg dtype) runs ``jax.vjp`` once, cached for the forward and the
backward tests. Tolerances as in ``test_torch_fused_tail.py`` and
``test_torch_fused_tail_bwd.py``: a last-bit difference in an f32 sum can
flip one bf16 rounding of an operand (2^-8 relative), so the forward is held
to 1e-2 absolute and 1e-4 mean on O(1) outputs, and every gradient leaf to
1e-2 of its largest magnitude (a bf16 dagg to one bf16 ulp of it, 2^-8,
since both sides round it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu.models.mlp import init_mlp as jax_init_mlp
from cosmology_gnn_simulation_tpu.ops.fused_step import (
    fused_step_tail as jax_fused_step_tail,
)
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
from cosmology_gnn_simulation_tpu_torch.ops.fused_step import (
    fused_step_tail_bwd_reference,
    fused_step_tail_reference,
)

WIDTH = 128
FWD_MAX, FWD_MEAN = 1e-2, 1e-4
BWD_REL, BF16_ULP = 1e-2, 2.0**-8
JAX_AGG = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}


@functools.cache
def _case(n, agg_dtype):
    """Inputs (numpy; node as a JAX tree) and JAX's output and gradients."""
    rng = np.random.default_rng(n)
    node = jax_init_mlp(jax.random.PRNGKey(n), 2 * WIDTH, WIDTH, 2, WIDTH, layer_norm=True)
    node["ln"] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, WIDTH), jnp.float32),
                  "bias": jnp.asarray(rng.normal(0, 0.1, WIDTH), jnp.float32)}
    x = rng.normal(0, 1, (n, WIDTH)).astype(np.float32)
    agg = rng.normal(0, 2, (n, WIDTH)).astype(np.float32)
    agg = np.array(jnp.asarray(agg, JAX_AGG[agg_dtype]).astype(jnp.float32))
    g = rng.normal(0, 1, (n, WIDTH)).astype(np.float32)

    def f(x, agg, node):
        return jax_fused_step_tail(x, agg, node, dtype=jnp.bfloat16, interpret=True)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(agg, JAX_AGG[agg_dtype]), node)
    dx, dagg, dnode = vjp(jnp.asarray(g))
    grads = [np.asarray(dx, np.float32), np.asarray(dagg.astype(jnp.float32)),
             jax.tree.map(np.asarray, dnode)]
    return x, agg, g, jax.tree.map(np.asarray, node), np.asarray(out), grads


def _port_inputs(n, agg_dtype):
    x, agg, g, node, _, _ = _case(n, agg_dtype)
    return (torch.from_numpy(x), torch.from_numpy(agg).to(getattr(torch, agg_dtype)),
            torch.from_numpy(g), params_from_jax(node, device="cpu"))


@pytest.mark.parametrize("agg_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1, 65, 191])
def test_plain_forward_matches_jax_at_tile_edges(n, agg_dtype):
    x, agg, _, node = _port_inputs(n, agg_dtype)
    out = fused_step_tail_reference(x, agg, node)
    want = _case(n, agg_dtype)[4]
    assert out.dtype == torch.float32 and out.shape == (n, WIDTH)
    err = np.abs(out.numpy() - want)
    assert err.max() <= FWD_MAX and err.mean() <= FWD_MEAN, (err.max(), err.mean())


@pytest.mark.parametrize("agg_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1, 65, 191])
def test_plain_backward_matches_jax_at_tile_edges(n, agg_dtype):
    x, agg, g, node = _port_inputs(n, agg_dtype)
    dx, dagg, grads = fused_step_tail_bwd_reference(x, agg, g, node)
    jdx, jdagg, jnode = _case(n, agg_dtype)[5]
    assert dx.dtype == torch.float32 and dagg.dtype == agg.dtype
    # grads: dw_self (the w_self rows of layer 0), db0, dw1, db1, dwf, dbf,
    # dscale, dbias.
    layers = jnode["layers"]
    want = [jdx, jdagg, layers[0]["w"][:WIDTH], layers[0]["b"], layers[1]["w"],
            layers[1]["b"], layers[2]["w"], layers[2]["b"], jnode["ln"]["scale"],
            jnode["ln"]["bias"]]
    got = [dx, dagg, *grads]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.float().numpy()
        assert a.shape == b.shape, i
        rel = max(BWD_REL, BF16_ULP) if i == 1 and agg_dtype == "bfloat16" else BWD_REL
        scale = float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= rel * scale, (i, float(np.abs(a - b).max()), scale)
