"""The step tail's plain forward and backward (the CPU path of kernels K5
and K6) at the layouts of their width-general variants — latent = hidden =
256 with an f32 or a bf16 carry, and 128 with a bf16 carry — held against
the JAX package's ``fused_step_tail`` (the Pallas ``_tail_kernel``,
interpret mode) and its ``jax.vjp`` (the Pallas ``_tail_bwd_kernel``), on
identical numpy inputs (as ``tests/test_fused_step.py`` holds the JAX
kernel), one hidden Linear, bf16 operands, weights through
``convert.params_from_jax``. 65 rows: one past a 64-row tile.

Tolerances: a last-bit difference in an f32 sum can flip one bf16 rounding
of an operand (2^-8 relative), so an f32 output is held to 1e-2 absolute
and 1e-4 mean on O(1) values; a bf16 carry's output (and dx) is rounded to
bf16 on both sides from such values, one bf16 ulp (2^-5 at |v| in [4, 8))
more: 5e-2 absolute and 1e-3 mean. Every gradient leaf within 1e-2 of its
largest magnitude (a bf16 dagg or dx: both sides round it, one bf16 ulp,
2^-8, of it at most).
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
    kernel_takes,
)

ROWS = 65
TOL = {"float32": (1e-2, 1e-4), "bfloat16": (5e-2, 1e-3)}
BWD_REL = 1e-2
CASES = [(256, "float32", "float32"), (256, "bfloat16", "float32"), (128, "bfloat16", "bfloat16")]
JAX_DTYPE = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}


@functools.cache
def _case(width, carry, agg_dtype):
    """Inputs (numpy; node as a JAX tree) and JAX's output and gradients."""
    rng = np.random.default_rng(width)
    node = jax_init_mlp(jax.random.PRNGKey(width), 2 * width, width, 2, width, layer_norm=True)
    node["ln"] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, width), jnp.float32),
                  "bias": jnp.asarray(rng.normal(0, 0.1, width), jnp.float32)}
    x = np.array(jnp.asarray(rng.normal(0, 1, (ROWS, width)), JAX_DTYPE[carry])
                 .astype(jnp.float32))
    agg = np.array(jnp.asarray(rng.normal(0, 2, (ROWS, width)), JAX_DTYPE[agg_dtype])
                   .astype(jnp.float32))
    g = np.array(jnp.asarray(rng.normal(0, 1, (ROWS, width)), JAX_DTYPE[carry])
                 .astype(jnp.float32))

    def f(x, agg, node):
        return jax_fused_step_tail(x, agg, node, dtype=jnp.bfloat16, interpret=True)

    out, vjp = jax.vjp(f, jnp.asarray(x, JAX_DTYPE[carry]),
                       jnp.asarray(agg, JAX_DTYPE[agg_dtype]), node)
    dx, dagg, dnode = vjp(jnp.asarray(g, JAX_DTYPE[carry]))
    grads = [np.asarray(dx.astype(jnp.float32)), np.asarray(dagg.astype(jnp.float32)),
             jax.tree.map(np.asarray, dnode)]
    return (x, agg, g, jax.tree.map(np.asarray, node), np.asarray(out.astype(jnp.float32)),
            str(out.dtype), grads)


def _port_inputs(width, carry, agg_dtype):
    x, agg, g, node, *_ = _case(width, carry, agg_dtype)
    dt = getattr(torch, carry)
    return (torch.from_numpy(x).to(dt), torch.from_numpy(agg).to(getattr(torch, agg_dtype)),
            torch.from_numpy(g).to(dt), params_from_jax(node, device="cpu"))


@pytest.mark.parametrize("width,carry,agg_dtype", CASES)
def test_plain_forward_matches_jax_at_the_wide_layouts(width, carry, agg_dtype):
    assert kernel_takes(width, width, 3, torch.bfloat16)
    x, agg, _, node = _port_inputs(width, carry, agg_dtype)
    out = fused_step_tail_reference(x, agg, node)
    want, want_dtype = _case(width, carry, agg_dtype)[4:6]
    assert out.dtype == x.dtype and want_dtype == carry and out.shape == (ROWS, width)
    err = np.abs(out.float().numpy() - want)
    tol_max, tol_mean = TOL[carry]
    assert err.max() <= tol_max and err.mean() <= tol_mean, (err.max(), err.mean())


@pytest.mark.parametrize("width,carry,agg_dtype", CASES)
def test_plain_backward_matches_jax_at_the_wide_layouts(width, carry, agg_dtype):
    x, agg, g, node = _port_inputs(width, carry, agg_dtype)
    dx, dagg, grads = fused_step_tail_bwd_reference(x, agg, g, node)
    jdx, jdagg, jnode = _case(width, carry, agg_dtype)[6]
    assert dx.dtype == x.dtype and dagg.dtype == agg.dtype
    # grads: dw_self (the w_self rows of layer 0), db0, dw1, db1, dwf, dbf,
    # dscale, dbias.
    layers = jnode["layers"]
    want = [jdx, jdagg, layers[0]["w"][:width], layers[0]["b"], layers[1]["w"],
            layers[1]["b"], layers[2]["w"], layers[2]["b"], jnode["ln"]["scale"],
            jnode["ln"]["bias"]]
    got = [dx, dagg, *grads]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.float().numpy()
        assert a.shape == b.shape, i
        scale = float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= BWD_REL * scale, (i, float(np.abs(a - b).max()),
                                                                scale)
