"""The port's fused step tail (the plain path of kernel K5) held against the
JAX package's ``fused_step_tail`` (Pallas, interpret mode here) on identical
numpy inputs and weights.

Tolerances: float32 operands — both sides are f32 matmuls and f32
LayerNorm, differing only in summation order: 1e-5. bf16 operands — the
same, but a last-bit difference in an f32 sum can flip the bf16 rounding of
an intermediate (one bf16 ulp, 2^-8 relative) before the next product:
1e-2 absolute on O(1) outputs, 1e-4 on the mean error. The CUDA kernel sums
on tensor cores in yet another order, so against its plain version on the
card: 5e-2 absolute, 2e-3 mean.
"""

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
    fused_step_tail,
    fused_step_tail_reference,
)

TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-2, 1e-4)}


def _inputs(n, latent, hidden, agg_dtype, seed=0):
    rng = np.random.default_rng(seed)
    node = jax_init_mlp(jax.random.PRNGKey(seed), 2 * latent, hidden, 2, latent,
                        layer_norm=True)
    # Non-trivial LayerNorm affine params.
    node["ln"] = {
        "scale": jnp.asarray(rng.uniform(0.5, 1.5, latent), jnp.float32),
        "bias": jnp.asarray(rng.normal(0, 0.1, latent), jnp.float32),
    }
    x = rng.normal(0, 1, (n, latent)).astype(np.float32)
    agg = rng.normal(0, 1, (n, hidden)).astype(np.float32)
    agg = np.array(jnp.asarray(agg, agg_dtype).astype(jnp.float32))
    return x, agg, node


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("latent", [32, 128])
def test_plain_matches_jax(dtype, latent):
    n = 300
    agg_dtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, agg, node = _inputs(n, latent, latent, agg_dtype)
    ref = jax_fused_step_tail(
        jnp.asarray(x), jnp.asarray(agg, agg_dtype), node,
        dtype=jnp.dtype(dtype), interpret=True,
    )
    tnode = params_from_jax(jax.tree.map(np.asarray, node), device="cpu")
    out = fused_step_tail(
        torch.from_numpy(x), torch.from_numpy(agg).to(getattr(torch, str(agg_dtype.dtype))),
        tnode, dtype=getattr(torch, dtype),
    )
    assert out.dtype == torch.float32 and out.shape == (n, latent)
    err = np.abs(out.numpy() - np.asarray(ref))
    atol, mean_tol = TOL[dtype]
    assert err.max() <= atol and err.mean() <= mean_tol, (err.max(), err.mean())


def test_wrapper_takes_plain_version_on_cpu():
    x, agg, node = _inputs(64, 128, 128, jnp.bfloat16, seed=1)
    tnode = params_from_jax(jax.tree.map(np.asarray, node), device="cpu")
    xt, at = torch.from_numpy(x), torch.from_numpy(agg).bfloat16()
    assert torch.equal(fused_step_tail(xt, at, tnode),
                       fused_step_tail_reference(xt, at, tnode))

