"""The fused step tail's backward (the plain path of kernel K6) held against
the gradients of the JAX package's ``fused_step_tail`` (its ``custom_vjp``,
whose backward is the Pallas ``_tail_bwd_kernel``, interpret mode here), on
identical numpy inputs, weights and output cotangent.

Two port paths are held: ``fused_step_tail``'s own backward (K6's plain
version, which rounds operands to ``dtype`` where the JAX kernel does), and
autograd through the plain forward ``fused_step_tail_reference`` (which
rounds gradients to bf16 at the casts instead). Every gradient leaf is held
to a tolerance relative to its largest magnitude: float32 operands, 1e-5 for
both (f32 products, summation order; measured at most 5.8e-7); bf16
operands, 1e-2 for K6's plain version (a last-bit difference in an f32 sum
can flip one bf16 rounding of an operand, 2^-8 relative; measured 2.5e-6)
and 2e-2 for autograd (bf16 roundings at other places; measured at most
4.0e-3). A bf16 dagg is rounded to bf16 on both sides, from f32 values that
differ in the last bits: one bf16 ulp (2^-8) relative to its largest
magnitude.
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
    fused_step_tail_bwd,
    fused_step_tail_bwd_reference,
    fused_step_tail_reference,
    kernel_takes,
    resolve_fused_tail,
)
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    default_model_config,
)
from cosmology_gnn_simulation_tpu_torch.types import tree_leaves

BF16_ULP = 2.0**-8
TOL = {("float32", "function"): 1e-5, ("float32", "autograd"): 1e-5,
       ("bfloat16", "function"): 1e-2, ("bfloat16", "autograd"): 2e-2}


def _inputs(n, latent, agg_dtype, seed=0):
    rng = np.random.default_rng(seed)
    node = jax_init_mlp(jax.random.PRNGKey(seed), 2 * latent, latent, 2, latent,
                        layer_norm=True)
    node["ln"] = {
        "scale": jnp.asarray(rng.uniform(0.5, 1.5, latent), jnp.float32),
        "bias": jnp.asarray(rng.normal(0, 0.1, latent), jnp.float32),
    }
    node = jax.tree.map(jnp.asarray, node)
    x = rng.normal(0, 1, (n, latent)).astype(np.float32)
    agg = rng.normal(0, 2, (n, latent)).astype(np.float32)
    agg = np.array(jnp.asarray(agg, agg_dtype).astype(jnp.float32))
    g = rng.normal(0, 1, (n, latent)).astype(np.float32)
    return x, agg, g, node


def _jax_grads(x, agg, g, node, dtype, agg_dtype):
    def f(x, agg, node):
        return jax_fused_step_tail(x, agg, node, dtype=jnp.dtype(dtype), interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(agg, agg_dtype), node)
    dx, dagg, dnode = vjp(jnp.asarray(g))
    leaves = tree_leaves(params_from_jax(jax.tree.map(np.asarray, dnode), device="cpu"))
    return [torch.from_numpy(np.array(dx, np.float32)),
            torch.from_numpy(np.array(dagg.astype(jnp.float32)))] + leaves


def _port_grads(x, agg, g, node, dtype, agg_dtype, path):
    tnode = params_from_jax(jax.tree.map(np.asarray, node), device="cpu")
    leaves = [torch.from_numpy(x), torch.from_numpy(agg).to(getattr(torch, agg_dtype)),
              *tree_leaves(tnode)]
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    it = iter(leaves[2:])
    tnode = {"layers": tuple({"b": next(it), "w": next(it)} for _ in range(3)),
             "ln": {"bias": next(it), "scale": next(it)}}
    fn = fused_step_tail if path == "function" else fused_step_tail_reference
    out = fn(leaves[0], leaves[1], tnode, dtype=getattr(torch, dtype))
    return [t.float() for t in torch.autograd.grad(out, leaves, torch.from_numpy(g))]


def _assert_close(got, want, rels):
    assert len(got) == len(want)
    for i, (a, b, rel) in enumerate(zip(got, want, rels)):
        assert a.shape == b.shape, i
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= rel * scale, (i, err, scale)


@pytest.mark.parametrize("path", ["function", "autograd"])
@pytest.mark.parametrize("agg_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax(dtype, agg_dtype, path):
    jagg = jnp.bfloat16 if agg_dtype == "bfloat16" else jnp.float32
    x, agg, g, node = _inputs(700, 32, jagg)
    want = _jax_grads(x, agg, g, node, dtype, jagg)
    got = _port_grads(x, agg, g, node, dtype, agg_dtype, path)
    rels = [TOL[(dtype, path)]] * len(want)
    if agg_dtype == "bfloat16":
        rels[1] = max(rels[1], BF16_ULP)  # dagg is rounded to bf16 on both sides
    _assert_close(got, want, rels)


def test_bwd_wrapper_takes_plain_version_on_cpu():
    x, agg, g, node = _inputs(256, 128, jnp.bfloat16, seed=2)
    tnode = params_from_jax(jax.tree.map(np.asarray, node), device="cpu")
    xt, at, gt = torch.from_numpy(x), torch.from_numpy(agg).bfloat16(), torch.from_numpy(g)
    dx, dagg, grads = fused_step_tail_bwd(xt, at, gt, tnode)
    rdx, rdagg, rgrads = fused_step_tail_bwd_reference(xt, at, gt, tnode)
    assert dx.dtype == torch.float32 and dagg.dtype == torch.bfloat16
    for a, b in zip([dx, dagg, *grads], [rdx, rdagg, *rgrads]):
        assert torch.equal(a, b)
    assert [t.shape for t in grads] == [(128, 128), (128,)] * 3 + [(128,), (128,)]


def test_fused_tail_resolution():
    """``fused_tail=None`` is on only on CUDA for the shapes K5/K6 take
    (decided without a card: the rule reads the device's type)."""
    default = default_model_config()
    narrow = default_model_config(latent_size=32, mlp_hidden_size=32)
    deep = default_model_config(mlp_num_hidden_layers=3)
    cuda = torch.device("cuda")
    bf16 = torch.bfloat16
    assert resolve_fused_tail(None, default, cuda, bf16)
    assert not resolve_fused_tail(None, default, "cpu", bf16)
    assert not resolve_fused_tail(None, default, cuda, None)
    assert not resolve_fused_tail(None, narrow, cuda, bf16)
    assert not resolve_fused_tail(None, deep, cuda, bf16)
    assert not resolve_fused_tail(None, default._replace(prune_dead_edge_stream=False),
                                  cuda, bf16)
    # An explicit choice stands (the card refuses shapes it does not take).
    assert resolve_fused_tail(True, narrow, cuda, bf16)
    assert not resolve_fused_tail(False, default, cuda, bf16)
    with pytest.raises(ValueError, match="pruned"):
        resolve_fused_tail(True, default._replace(aggregate="edge_messages"), cuda, bf16)
    assert kernel_takes(128, 128, 3, bf16)
    assert not kernel_takes(128, 128, 3, torch.float32)
    assert not kernel_takes(128, 64, 3, bf16)
