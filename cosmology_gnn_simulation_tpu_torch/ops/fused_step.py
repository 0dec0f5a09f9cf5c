"""Fused message-passing step tail around the CUDA kernel K5 (counterpart of
``ops/fused_step.py``; the Pallas kernel ``_tail_kernel`` becomes
``csrc/fused_tail.cu``, forward only).

    out = x + LN(W_f @ relu(W_h @ relu(x @ w_self + agg + b0) + b_h) + b_f)

in one pass over the rows: x and agg are read once and the result written
once, every intermediate staying on chip. Matmul operands are rounded to
``dtype`` with f32 accumulation, LayerNorm and the residual are f32, and the
output keeps ``x.dtype`` — the unfused path's precision policy, though not
bit-identical to it (the sums run in another order).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.models.mlp import layer_norm, matmul

# The kernel's fixed layout: latent = hidden = 128, one hidden Linear.
KERNEL_WIDTH = 128


def fused_step_tail_reference(x, agg, node_params, *, dtype=torch.bfloat16):
    """Plain PyTorch version of ``fused_step_tail`` (any layout, any dtype)."""
    latent = x.shape[1]
    layers = node_params["layers"]
    h = matmul(x, layers[0]["w"][:latent], dtype)
    h = torch.relu(h + agg.float() + layers[0]["b"])
    for layer in layers[1:-1]:
        h = torch.relu(matmul(h, layer["w"], dtype) + layer["b"])
    y = matmul(h, layers[-1]["w"], dtype) + layers[-1]["b"]
    y = layer_norm(y, node_params["ln"])
    return (x.float() + y).to(x.dtype)


@functools.cache
def _lib():
    lib = kernels.library("fused_tail")
    p = ctypes.c_void_p
    lib.fused_tail_launch.argtypes = [p] * 11 + [ctypes.c_int, p]
    lib.fused_tail_launch.restype = ctypes.c_int
    return lib


def fused_step_tail(x: torch.Tensor, agg: torch.Tensor, node_params, *,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """``x + LN(node_mlp(relu(x @ w_self + agg + b0)))`` in one fused pass.

    Args:
      x:    ``[N, L]`` carried latents; the output keeps its dtype.
      agg:  ``[N, H]`` aggregated neighbor contribution (pre-``w_self``
            space — the gather-sum of the ``w_agg`` projection).
      node_params: the step's node-MLP params; only the ``w_self`` half
            (rows ``< L``) of ``layers[0].w`` ``[2L, H]`` is read here.
      dtype: matmul operand dtype (f32 accumulation either way).

    CPU tensors take the plain version. CUDA tensors launch the kernel K5,
    which takes the default model's layout — L = H = 128, one hidden
    Linear, f32 x and weights, bf16 agg and operands — and raises on any
    other.
    """
    if x.device.type == "cpu":
        return fused_step_tail_reference(x, agg, node_params, dtype=dtype)
    layers = node_params["layers"]
    n, latent = x.shape
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_step_tail kernel takes bf16 operands, got {dtype}")
    if len(layers) != 3 or latent != KERNEL_WIDTH:
        raise ValueError(
            "fused_step_tail kernel supports latent = hidden = 128 with one hidden "
            f"Linear; got latent {latent} and {len(layers)} layers"
        )
    w0 = layers[0]["w"][:latent]
    weights = [
        w0, layers[0]["b"], layers[1]["w"], layers[1]["b"], layers[2]["w"],
        layers[2]["b"], node_params["ln"]["scale"], node_params["ln"]["bias"],
    ]
    shapes = [(128, 128), (128,)] * 3 + [(128,), (128,)]
    checks = [("x", x, (n, 128), torch.float32), ("agg", agg, (n, 128), torch.bfloat16)]
    checks += [(f"weight {i}", w, s, torch.float32)
               for i, (w, s) in enumerate(zip(weights, shapes))]
    for name, t, shape, dt in checks:
        if t.device != x.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"fused_step_tail: {name} must be a contiguous {dt} {shape} tensor "
                f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    out = torch.empty_like(x)
    err = _lib().fused_tail_launch(
        kernels.ptr(x), kernels.ptr(agg), *[kernels.ptr(w) for w in weights],
        kernels.ptr(out), n, kernels.stream_handle(x.device),
    )
    kernels.check("fused_tail", err)
    kernels.launches["fused_tail"] += 1
    return out
