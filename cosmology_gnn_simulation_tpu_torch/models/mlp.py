"""MLP building blocks over param dicts (counterpart of ``models/mlp.py``).

Layout follows the JAX package: a layer is ``{"w": [in, out], "b": [out]}``
and an MLP is ``{"layers": (layer, ...), "ln": {"scale", "bias"}?}`` —
``num_hidden_layers`` x (Linear -> ReLU), a final Linear, optional
LayerNorm.

Mixed precision: ``dtype=torch.bfloat16`` rounds the matmul OPERANDS to
bf16 and accumulates in f32 with an f32 result, as JAX's
``preferred_element_type=float32``. The operands are rounded, then widened
back to f32 for the product: bf16 x bf16 products are exact in f32 (and in
TF32), so the f32 matmul is bf16-operand / f32-accumulate whatever the
TF32 setting, where a bf16 ``torch.matmul`` would round its output to bf16.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]

LN_EPS = 1e-5  # torch.nn.LayerNorm default


def _init_linear(gen: torch.Generator, in_dim: int, out_dim: int) -> Params:
    # torch.nn.Linear's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
    bound = 1.0 / math.sqrt(in_dim)
    w = torch.empty(in_dim, out_dim).uniform_(-bound, bound, generator=gen)
    b = torch.empty(out_dim).uniform_(-bound, bound, generator=gen)
    return {"w": w, "b": b}


def init_mlp(
    gen: torch.Generator,
    in_dim: int,
    hidden_dim: int,
    num_hidden_layers: int,
    out_dim: int,
    layer_norm: bool = False,
) -> Params:
    """Float32 params on the CPU, drawn from the CPU generator ``gen``."""
    dims = [in_dim] + [hidden_dim] * num_hidden_layers + [out_dim]
    params: Params = {
        "layers": tuple(
            _init_linear(gen, dims[i], dims[i + 1]) for i in range(len(dims) - 1)
        )
    }
    if layer_norm:
        params["ln"] = {
            "scale": torch.ones(out_dim),
            "bias": torch.zeros(out_dim),
        }
    return params


def matmul(x: torch.Tensor, w: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x @ w`` with operands rounded to ``dtype`` and an f32 result."""
    if dtype is not None:
        x = x.to(dtype)
        w = w.to(dtype)
    return torch.matmul(x.float(), w.float())


def dense(x: torch.Tensor, layer: Params, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w + b`` with optional low-precision operands, f32 accumulation."""
    return matmul(x, layer["w"], dtype) + layer["b"]


def layer_norm(x: torch.Tensor, ln: Params) -> torch.Tensor:
    """f32 LayerNorm over the last axis: biased variance, ``LN_EPS``."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    normed = (x - mean) * torch.rsqrt(var + LN_EPS)
    return normed * ln["scale"] + ln["bias"]


def apply_mlp(params: Params, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    layers = params["layers"]
    for layer in layers[:-1]:
        x = torch.relu(dense(x, layer, dtype))
    x = dense(x, layers[-1], dtype)
    if "ln" in params:
        x = layer_norm(x, params["ln"])
    return x
