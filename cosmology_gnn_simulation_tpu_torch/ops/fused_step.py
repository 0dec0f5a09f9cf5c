"""Fused message-passing step tail around the CUDA kernels K5 (forward) and
K6 (backward) (counterpart of ``ops/fused_step.py``; the Pallas kernels
``_tail_kernel`` and ``_tail_bwd_kernel`` become ``csrc/fused_tail.cu`` and
``csrc/fused_tail_bwd.cu``).

    out = x + LN(W_f @ relu(W_h @ relu(x @ w_self + agg + b0) + b_h) + b_f)

in one pass over the rows: x and agg are read once and the result written
once, every intermediate staying on chip. Matmul operands are rounded to
``dtype`` with f32 accumulation, LayerNorm and the residual are f32, and the
output keeps ``x.dtype`` — the unfused path's precision policy, though not
bit-identical to it (the sums run in another order).

``fused_step_tail`` is differentiable, as the JAX ``custom_vjp`` is: only
the inputs are saved, and the backward recomputes the chain per row and
walks it in reverse (``fused_step_tail_bwd``: K6 on the card, its plain
version on the CPU), giving dx, dagg and every node-MLP and LayerNorm
gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.models.mlp import LN_EPS, layer_norm, matmul

# The kernels' fixed layout: latent = hidden = 128, one hidden Linear.
KERNEL_WIDTH = 128
KERNEL_LAYERS = 3


def kernel_takes(latent: int, hidden: int, num_layers: int, dtype) -> bool:
    """Whether K5 and K6 take a node MLP of this shape: bf16 operands,
    latent = hidden = 128 and ``num_layers`` = 3 Linears (one hidden)."""
    return (dtype == torch.bfloat16 and latent == hidden == KERNEL_WIDTH
            and num_layers == KERNEL_LAYERS)


def resolve_fused_tail(fused_tail, model_config, device, dtype) -> bool:
    """The rollout's and the train step's rule for ``fused_tail``: ``None``
    is on for the pruned model on a CUDA ``device`` where the kernels take
    the node MLP's shape (``kernel_takes``), off elsewhere; ``True`` needs
    the pruned model (the card then refuses shapes the kernels do not take)."""
    pruned = (model_config.aggregate == "sender_latents"
              and model_config.prune_dead_edge_stream)
    if fused_tail is None:
        return pruned and torch.device(device).type == "cuda" and kernel_takes(
            model_config.latent_size, model_config.mlp_hidden_size,
            model_config.mlp_num_hidden_layers + 1, dtype)
    if fused_tail and not pruned:
        raise ValueError("fused_tail requires the pruned sender_latents mode")
    return bool(fused_tail)


def _flatten(node_params, latent: int):
    """The JAX wrapper's flat weight order: (w_self, b0, (w_i, b_i)*, w_f,
    b_f, ln_scale, ln_bias). ``w_self`` is a slice of ``layers[0].w``
    ``[2L, H]`` taken here, outside the autograd Function, so its gradient
    flows back into the full first-layer weight."""
    layers = node_params["layers"]
    flat = [layers[0]["w"][:latent], layers[0]["b"]]
    for layer in layers[1:]:
        flat += [layer["w"], layer["b"]]
    return flat + [node_params["ln"]["scale"], node_params["ln"]["bias"]]


def _forward_plain(x, agg, flat, dtype):
    h = torch.relu(matmul(x, flat[0], dtype) + agg.float() + flat[1])
    for i in range(2, len(flat) - 4, 2):
        h = torch.relu(matmul(h, flat[i], dtype) + flat[i + 1])
    y = matmul(h, flat[-4], dtype) + flat[-3]
    y = layer_norm(y, {"scale": flat[-2], "bias": flat[-1]})
    return (x.float() + y).to(x.dtype)


def fused_step_tail_reference(x, agg, node_params, *, dtype=torch.bfloat16):
    """Plain PyTorch version of ``fused_step_tail`` (any layout, any dtype),
    differentiable by autograd."""
    return _forward_plain(x, agg, _flatten(node_params, x.shape[1]), dtype)


def _backward_plain(x, agg, g, flat, dtype):
    """The JAX ``_tail_bwd_kernel``'s arithmetic: recompute, then LayerNorm
    backward and the transposed products, every product on ``dtype``
    operands with f32 sums."""
    num_hidden = (len(flat) - 6) // 2
    x32, g32 = x.float(), g.float()
    pre = [matmul(x32, flat[0], dtype) + agg.float() + flat[1]]
    hs = [torch.relu(pre[0])]
    for i in range(num_hidden):
        pre.append(matmul(hs[-1], flat[2 + 2 * i], dtype) + flat[3 + 2 * i])
        hs.append(torch.relu(pre[-1]))
    wf, scale = flat[-4], flat[-2]
    y = matmul(hs[-1], wf, dtype) + flat[-3]
    yc = y - y.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((yc * yc).mean(dim=-1, keepdim=True) + LN_EPS)
    yn = yc * rstd
    dyn = g32 * scale
    dy = rstd * (dyn - dyn.mean(dim=-1, keepdim=True)
                 - yn * (dyn * yn).mean(dim=-1, keepdim=True))
    dscale, dbias = (g32 * yn).sum(0), g32.sum(0)
    dwf, dbf = matmul(hs[-1].t(), dy, dtype), dy.sum(0)
    dh = matmul(dy, wf.t(), dtype)
    dhidden = []
    for i in range(num_hidden - 1, -1, -1):
        dpre = torch.where(pre[i + 1] > 0, dh, 0.0)
        w = flat[2 + 2 * i]
        dhidden = [matmul(hs[i].t(), dpre, dtype), dpre.sum(0)] + dhidden
        dh = matmul(dpre, w.t(), dtype)
    dpre0 = torch.where(pre[0] > 0, dh, 0.0)
    dw0, db0 = matmul(x32.t(), dpre0, dtype), dpre0.sum(0)
    dx = (g32 + matmul(dpre0, flat[0].t(), dtype)).to(x.dtype)
    return dx, dpre0.to(agg.dtype), [dw0, db0, *dhidden, dwf, dbf, dscale, dbias]


def fused_step_tail_bwd_reference(x, agg, g, node_params, *, dtype=torch.bfloat16):
    """Plain PyTorch version of K6: ``(dx, dagg, grads)`` for the output
    cotangent ``g``, ``grads`` in the flat order (dw_self, db0, (dw_i,
    db_i)*, dw_f, db_f, dscale, dbias), all float32 but dx (``x.dtype``)
    and dagg (``agg.dtype``)."""
    return _backward_plain(x, agg, g, _flatten(node_params, x.shape[1]), dtype)


@functools.cache
def _lib(name: str):
    lib = kernels.library(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "fused_tail":
        entries = (lib.fused_tail_launch, lib.fused_tail_f32agg_launch)
        argtypes = [p] * 11 + [i, p]
    else:
        entries = (lib.fused_tail_bwd_launch, lib.fused_tail_bwd_f32agg_launch)
        argtypes = [p] * 14 + [i, p, i, p]
        lib.fused_tail_bwd_partial_floats.restype = i
    for entry in entries:
        entry.argtypes = argtypes
        entry.restype = i
    return lib


def _check_kernel_inputs(name, x, agg, flat, dtype, extra=()):
    n, latent = x.shape
    if dtype != torch.bfloat16:
        raise ValueError(f"{name} kernel takes bf16 operands, got {dtype}")
    if len(flat) != 2 * KERNEL_LAYERS + 2 or latent != KERNEL_WIDTH:
        raise ValueError(
            f"{name} kernel supports latent = hidden = 128 with one hidden "
            f"Linear; got latent {latent} and {(len(flat) - 2) // 2} layers"
        )
    if agg.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} kernel takes bf16 or f32 agg, got {agg.dtype}")
    shapes = [(128, 128), (128,)] * 3 + [(128,), (128,)]
    checks = [("x", x, (n, 128), torch.float32), ("agg", agg, (n, 128), agg.dtype)]
    checks += [(f"weight {i}", w, s, torch.float32)
               for i, (w, s) in enumerate(zip(flat, shapes))]
    for label, t in extra:
        checks.append((label, t, (n, 128), torch.float32))
    for label, t, shape, dt in checks:
        if t.device != x.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {label} must be a contiguous {dt} {shape} tensor "
                f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _tail_forward(x, agg, flat, dtype):
    """K5 on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return _forward_plain(x, agg, flat, dtype)
    _check_kernel_inputs("fused_step_tail", x, agg, flat, dtype)
    out = torch.empty_like(x)
    lib = _lib("fused_tail")
    launch = lib.fused_tail_launch if agg.dtype == torch.bfloat16 else lib.fused_tail_f32agg_launch
    err = launch(
        kernels.ptr(x), kernels.ptr(agg), *[kernels.ptr(w) for w in flat],
        kernels.ptr(out), x.shape[0], kernels.stream_handle(x.device),
    )
    kernels.check("fused_tail", err)
    kernels.launches["fused_tail"] += 1
    return out


def _tail_backward(x, agg, g, flat, dtype):
    """K6 on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return _backward_plain(x, agg, g, flat, dtype)
    _check_kernel_inputs("fused_step_tail_bwd", x, agg, flat, dtype, extra=[("g", g)])
    n = x.shape[0]
    lib = _lib("fused_tail_bwd")
    part = lib.fused_tail_bwd_partial_floats()
    max_blocks = torch.cuda.get_device_properties(x.device).multi_processor_count
    partials = torch.empty(max_blocks * part, dtype=torch.float32, device=x.device)
    grads = torch.empty(part, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dagg = torch.empty_like(agg)
    launch = (lib.fused_tail_bwd_launch if agg.dtype == torch.bfloat16
              else lib.fused_tail_bwd_f32agg_launch)
    err = launch(
        kernels.ptr(x), kernels.ptr(agg), kernels.ptr(g), *[kernels.ptr(w) for w in flat],
        kernels.ptr(dx), kernels.ptr(dagg), kernels.ptr(partials), max_blocks,
        kernels.ptr(grads), n, kernels.stream_handle(x.device),
    )
    kernels.check("fused_tail_bwd", err)
    kernels.launches["fused_tail_bwd"] += 1
    d = KERNEL_WIDTH
    dw0, dw1, dwf, db0, db1, dbf, dscale, dbias = torch.split(
        grads, [d * d] * 3 + [d] * 5)
    return dx, dagg, [dw0.view(d, d), db0, dw1.view(d, d), db1, dwf.view(d, d), dbf,
                      dscale, dbias]


def fused_step_tail_bwd(x, agg, g, node_params, *, dtype=torch.bfloat16):
    """K6: the fused recompute-backward (see ``fused_step_tail_bwd_reference``).
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/fused_tail_bwd.cu`` (K5's layout, f32 ``x`` and ``g``) or raise."""
    return _tail_backward(x, agg, g, _flatten(node_params, x.shape[1]), dtype)


class _FusedTail(torch.autograd.Function):
    """K5 forward, K6 backward; saves only the inputs (the JAX custom_vjp)."""

    @staticmethod
    def forward(ctx, x, agg, dtype, *flat):
        ctx.dtype = dtype
        ctx.save_for_backward(x, agg, *flat)
        return _tail_forward(x, agg, flat, dtype)

    @staticmethod
    def backward(ctx, g):
        x, agg, *flat = ctx.saved_tensors
        dx, dagg, dflat = _tail_backward(x, agg, g.contiguous(), flat, ctx.dtype)
        return (dx, dagg, None, *dflat)


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

    Differentiable in x, agg and every node-MLP and LayerNorm parameter:
    the backward is K6 (``fused_step_tail_bwd``). CPU tensors take the plain
    versions of both passes. CUDA tensors launch the kernels K5 and K6,
    which take the default model's layout — L = H = 128, one hidden Linear,
    f32 x and weights, bf16 operands, agg bf16 (the gather path) or f32 (the
    cell-block path); ``kernel_takes`` — and raise on any other.
    """
    return _FusedTail.apply(x, agg, dtype, *_flatten(node_params, x.shape[1]))
