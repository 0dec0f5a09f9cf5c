"""Encode-Process-Decode interaction network (counterpart of
``models/encode_process_decode.py``), gather or hybrid cell-block
aggregation, differentiable on both.

Semantics of the JAX package, kept exactly:

* encoder node/edge MLPs with LayerNorm; M processor steps with unshared
  weights, stacked on a leading ``[M]`` axis as in the JAX param pytree;
  residuals on node and edge latents; two decoder heads without LayerNorm;
* ``aggregate="sender_latents"`` scatter-adds SENDER NODE LATENTS at each
  receiver (the reference's aggregation); the edge stream then never reaches
  the outputs, and ``prune_dead_edge_stream`` skips it;
* the aggregation ``sum_j x_j @ W_agg`` runs as a gather-sum of the
  pre-projected rows ``z = x @ W_agg``; in the pruned path with a reduced
  ``dtype`` z is carried in that dtype through the gather.

The gather-sum stays plain PyTorch (``index_select`` + ``sum``): in the JAX
package it is XLA, not a Pallas kernel; with ``graph.sorted_edges`` its
backward is the sorted-edge segment sum (``ops/aggregation.py``). When the
graph carries a cell-block plan (``cellblock_mode="hybrid"``) the
aggregation is instead the window matmul K4 (``ops/cellblock.py``) on the
cell-sorted rows, whose backward is its S^T mode K4^T over the plan's
reverse table. With ``fused_tail`` the step's tail after the aggregation is
the CUDA kernel K5, with K6 as its backward (``ops/fused_step.py``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from cosmology_gnn_simulation_tpu_torch.featurize import node_feature_size
from cosmology_gnn_simulation_tpu_torch.models.mlp import (
    apply_mlp,
    dense,
    init_mlp,
    layer_norm,
    matmul,
)
from cosmology_gnn_simulation_tpu_torch.ops.aggregation import (
    aggregate_sender_latents,
    gather_sum,
)
from cosmology_gnn_simulation_tpu_torch.ops.cellblock import cellblock_aggregate
from cosmology_gnn_simulation_tpu_torch.ops.fused_step import fused_step_tail
from cosmology_gnn_simulation_tpu_torch.types import ParticleGraph, resolve_device, tree_map

Params = Dict[str, Any]


class EncodeProcessDecodeConfig(NamedTuple):
    """Hyperparameters (the JAX config's forward-pass fields)."""

    node_input_size: int  # 3*(window-1) + window = 17 at window 5
    edge_input_size: int = 4
    latent_size: int = 128
    mlp_hidden_size: int = 128
    mlp_num_hidden_layers: int = 2
    num_message_passing_steps: int = 10
    output_size: int = 3
    aggregate: str = "sender_latents"  # or "edge_messages"
    prune_dead_edge_stream: bool = True
    fused_tail: bool = False
    # Activation checkpointing (the JAX config's remat / remat_chunk): not
    # ported; any other value than the default raises.
    remat: bool = False
    remat_chunk: Optional[int] = None


def default_model_config(
    window_size: int = 5,
    latent_size: int = 128,
    mlp_hidden_size: int = 128,
    mlp_num_hidden_layers: int = 2,
    num_message_passing_steps: int = 10,
    output_size: int = 3,
    aggregate: str = "sender_latents",
    prune_dead_edge_stream: bool = True,
) -> EncodeProcessDecodeConfig:
    """The default model (the JAX ``training.trainer.default_model_config``)."""
    return EncodeProcessDecodeConfig(
        node_input_size=node_feature_size(window_size),
        edge_input_size=4,
        latent_size=latent_size,
        mlp_hidden_size=mlp_hidden_size,
        mlp_num_hidden_layers=mlp_num_hidden_layers,
        num_message_passing_steps=num_message_passing_steps,
        output_size=output_size,
        aggregate=aggregate,
        prune_dead_edge_stream=prune_dead_edge_stream,
    )


def init_encode_process_decode(
    config: EncodeProcessDecodeConfig, generator: torch.Generator, device="cuda"
) -> Params:
    """Random float32 params (torch ``nn.Linear`` init), drawn on the CPU from
    ``generator`` — so a seed gives the same weights on every device — and
    moved to ``device``. Same tree as the JAX params."""
    device = resolve_device(device)
    latent, hidden = config.latent_size, config.mlp_hidden_size
    n_hidden = config.mlp_num_hidden_layers

    def mlp_ln(in_dim):
        return init_mlp(generator, in_dim, hidden, n_hidden, latent, layer_norm=True)

    params = {
        "encoder": {
            "node": mlp_ln(config.node_input_size),
            "edge": mlp_ln(config.edge_input_size),
        },
        "processor": tree_map(lambda *xs: torch.stack(xs), *[
            {"edge": mlp_ln(3 * latent), "node": mlp_ln(2 * latent)}
            for _ in range(config.num_message_passing_steps)
        ]),
        "decoder_acc": init_mlp(generator, latent, hidden, n_hidden, config.output_size),
        "decoder_temp_rate": init_mlp(generator, latent, hidden, n_hidden, 1),
    }
    return tree_map(lambda t: t.to(device), params)


def step_params(params: Params, i: int) -> Params:
    """Processor step ``i``'s params out of the stacked ``[M]`` tree."""
    return tree_map(lambda t: t[i], params["processor"])


def _mlp_tail(params: Params, h: torch.Tensor, dtype) -> torch.Tensor:
    """Hidden layers after the (externally computed) first layer, + final + LN."""
    layers = params["layers"]
    for layer in layers[1:-1]:
        h = torch.relu(dense(h, layer, dtype))
    h = dense(h, layers[-1], dtype)
    if "ln" in params:
        h = layer_norm(h, params["ln"])
    return h


def _gather_sum(values: torch.Tensor, neighbors: torch.Tensor, sorted_edges=None) -> torch.Tensor:
    """``out[i] = sum_j values[neighbors[i, j]]`` in ``values.dtype``. With
    ``sorted_edges`` (training graphs) the backward is the sorted-edge
    segment sum (``ops/aggregation.py``); without, autograd's own."""
    if sorted_edges is not None:
        return aggregate_sender_latents(values, neighbors, sorted_edges)
    return gather_sum(values, neighbors)


def _processor_step(x, e, neighbors, params: Params, aggregate: str, dtype,
                    sorted_edges=None):
    """One unpruned InteractionNetwork step (pre-residual outputs)."""
    latent = x.shape[-1]
    edge_first = params["edge"]["layers"][0]
    w = edge_first["w"]
    w_src, w_dst, w_e = w[:latent], w[latent:2 * latent], w[2 * latent:]
    y_src = matmul(x, w_src, dtype)
    y_dst = matmul(x, w_dst, dtype)
    h_e = torch.relu(
        y_src[neighbors] + y_dst[:, None, :] + matmul(e, w_e, dtype) + edge_first["b"]
    )
    e_new = _mlp_tail(params["edge"], h_e, dtype)

    node_first = params["node"]["layers"][0]
    w_self, w_agg = node_first["w"][:latent], node_first["w"][latent:]
    if aggregate == "sender_latents":
        agg_h = _gather_sum(matmul(x, w_agg, dtype), neighbors, sorted_edges)
    elif aggregate == "edge_messages":
        agg_h = matmul(e_new.sum(dim=1), w_agg, dtype)
    else:
        raise ValueError(f"unknown aggregate mode: {aggregate}")
    h_n = torch.relu(matmul(x, w_self, dtype) + agg_h + node_first["b"])
    return _mlp_tail(params["node"], h_n, dtype), e_new


def _pruned_processor_step(x, neighbors, params: Params, dtype, fused_tail: bool,
                           cellblock=None, cellblock_spec=None, sorted_edges=None):
    """Node-stream-only step under ``sender_latents`` aggregation. With
    ``fused_tail`` it returns the full new carry (residual included, kernel
    K5); otherwise the pre-residual step output. With a ``cellblock`` plan
    the aggregation is the hybrid cell-block one: expand the projected
    latents to slots, K4, compact back (float32 result)."""
    latent = x.shape[-1]
    node_first = params["node"]["layers"][0]
    w_self, w_agg = node_first["w"][:latent], node_first["w"][latent:]
    z = matmul(x, w_agg, dtype)
    if cellblock is not None:
        agg_h = cellblock_aggregate(
            z, cellblock, cellblock_spec,
            carry_dtype=torch.float32 if dtype is None else dtype,
        )
    else:
        if dtype is not None:
            # The gather-sum is the bandwidth-dominant op of the step; carry
            # it in the reduced dtype, as the JAX package does.
            z = z.to(dtype)
        agg_h = _gather_sum(z, neighbors, sorted_edges)
    if fused_tail:
        # The kernel widens agg on read: no f32 copy of it is made.
        return fused_step_tail(
            x, agg_h, params["node"], dtype=torch.float32 if dtype is None else dtype
        )
    h_n = torch.relu(matmul(x, w_self, dtype) + agg_h.float() + node_first["b"])
    return _mlp_tail(params["node"], h_n, dtype)


def apply_encode_process_decode(
    params: Params,
    graph: ParticleGraph,
    config: EncodeProcessDecodeConfig,
    dtype: Optional[torch.dtype] = None,
    cellblock_spec=None,
    cellblock_mode: str = "slots",
) -> Dict[str, torch.Tensor]:
    """Forward pass: ``{'acceleration': [N, 3], 'temp_rate': [N, 1]}``.

    When ``graph.cellblock`` is set (rows cell-sorted; ``cellblock_spec``
    the plan's spec) the pruned path aggregates through the cell-block
    plan. ``cellblock_mode="hybrid"`` keeps the carry on the N particle
    rows and pays expand -> K4 -> compact each step; the JAX package's
    slot-space carry (``"slots"``) is not ported and raises.
    """
    if cellblock_mode not in ("slots", "hybrid"):
        raise ValueError(f"unknown cellblock_mode: {cellblock_mode}")
    prune = config.aggregate == "sender_latents" and config.prune_dead_edge_stream
    if graph.cellblock is not None:
        if cellblock_spec is None:
            raise ValueError(
                "graph carries a cellblock plan but cellblock_spec was not passed"
            )
        if not prune:
            raise ValueError(
                "cellblock aggregation requires the pruned sender_latents mode "
                "(the edge_messages gather is not a segment sum)"
            )
        if cellblock_mode != "hybrid":
            raise NotImplementedError(
                "cellblock_mode='slots' (slot-space carry) is not ported; use 'hybrid'"
            )
    if config.fused_tail and not prune:
        raise ValueError(
            "fused_tail requires the pruned sender_latents mode (the edge "
            "stream's tail is not fused)"
        )
    if config.remat or (config.remat_chunk or 0) > 1:
        raise NotImplementedError("remat / remat_chunk (activation checkpointing) "
                                  "is not ported")
    x = apply_mlp(params["encoder"]["node"], graph.nodes, dtype)
    m = config.num_message_passing_steps
    if prune:
        for i in range(m):
            x_new = _pruned_processor_step(
                x, graph.neighbors, step_params(params, i), dtype, config.fused_tail,
                graph.cellblock, cellblock_spec, graph.sorted_edges,
            )
            x = x_new if config.fused_tail else x + x_new
    else:
        e = apply_mlp(params["encoder"]["edge"], graph.edges, dtype)
        for i in range(m):
            x_new, e_new = _processor_step(
                x, e, graph.neighbors, step_params(params, i), config.aggregate, dtype,
                graph.sorted_edges,
            )
            x, e = x + x_new, e + e_new
    return {
        "acceleration": apply_mlp(params["decoder_acc"], x, dtype),
        "temp_rate": apply_mlp(params["decoder_temp_rate"], x, dtype),
    }
