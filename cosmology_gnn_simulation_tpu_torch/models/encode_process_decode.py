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
graph carries a cell-block plan the aggregation is instead the window
matmul K4 (``ops/cellblock.py``), whose backward is its S^T mode K4^T over
the plan's reverse table: on the cell-sorted particle rows
(``cellblock_mode="hybrid"``, expand -> K4 -> compact each step) or with
the carry in slot space (``"slots"``, expanded once after the encoder and
compacted once before the decoders). With ``fused_tail`` the step's tail
after the aggregation is the CUDA kernel K5, with K6 as its backward
(``ops/fused_step.py``). ``carry_dtype="bfloat16"`` carries the residual
stream in bf16, as the JAX package's scan carry.

Under particle sharding the rows a neighbor index names come from other
ranks too: all-gathered (the index-sharded path), or with ``halo`` the
shard's owned rows and its ring neighbours' boundary rows
(``parallel.halo.expand_candidates``), on which the halo x cell-block
composition runs K4 over the shard's local slab plan.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.utils.checkpoint

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
from cosmology_gnn_simulation_tpu_torch.ops.cellblock import (
    cellblock_aggregate,
    cellblock_aggregate_slots,
    compact_from_slots,
    expand_to_slots,
)
from cosmology_gnn_simulation_tpu_torch.ops.fused_step import fused_step_tail
from cosmology_gnn_simulation_tpu_torch.parallel.collectives import all_gather
from cosmology_gnn_simulation_tpu_torch.parallel.halo import expand_candidates
from cosmology_gnn_simulation_tpu_torch.types import ParticleGraph, resolve_device, tree_map

Params = Dict[str, Any]


class EncodeProcessDecodeConfig(NamedTuple):
    """Hyperparameters (the JAX config's fields, in its order)."""

    node_input_size: int  # 3*(window-1) + window = 17 at window 5
    edge_input_size: int = 4
    latent_size: int = 128
    mlp_hidden_size: int = 128
    mlp_num_hidden_layers: int = 2
    num_message_passing_steps: int = 10
    output_size: int = 3
    aggregate: str = "sender_latents"  # or "edge_messages"
    prune_dead_edge_stream: bool = True
    # The residual carry's dtype: None or "float32" (the same), or
    # "bfloat16": the carried [N, L] state, its residual adds and the edge
    # stream's are rounded to bf16 (K5 and K6 take a bf16 carry).
    carry_dtype: Optional[str] = None
    # Activation checkpointing: ``remat`` recomputes each message-passing
    # step in the backward pass instead of keeping its activations;
    # ``remat_chunk=c`` (dividing the step count) checkpoints each run of c
    # steps and each step inside it, and the encoder and decoder MLPs, so
    # the backward holds M/c + c carries instead of M.
    remat: bool = False
    remat_chunk: Optional[int] = None
    fused_tail: bool = False


def default_model_config(
    window_size: int = 5,
    latent_size: int = 128,
    mlp_hidden_size: int = 128,
    mlp_num_hidden_layers: int = 2,
    num_message_passing_steps: int = 10,
    output_size: int = 3,
    aggregate: str = "sender_latents",
    prune_dead_edge_stream: bool = True,
    remat: bool = False,
    remat_chunk: Optional[int] = None,
    carry_dtype: Optional[str] = None,
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
        remat=remat,
        remat_chunk=remat_chunk,
        carry_dtype=carry_dtype,
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


def _maybe_all_gather(values: torch.Tensor, particle_axis, halo=None) -> torch.Tensor:
    """The rows the neighbor indices name: this rank's alone; under
    ``particle_axis`` with ``halo`` (``parallel.halo.HaloSends``) the
    candidate rows ``[own; halo_from_left; halo_from_right]``, the boundary
    rows exchanged with the ring neighbours; else every rank's,
    all-gathered (once per message-passing step, in the compute dtype, as
    the JAX package's index-sharded path)."""
    if particle_axis is None:
        return values
    if halo is not None:
        return expand_candidates(values, halo, particle_axis)
    return all_gather(values, particle_axis)


def _processor_step(x, e, neighbors, params: Params, aggregate: str, dtype,
                    sorted_edges=None, particle_axis=None, halo=None):
    """One unpruned InteractionNetwork step (pre-residual outputs)."""
    latent = x.shape[-1]
    edge_first = params["edge"]["layers"][0]
    w = edge_first["w"]
    w_src, w_dst, w_e = w[:latent], w[latent:2 * latent], w[2 * latent:]
    y_src = _maybe_all_gather(matmul(x, w_src, dtype), particle_axis, halo)
    y_dst = matmul(x, w_dst, dtype)
    h_e = torch.relu(
        y_src[neighbors] + y_dst[:, None, :] + matmul(e, w_e, dtype) + edge_first["b"]
    )
    e_new = _mlp_tail(params["edge"], h_e, dtype)

    node_first = params["node"]["layers"][0]
    w_self, w_agg = node_first["w"][:latent], node_first["w"][latent:]
    if aggregate == "sender_latents":
        agg_h = _gather_sum(_maybe_all_gather(matmul(x, w_agg, dtype), particle_axis, halo),
                            neighbors, sorted_edges)
    elif aggregate == "edge_messages":
        agg_h = matmul(e_new.sum(dim=1), w_agg, dtype)
    else:
        raise ValueError(f"unknown aggregate mode: {aggregate}")
    h_n = torch.relu(matmul(x, w_self, dtype) + agg_h + node_first["b"])
    return _mlp_tail(params["node"], h_n, dtype), e_new


def _pruned_processor_step(x, neighbors, params: Params, dtype, fused_tail: bool,
                           cellblock=None, cellblock_spec=None, sorted_edges=None,
                           cellblock_mode: str = "slots", particle_axis=None, halo=None):
    """Node-stream-only step under ``sender_latents`` aggregation. With
    ``fused_tail`` it returns the full new carry (residual included, kernel
    K5); otherwise the pre-residual step output. With a ``cellblock`` plan
    the aggregation is the cell-block one (float32 result): ``"hybrid"``
    expands the projected latents to slots, runs K4 and compacts back;
    ``"slots"`` has ``x`` on slot rows already and runs K4 on them. With
    ``halo`` the plan is the shard's (``parallel.halo.HaloCellBlock``): the
    projected latents are exchanged, taken into the plan's order, aggregated
    (K4; K4^T in the backward) and taken back to the owned rows."""
    latent = x.shape[-1]
    node_first = params["node"]["layers"][0]
    w_self, w_agg = node_first["w"][:latent], node_first["w"][latent:]
    z = matmul(x, w_agg, dtype)
    if cellblock is not None and halo is not None:
        z_sorted = expand_candidates(z, halo, particle_axis)[cellblock.plan.order]
        agg_h = cellblock_aggregate(z_sorted, cellblock.plan, cellblock_spec,
                                    carry_dtype=torch.float32 if dtype is None else dtype)
        agg_h = agg_h[cellblock.inv_owned]
    elif cellblock is not None:
        aggregate = cellblock_aggregate if cellblock_mode == "hybrid" else cellblock_aggregate_slots
        agg_h = aggregate(z, cellblock, cellblock_spec,
                          carry_dtype=torch.float32 if dtype is None else dtype)
    else:
        if dtype is not None:
            # The gather-sum is the bandwidth-dominant op of the step; carry
            # it in the reduced dtype, as the JAX package does.
            z = z.to(dtype)
        agg_h = _gather_sum(_maybe_all_gather(z, particle_axis, halo), neighbors, sorted_edges)
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
    particle_axis=None,
    halo=None,
) -> Dict[str, torch.Tensor]:
    """Forward pass: ``{'acceleration': [N, 3], 'temp_rate': [N, 1]}``.

    When ``graph.cellblock`` is set (rows cell-sorted; ``cellblock_spec``
    the plan's spec) the pruned path aggregates through the cell-block
    plan. ``cellblock_mode="hybrid"`` keeps the carry on the N particle
    rows and pays expand -> K4 -> compact each step; ``"slots"`` expands
    the carry to the plan's slot rows once after the encoder, runs every
    step there (empty and reserve slot rows carry zeros through, which stay
    finite) and compacts once before the decoders.

    ``config.remat`` / ``config.remat_chunk`` checkpoint the steps
    (non-reentrant ``torch.utils.checkpoint``, as the JAX package's
    ``jax.checkpoint``): the backward recomputes each checkpointed region's
    forward, its kernels included, before that region's backward.

    ``particle_axis`` (a ``parallel.mesh.MeshAxis``; the graph from
    ``featurize(..., particle_axis=...)``): ``graph`` holds this rank's rows
    of particles sharded over the axis, with neighbor indices into the
    gathered rows. Each message-passing step all-gathers the projected
    sender latents (``y_src`` too in the unpruned model); everything else,
    the fused tail K5 included, runs on the local rows. With ``halo`` (the
    ``parallel.halo.HaloSends`` of ``featurize_halo``'s graph) the neighbor
    indices name the candidate rows ``[own; halo_from_left;
    halo_from_right]`` instead, and each step exchanges the projected
    boundary rows with the ring neighbours; a graph with a
    ``parallel.halo.HaloCellBlock`` then aggregates through the shard's slab
    plan (``cellblock_mode="hybrid"`` only). The cell-block aggregation is
    refused under the index-sharded path (``halo`` None), as in the JAX
    package.
    """
    if cellblock_mode not in ("slots", "hybrid"):
        raise ValueError(f"unknown cellblock_mode: {cellblock_mode}")
    prune = config.aggregate == "sender_latents" and config.prune_dead_edge_stream
    if graph.cellblock is not None:
        if cellblock_spec is None:
            raise ValueError(
                "graph carries a cellblock plan but cellblock_spec was not passed"
            )
        if particle_axis is not None and halo is None:
            raise ValueError(
                "cellblock aggregation under the index-sharded all-gather path is "
                "unsupported — use halo sharding (featurize_halo(cellblock_spec=...))"
            )
        if halo is not None and cellblock_mode != "hybrid":
            raise ValueError(
                "the halo x cellblock composition requires cellblock_mode='hybrid' (the "
                "residual carry stays on the owned particle rows; slot space is shard-local)"
            )
        if not prune:
            raise ValueError(
                "cellblock aggregation requires the pruned sender_latents mode "
                "(the edge_messages gather is not a segment sum)"
            )
    if config.fused_tail and not prune:
        raise ValueError(
            "fused_tail requires the pruned sender_latents mode (the edge "
            "stream's tail is not fused)"
        )
    if config.carry_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"unknown carry_dtype: {config.carry_dtype!r}")
    carry_dt = getattr(torch, config.carry_dtype) if config.carry_dtype else None

    def residual_add(carry, new):
        return carry + new if carry_dt is None else carry + new.to(carry_dt)

    chunk = config.remat_chunk
    m = config.num_message_passing_steps
    two_level = chunk is not None and chunk > 1
    if two_level and m % chunk:
        raise ValueError(
            f"remat_chunk={chunk} must divide num_message_passing_steps={m}"
        )
    mlp_fn = functools.partial(_checkpoint, apply_mlp) if two_level else apply_mlp

    if prune:
        def step(i, x):
            x_new = _pruned_processor_step(
                x, graph.neighbors, step_params(params, i), dtype, config.fused_tail,
                graph.cellblock, cellblock_spec, graph.sorted_edges, cellblock_mode,
                particle_axis, halo,
            )
            return (x_new if config.fused_tail else residual_add(x, x_new),)
    else:
        def step(i, x, e):
            x_new, e_new = _processor_step(
                x, e, graph.neighbors, step_params(params, i), config.aggregate, dtype,
                graph.sorted_edges, particle_axis, halo,
            )
            return residual_add(x, x_new), residual_add(e, e_new)

    if config.remat or two_level:
        step = functools.partial(_checkpoint, step)

    def run_steps(first, last, *carry):
        for i in range(first, last):
            carry = step(i, *carry)
        return carry

    def carried(t):
        return t if carry_dt is None else t.to(carry_dt)

    x = carried(mlp_fn(params["encoder"]["node"], graph.nodes, dtype))
    slots_mode = graph.cellblock is not None and cellblock_mode == "slots"
    if slots_mode:
        x = expand_to_slots(x, graph.cellblock)
    carry = (x,) if prune else (x, carried(mlp_fn(params["encoder"]["edge"], graph.edges,
                                                  dtype)))
    if two_level:
        for first in range(0, m, chunk):
            carry = _checkpoint(run_steps, first, first + chunk, *carry)
    else:
        carry = run_steps(0, m, *carry)
    x = carry[0]
    if slots_mode:
        x = compact_from_slots(x, graph.cellblock)
    return {
        "acceleration": mlp_fn(params["decoder_acc"], x, dtype),
        "temp_rate": mlp_fn(params["decoder_temp_rate"], x, dtype),
    }


def _checkpoint(fn, *args):
    """``fn(*args)`` whose activations are recomputed in the backward pass
    (non-reentrant ``torch.utils.checkpoint``; the steps draw no random
    numbers, so no RNG state is kept)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)
