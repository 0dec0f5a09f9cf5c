"""Index-sharded training, evaluation, forward and rollout over a
``(data, particle)`` mesh (counterpart of ``parallel/sharded.py``).

* Data parallelism: the batch's samples are split over the ``data`` axis;
  the parameter gradients are summed over every rank.
* Particle parallelism: each rank owns ``N / P`` particle rows (rank
  coordinate p the rows ``p * N/P`` to ``(p + 1) * N/P``). The search
  all-gathers the ``[N, 3]`` recent positions, and each message-passing step
  the projected ``[N, H]`` latents; edge tensors stay rank-local. Exact, not
  an approximation.

Every function here runs on each rank of the mesh with that rank's slice of
the data (``shard_batch``) and returns that rank's part of the result.

Loss semantics under sharding (the JAX package's):
* the acceleration and temperature-rate MSEs are per-shard means combined
  by ``pmean`` over ``particle`` (equal shard sizes make it the global
  mean);
* the momentum penalty squares the per-graph impulse ``psum``-ed over
  ``particle`` (a nonlinear function of the global sum);
* then the means over the local batch, ``pmean``-ed over ``data``; the
  parameter gradients are summed over both axes by one all-reduce of a flat
  buffer of every leaf (``collectives.all_reduce_flat``). With the
  collectives' transposes that is the loss's gradient, the single-device
  step's. The JAX package's sharded step gives P times it on P devices
  (its psum and pmean transpose to a psum inside ``shard_map`` before the
  final sum); Adam's update does not see a common scale, but weight decay
  and ``eps`` do.

Randomness: each sample of a train step draws from its own generators,
keyed by ``(seed, step, global sample index)``: the axis permutation is then
the same on every particle shard of a sample, and the noise generator's key
also takes the particle coordinate, so the noise is independent per shard
(as the JAX package folds ``axis_index`` into the feature key).

The sharded train step sorts each sample's edge stream over the gathered
rows (``build_sorted_edges(neighbors, N)``) when ``build_reverse`` is on, so
its aggregation backward is the single-device step's deterministic segment
sum, and on a mesh of one rank the step is the single-device step.
Cell-block aggregation is refused under a mesh, as the JAX CLI refuses it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch.featurize import featurize, neighbor_search
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
    apply_encode_process_decode,
)
from cosmology_gnn_simulation_tpu_torch.ops.aggregation import build_sorted_edges
from cosmology_gnn_simulation_tpu_torch.ops.fused_step import resolve_fused_tail
from cosmology_gnn_simulation_tpu_torch.ops.periodic import wrap_positions
from cosmology_gnn_simulation_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_flat,
    pmean,
    psum,
)
from cosmology_gnn_simulation_tpu_torch.parallel.mesh import DATA_AXIS, PARTICLE_AXIS, Mesh
from cosmology_gnn_simulation_tpu_torch.training.trainer import (
    Optimizer,
    TrainConfig,
    _augment_axes,
    _prepare,
)
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves

_BATCH_KEYS = ("positions", "temperatures", "target_positions", "target_temperatures")


def _pruned(model_config: EncodeProcessDecodeConfig, tc: TrainConfig) -> bool:
    """The checks of a sharded step; whether the model is the pruned one."""
    if tc.aggregation not in ("auto", "gather"):
        raise ValueError(f"aggregation={tc.aggregation!r} is single-device only: the cell "
                         "block does not compose with the index-sharded path (the halo path, "
                         "parallel.halo, does)")
    if tc.partition_invariant_noise:
        raise ValueError("partition_invariant_noise does not apply to the index-sharded path, "
                         "which keys its noise per sample and particle coordinate (the JAX "
                         "sharded step never reads the flag)")
    resolve_fused_tail(tc.fused_tail, model_config, "cpu", None)  # the pruned check
    return model_config.aggregate == "sender_latents" and model_config.prune_dead_edge_stream


def _sample_generators(seed: int, step: int, sample: int, particle_index: int, device):
    """The augmentation and noise generators of one sample of one train
    step; only the noise's key takes the particle coordinate."""
    def generator(*key):
        state = np.random.SeedSequence([seed, step, sample, *key]).generate_state(1)
        return torch.Generator(device=device).manual_seed(int(state[0]))

    return generator(0), generator(1, particle_index)


def _per_sample_terms(params, batch, cfg, stats, tc, dtype, pruned, mesh: Mesh, step: int,
                      train: bool):
    """Per local sample: the acceleration and temperature-rate MSEs (global
    per-sample means) and the momentum penalty of the global impulse
    (unweighted), each ``[B_local]``."""
    data, particle = mesh.axis(DATA_AXIS), mesh.axis(PARTICLE_AXIS)
    b_local, n_global = batch["positions"].shape[0], batch["positions"].shape[2] * particle.size
    acc_se, temp_se, impulse = [], [], []
    for b in range(b_local):
        pos, tpos = batch["positions"][b], batch["target_positions"][b]
        noise = None
        if train:
            augment, noise = _sample_generators(tc.seed, step, data.index * b_local + b,
                                                particle.index, pos.device)
            pos, tpos = _augment_axes(augment, pos, tpos, tc.augment_prob)
        graph = featurize(pos, batch["temperatures"][b], stats, generator=noise,
                          noise_std=tc.noise_std if train else 0.0,
                          num_neighbors=tc.num_neighbors, neighbor_method=tc.neighbor_method,
                          neighbor_query_tile=tc.neighbor_query_tile, target_position=tpos,
                          target_temperature=batch["target_temperatures"][b],
                          build_edges=not pruned, particle_axis=particle)
        if train and tc.build_reverse:
            graph = graph._replace(sorted_edges=build_sorted_edges(graph.neighbors, n_global))
        preds = apply_encode_process_decode(params, graph, cfg, dtype, particle_axis=particle)
        acc_se.append(torch.mean((preds["acceleration"] - graph.target_acceleration) ** 2))
        temp_se.append(torch.mean((preds["temp_rate"] - graph.target_temp_rate) ** 2))
        impulse.append(torch.sum(preds["acceleration"] * stats.dt, dim=0))
    means = pmean(torch.stack([torch.stack(acc_se), torch.stack(temp_se)]), particle)
    momentum = torch.sum(psum(torch.stack(impulse), particle) ** 2, dim=-1)
    return means[0], means[1], momentum


def _sharded_loss(acc_se, temp_se, momentum, tc: TrainConfig, mesh: Mesh):
    """The scalar loss and its components, the same on every rank."""
    acc_loss, temp_loss, momentum_mean = pmean(
        torch.stack([acc_se.mean(), temp_se.mean(), momentum.mean()]), mesh.axis(DATA_AXIS))
    momentum_loss = tc.momentum_loss_weight * momentum_mean
    total = (tc.acc_loss_weight * acc_loss + tc.temp_rate_loss_weight * temp_loss
             + momentum_loss)
    return total, {"acceleration": acc_loss, "temp_rate": temp_loss, "momentum": momentum_loss}


def make_data_parallel_train_step(
    model_config: EncodeProcessDecodeConfig,
    stats: NormalizationStats,
    train_config: TrainConfig,
    optimizer: Optimizer,
    mesh: Mesh,
) -> Callable:
    """The sharded train step ``(params, opt_state, batch, step) ->
    (params, opt_state, metrics)`` for a ``(data, particle)`` mesh, run on
    every rank: ``batch`` is this rank's slice (``shard_batch``), ``step``
    the global step index that keys the randomness, and ``params`` (on
    ``mesh.device``) and ``opt_state`` are updated in place, identically on
    every rank. ``metrics`` as ``make_train_step``'s, the same on every
    rank."""
    tc = train_config
    dtype = getattr(torch, tc.compute_dtype) if tc.compute_dtype else None
    pruned = _pruned(model_config, tc)

    def train_step(params, opt_state, batch, step: int):
        batch, cfg = _prepare(params, batch, model_config, tc, dtype)
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, components = _sharded_loss(
            *_per_sample_terms(params, batch, cfg, stats, tc, dtype, pruned, mesh, step, True),
            tc, mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        optimizer.apply(opt_state, all_reduce_flat(grads))
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in components.items()}}
        return params, opt_state, metrics

    return train_step


def make_sharded_eval_step(
    model_config: EncodeProcessDecodeConfig,
    stats: NormalizationStats,
    train_config: TrainConfig,
    mesh: Mesh,
    *,
    per_sample: bool = False,
) -> Callable:
    """Sharded validation step ``(params, batch) -> metrics`` (no noise, no
    augmentation, no gradient), ``batch`` this rank's slice. Batch-mean
    scalars, or with ``per_sample=True`` ``[B]`` vectors over the global
    batch (gathered over ``data``), so a caller can pad a tail batch and
    mask the padding out."""
    tc = dataclasses.replace(train_config, noise_std=0.0, augment_prob=0.0)
    dtype = getattr(torch, tc.compute_dtype) if tc.compute_dtype else None
    pruned = _pruned(model_config, tc)

    @torch.no_grad()
    def eval_step(params, batch) -> Dict[str, torch.Tensor]:
        batch, cfg = _prepare(params, batch, model_config, tc, dtype)
        acc_se, temp_se, momentum = _per_sample_terms(params, batch, cfg, stats, tc, dtype,
                                                      pruned, mesh, 0, False)
        if not per_sample:
            total, components = _sharded_loss(acc_se, temp_se, momentum, tc, mesh)
            return {"loss": total, **components}
        momentum = tc.momentum_loss_weight * momentum
        total = tc.acc_loss_weight * acc_se + tc.temp_rate_loss_weight * temp_se + momentum
        rows = all_gather(torch.stack([total, acc_se, temp_se, momentum], dim=1),
                          mesh.axis(DATA_AXIS))
        return dict(zip(("loss", "acceleration", "temp_rate", "momentum"), rows.unbind(1)))

    return eval_step


def make_particle_sharded_forward(
    model_config: EncodeProcessDecodeConfig,
    stats: NormalizationStats,
    mesh: Mesh,
    *,
    num_neighbors: int = 16,
    dtype=None,
    neighbor_query_tile: int = 512,
) -> Callable:
    """Particle-sharded inference ``(params, position_seq [T, N/P, 3],
    temperature_seq [T, N/P, 1]) -> {'acceleration' [N/P, 3], 'temp_rate'
    [N/P, 1]}`` on this rank's rows (the data axis replicated); the fused
    tail where the rollout's default turns it on."""
    particle = mesh.axis(PARTICLE_AXIS)
    cfg = model_config._replace(
        fused_tail=resolve_fused_tail(None, model_config, mesh.device, dtype))
    pruned = model_config.aggregate == "sender_latents" and model_config.prune_dead_edge_stream

    @torch.no_grad()
    def forward(params, position_seq, temperature_seq):
        graph = featurize(torch.as_tensor(position_seq, device=mesh.device).float(),
                          torch.as_tensor(temperature_seq, device=mesh.device).float(), stats,
                          num_neighbors=num_neighbors, neighbor_query_tile=neighbor_query_tile,
                          build_edges=not pruned, particle_axis=particle)
        return apply_encode_process_decode(params, graph, cfg, dtype, particle_axis=particle)

    return forward


def make_sharded_rollout(
    model_config: EncodeProcessDecodeConfig,
    stats: NormalizationStats,
    mesh: Mesh,
    num_steps: int,
    *,
    num_neighbors: int = 16,
    min_image_velocity: bool = False,
    dtype=None,
    neighbor_query_tile: int = 512,
    neighbor_method: str = "auto",
    reneighbor_every: int = 1,
) -> Callable:
    """Particle-sharded rollout ``(params, initial_positions [W, N/P, 3],
    initial_temperatures [W, N/P, 1]) -> {"Coordinates": [W + S, N/P, 3],
    "InternalEnergy": [W + S, N/P, 1]}`` on this rank's rows. Each step
    all-gathers the wrapped positions for a search every ``reneighbor_every``
    steps and the projected latents each message-passing step; the
    trajectory, the integration and the edge tensors stay rank-local. The
    fused tail where the rollout's default turns it on."""
    from cosmology_gnn_simulation_tpu_torch.rollout import integrate_step

    if reneighbor_every < 1:
        raise ValueError(f"reneighbor_every must be >= 1, got {reneighbor_every}")
    particle = mesh.axis(PARTICLE_AXIS)
    cfg = model_config._replace(
        fused_tail=resolve_fused_tail(None, model_config, mesh.device, dtype))
    pruned = model_config.aggregate == "sender_latents" and model_config.prune_dead_edge_stream
    box = stats.box_size

    @torch.no_grad()
    def rollout_fn(params, initial_positions, initial_temperatures):
        pos_window = torch.as_tensor(initial_positions, device=mesh.device).float()
        temp_window = torch.as_tensor(initial_temperatures, device=mesh.device).float()
        positions, temperatures = [pos_window], [temp_window]
        neighbors = None
        for step in range(num_steps):
            if step % reneighbor_every == 0:
                local = wrap_positions(pos_window[-1], box)
                neighbors = neighbor_search(
                    all_gather(local, particle), num_neighbors, box,
                    queries=local if particle.size > 1 else None, method=neighbor_method,
                    query_tile=neighbor_query_tile)
            graph = featurize(pos_window, temp_window, stats, neighbors, build_edges=not pruned,
                              particle_axis=particle)
            preds = apply_encode_process_decode(params, graph, cfg, dtype,
                                                particle_axis=particle)
            new_position, new_temperature = integrate_step(
                pos_window[-1], pos_window[-2], temp_window[-1],
                preds["acceleration"] * stats.acc_std + stats.acc_mean,
                preds["temp_rate"] * stats.temp_rate_std + stats.temp_rate_mean, stats,
                min_image_velocity=min_image_velocity)
            pos_window = torch.cat([pos_window[1:], new_position[None]])
            temp_window = torch.cat([temp_window[1:], new_temperature[None]])
            positions.append(new_position[None])
            temperatures.append(new_temperature[None])
        return {"Coordinates": torch.cat(positions), "InternalEnergy": torch.cat(temperatures)}

    return rollout_fn


def shard_batch(batch, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of a global batch (``positions [B, T, N, 3]``,
    ``temperatures [B, T, N, 1]``, ``target_positions [B, N, 3]``,
    ``target_temperatures [B, N, 1]``; arrays or tensors): its samples along
    ``data`` and its particle rows along ``particle``, as float32 tensors on
    ``mesh.device``. The sizes must divide (checked here)."""
    data, particle = mesh.axis(DATA_AXIS), mesh.axis(PARTICLE_AXIS)
    b, n = batch["positions"].shape[0], batch["positions"].shape[2]
    if b % data.size:
        raise ValueError(f"global batch size {b} not divisible by data-axis size {data.size}")
    if n % particle.size:
        raise ValueError(f"particle count {n} not divisible by particle-axis size "
                         f"{particle.size}")
    bl, nl = b // data.size, n // particle.size
    rows = slice(data.index * bl, (data.index + 1) * bl)
    cols = slice(particle.index * nl, (particle.index + 1) * nl)
    out = {}
    for key in _BATCH_KEYS:
        value = torch.as_tensor(batch[key])[rows]
        value = value[:, :, cols] if value.dim() == 4 else value[:, cols]
        out[key] = value.to(mesh.device, torch.float32).contiguous()
    return out
