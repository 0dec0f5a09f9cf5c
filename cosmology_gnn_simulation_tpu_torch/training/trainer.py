"""The train and eval steps and their optimizer (counterpart of
``training/trainer.py``: ``TrainConfig``, ``_augment_axes``,
``make_train_step``, ``make_eval_step``, ``make_optimizer``).

One train step does what the JAX package's jitted, vmapped step does, in
eager PyTorch: per sample of the batch (a Python loop in place of ``vmap``)
a random xyz permutation of input and target coordinates, random-walk
noise, the k-NN graph, the forward pass and the targets; then the
three-term loss over the batch, autograd, and one optimizer update.

Aggregation: ``"gather"`` (K1, then the sorted-edge segment-sum backward
with ``build_reverse``), or ``"cellblock_hybrid"``: the K1' codes search,
the plan with its reverse table (K2, K3, K7; from neighbor ids, the aux
path, when another search served, as brute force does below 8192
particles with ``neighbor_method="auto"``), nodes and targets permuted
into the plan's cell-sorted order (the losses do not depend on row order),
and K4 forward / K4^T backward each message-passing step. ``"auto"``
resolves to ``"gather"``, as the port's rollout and the JAX dispatch off
the TPU do. ``fused_tail=None`` turns the fused tail (K5 forward, K6
backward) on for the pruned model on CUDA where the kernels take the shape
(``ops.fused_step.resolve_fused_tail``).

The optimizer is ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8 outside
the square root: ``optax.scale_by_adam``), whose coupled ``weight_decay``
is ``optax.add_decayed_weights`` placed before it, with the learning rate
``lr * gamma ** (step // steps_per_epoch)``. The parameter tree's leaves
are updated in place.

Not ported: the slot-space ``"cellblock"`` aggregation, variable cell-block
capacities, per-particle noise keying (``partition_invariant_noise``) and
activation checkpointing; each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from cosmology_gnn_simulation_tpu_torch.featurize import featurize
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
    apply_encode_process_decode,
)
from cosmology_gnn_simulation_tpu_torch.ops.cellblock import (
    build_cellblock,
    choose_cellblock_spec,
)
from cosmology_gnn_simulation_tpu_torch.ops.fused_step import resolve_fused_tail
from cosmology_gnn_simulation_tpu_torch.training.losses import combined_loss
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves

# All 6 permutations of the xyz axes (the reference draws torch.randperm(3)).
AXIS_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the JAX ``TrainConfig``: same fields and
    defaults; ``output_dir``, ``save_every``, ``halt_on_nonfinite``,
    ``profile_epoch`` and ``strict_neighbor_check`` belong to the
    epoch-driven trainer, which is not ported yet)."""

    num_neighbors: int = 16
    batch_size: int = 1
    window_size: int = 5
    noise_std: float = 0.0
    num_epochs: int = 10
    learning_rate: float = 1e-4
    final_learning_rate: float = 1e-4
    weight_decay: float = 0.0
    seed: int = 42
    save_every: int = 10
    augment_prob: float = 1.0
    acc_loss_weight: float = 1.0
    temp_rate_loss_weight: float = 1.0
    momentum_loss_weight: float = 0.0
    output_dir: str = "model_output"
    compute_dtype: Optional[str] = None  # e.g. "bfloat16"
    neighbor_query_tile: int = 512
    neighbor_method: str = "auto"
    strict_neighbor_check: bool = True
    build_reverse: bool = True
    aggregation: str = "auto"
    cellblock_variable: bool = False
    fused_tail: Optional[bool] = None
    partition_invariant_noise: bool = False
    halt_on_nonfinite: bool = True
    profile_epoch: Optional[int] = None


def _axis_draw(generator: torch.Generator, device):
    """The permutation index (uniform over the 6) and a uniform number."""
    gdev = generator.device
    index = torch.randint(0, 6, (1,), generator=generator, device=gdev)
    u = torch.rand((1,), generator=generator, device=gdev)
    return index.to(device), u.to(device)


def _augment_axes(generator: torch.Generator, positions, target_positions, augment_prob):
    """Random xyz permutation of the last axis with probability
    ``augment_prob``, chosen on the device (no host round trip)."""
    dev = positions.device
    index, u = _axis_draw(generator, dev)
    perms = torch.tensor(AXIS_PERMS, device=dev)
    perm = torch.where(u < augment_prob, perms[index[0]], torch.arange(3, device=dev))
    return positions.index_select(-1, perm), target_positions.index_select(-1, perm)


class OptState(NamedTuple):
    optimizer: torch.optim.Optimizer
    schedule: Optional[torch.optim.lr_scheduler.LRScheduler]


class Optimizer:
    """A ``torch.optim`` optimizer over a parameter tree's leaves with an
    optional per-step learning-rate factor: ``init(params)`` makes the
    state, ``apply(state, grads)`` takes one step with the gradients of the
    leaves (in ``tree_leaves`` order), updating the leaves in place."""

    def __init__(self, make: Callable[[list], torch.optim.Optimizer],
                 lr_lambda: Optional[Callable[[int], float]] = None):
        self.make = make
        self.lr_lambda = lr_lambda

    def init(self, params) -> OptState:
        leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
        opt = self.make(leaves)
        schedule = (None if self.lr_lambda is None
                    else torch.optim.lr_scheduler.LambdaLR(opt, self.lr_lambda))
        return OptState(opt, schedule)

    @staticmethod
    def apply(state: OptState, grads) -> None:
        for p, g in zip(state.optimizer.param_groups[0]["params"], grads):
            p.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        if state.schedule is not None:
            state.schedule.step()


def make_optimizer(train_config: TrainConfig, steps_per_epoch: int) -> Optimizer:
    """Adam + per-epoch exponential decay, gamma =
    (final_learning_rate / learning_rate) ** (1 / num_epochs)."""
    tc = train_config
    gamma = (tc.final_learning_rate / tc.learning_rate) ** (1.0 / tc.num_epochs)
    return Optimizer(
        lambda leaves: torch.optim.Adam(leaves, lr=tc.learning_rate, betas=(0.9, 0.999),
                                        eps=1e-8, weight_decay=tc.weight_decay),
        lambda step: gamma ** (step // max(steps_per_epoch, 1)),
    )


def _resolve(model_config: EncodeProcessDecodeConfig, tc: TrainConfig):
    """(aggregation, pruned) after the checks of the JAX make_train_step."""
    if tc.aggregation not in ("auto", "gather", "cellblock", "cellblock_hybrid"):
        raise ValueError(f"unknown aggregation: {tc.aggregation}")
    aggregation = "gather" if tc.aggregation == "auto" else tc.aggregation
    pruned = model_config.aggregate == "sender_latents" and model_config.prune_dead_edge_stream
    if aggregation.startswith("cellblock") and not pruned:
        raise ValueError("aggregation='cellblock' requires the pruned sender_latents mode")
    if aggregation == "cellblock" or tc.cellblock_variable:
        raise NotImplementedError("the slot-space aggregation='cellblock' and "
                                  "cellblock_variable are not ported")
    if tc.partition_invariant_noise:
        raise NotImplementedError("partition_invariant_noise (per-particle noise "
                                  "keying) is not ported")
    resolve_fused_tail(tc.fused_tail, model_config, "cpu", None)  # the pruned check
    return aggregation, pruned


def _sample(params, model_config, stats, tc, aggregation, pruned, dtype, pos, temp, tpos,
            ttemp, generator, train: bool):
    """One sample's predictions, targets and (cell-block) plan violations."""
    if train:
        pos, tpos = _augment_axes(generator, pos, tpos, tc.augment_prob)
    kw = dict(generator=generator, noise_std=tc.noise_std if train else 0.0,
              num_neighbors=tc.num_neighbors, neighbor_method=tc.neighbor_method,
              neighbor_query_tile=tc.neighbor_query_tile, target_position=tpos,
              target_temperature=ttemp)
    if aggregation == "gather":
        graph = featurize(pos, temp, stats, build_edges=not pruned,
                          build_reverse=train and tc.build_reverse, **kw)
        preds = apply_encode_process_decode(params, graph, model_config, dtype)
        return preds, graph.target_acceleration, graph.target_temp_rate, None
    graph, codes, codes_cap, spill = featurize(pos, temp, stats, build_edges=False,
                                               with_codes=True, codes_only=True, **kw)
    # No codes when another search served: the plan is built from the ids.
    spec = choose_cellblock_spec(pos.shape[1], tc.num_neighbors)
    plan = build_cellblock(graph.positions, graph.neighbors, stats.box_size, spec,
                           with_reverse=train, neighbor_codes=codes, codes_cap=codes_cap,
                           codes_spill=spill)
    graph = graph._replace(nodes=graph.nodes[plan.order], cellblock=plan)
    preds = apply_encode_process_decode(params, graph, model_config, dtype,
                                        cellblock_spec=spec, cellblock_mode="hybrid")
    violations = None
    if train:
        violations = plan.overflow + plan.dropped_edges + plan.reverse_mismatch.abs()
    return (preds, graph.target_acceleration[plan.order], graph.target_temp_rate[plan.order],
            violations)


def _batch_loss(params, batch, model_config, stats, tc, aggregation, pruned, dtype,
                generator, train: bool):
    """The loss and its components over the batch (samples in a loop)."""
    preds, acc, rate, violations = [], [], [], []
    for b in range(batch["positions"].shape[0]):
        p, a, r, v = _sample(params, model_config, stats, tc, aggregation, pruned, dtype,
                             batch["positions"][b], batch["temperatures"][b],
                             batch["target_positions"][b], batch["target_temperatures"][b],
                             generator, train)
        preds.append(p)
        acc.append(a)
        rate.append(r)
        violations.append(v)
    total, components = combined_loss(
        {key: torch.stack([p[key] for p in preds]) for key in preds[0]},
        torch.stack(acc), torch.stack(rate), stats.dt,
        acc_weight=tc.acc_loss_weight, temp_rate_weight=tc.temp_rate_loss_weight,
        momentum_weight=tc.momentum_loss_weight,
    )
    if train and aggregation.startswith("cellblock"):
        components["cellblock_violations"] = torch.stack(violations).max().float()
    return total, components


def _prepare(params, batch, model_config, tc, dtype):
    """The batch as float32 tensors on the parameters' device, and the model
    config with the fused tail resolved for that device."""
    device = tree_leaves(params)[0].device
    batch = {key: torch.as_tensor(value, dtype=torch.float32).to(device)
             for key, value in batch.items()}
    return batch, model_config._replace(
        fused_tail=resolve_fused_tail(tc.fused_tail, model_config, device, dtype))


def make_train_step(
    model_config: EncodeProcessDecodeConfig,
    stats: NormalizationStats,
    train_config: TrainConfig,
    optimizer: Optimizer,
) -> Callable:
    """Build the train step ``(params, opt_state, batch, generator) ->
    (params, opt_state, metrics)``. ``batch`` holds ``positions [B, T, N,
    3]``, ``temperatures [B, T, N, 1]``, ``target_positions [B, N, 3]`` and
    ``target_temperatures [B, N, 1]`` (arrays or tensors); ``generator``
    draws the augmentation and the noise (on its own device). ``params``
    (on the device the step runs on) and ``opt_state``
    (``optimizer.init(params)``) are updated in place and returned.
    ``metrics`` holds 0-d tensors: ``loss``, ``acceleration``,
    ``temp_rate``, ``momentum`` and, on the cell-block path,
    ``cellblock_violations`` (column overflow + dropped edges +
    |reverse_mismatch|, the largest over the batch; 0 certifies the step).
    """
    tc = train_config
    dtype = getattr(torch, tc.compute_dtype) if tc.compute_dtype else None
    aggregation, pruned = _resolve(model_config, tc)

    def train_step(params, opt_state, batch, generator):
        batch, cfg = _prepare(params, batch, model_config, tc, dtype)
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, components = _batch_loss(params, batch, cfg, stats, tc, aggregation, pruned,
                                       dtype, generator, train=True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # Leaves the loss does not reach (the pruned model's edge stream)
        # get zero gradients, as in JAX, so weight decay still applies.
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        optimizer.apply(opt_state, grads)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in components.items()}}
        return params, opt_state, metrics

    return train_step


def make_eval_step(
    model_config: EncodeProcessDecodeConfig,
    stats: NormalizationStats,
    train_config: TrainConfig,
) -> Callable:
    """Validation step ``(params, batch) -> metrics``: no noise, no
    augmentation, no gradient."""
    tc = train_config
    dtype = getattr(torch, tc.compute_dtype) if tc.compute_dtype else None
    aggregation, pruned = _resolve(model_config, tc)

    @torch.no_grad()
    def eval_step(params, batch):
        batch, cfg = _prepare(params, batch, model_config, tc, dtype)
        loss, components = _batch_loss(params, batch, cfg, stats, tc, aggregation, pruned,
                                       dtype, None, train=False)
        return {"loss": loss, **components}

    return eval_step
