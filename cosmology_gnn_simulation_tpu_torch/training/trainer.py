"""The train and eval steps, their optimizer and the epoch-driven
``Trainer`` (counterpart of ``training/trainer.py``: ``TrainConfig``,
``_augment_axes``, ``make_train_step``, ``make_eval_step``,
``make_optimizer``, ``Trainer``, ``default_model_config``).

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
and K4 forward / K4^T backward each message-passing step; or
``"cellblock"``, the same with the carry in slot space (the JAX package's
config-4 path), and ``cellblock_variable`` for variable capacities on
either. ``"auto"``
resolves to ``"gather"``, as the port's rollout and the JAX dispatch off
the TPU do. ``fused_tail=None`` turns the fused tail (K5 forward, K6
backward) on for the pruned model on CUDA where the kernels take the shape
(``ops.fused_step.resolve_fused_tail``).

The optimizer is ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8 outside
the square root: ``optax.scale_by_adam``), whose coupled ``weight_decay``
is ``optax.add_decayed_weights`` placed before it, with the learning rate
``lr * gamma ** (step // steps_per_epoch)``. The parameter tree's leaves
are updated in place.

``Trainer`` runs epochs of train steps with per-epoch validation over the
whole validation set, the best, periodic and final checkpoints
(``utils/checkpoint.py``), ``training_history.json`` and the loss plots,
and a full resume (``restore``). Metrics stay tensors on the device until
the epoch's average, so the loop adds no host sync per step.

``Trainer(mesh=...)`` runs the index-sharded steps of
``parallel/sharded.py`` on every rank of a ``parallel.mesh.Mesh``: the
data-parallel train step, and validation through the per-sample sharded
eval step with the tail batch padded and masked; rank 0 writes the
checkpoints, the plots and ``training_history.json``, and every rank
restores on resume.

``partition_invariant_noise`` keys each sample's noise per particle by its
global id (``ops.noise``): ``arange(N)``, or the batch's ``gids [B, N]``
where it carries them (a layout of the particles other than the dataset's,
as a halo partition gives).

``Trainer(mesh=..., halo=...)`` runs the halo-sharded steps of
``parallel/halo.py``: each batch is partitioned into slabs on the host
(``partition_batch``, which also draws the xyz augmentation there from a
host generator seeded alike on every rank) and each rank takes its slice;
validation pads and masks a tail batch as on a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch.featurize import featurize, verify_neighbor_exactness
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
    apply_encode_process_decode,
    default_model_config,
    init_encode_process_decode,
)
from cosmology_gnn_simulation_tpu_torch.ops.cellblock import (
    build_cellblock,
    choose_cellblock_spec,
)
from cosmology_gnn_simulation_tpu_torch.ops.fused_step import resolve_fused_tail
from cosmology_gnn_simulation_tpu_torch.parallel.collectives import broadcast_flat
from cosmology_gnn_simulation_tpu_torch.training.losses import combined_loss
from cosmology_gnn_simulation_tpu_torch.types import (
    NormalizationStats,
    resolve_device,
    tree_leaves,
    tree_map,
)
from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib
from cosmology_gnn_simulation_tpu_torch.utils.profiling import StepTimer, block_until_ready, trace

# default_model_config is imported here too: the JAX package defines it in
# this module, and its callers (cli/train.py) import it from here.

# All 6 permutations of the xyz axes (the reference draws torch.randperm(3)).
AXIS_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the JAX ``TrainConfig``: same fields and
    defaults). ``output_dir``, ``save_every``, ``halt_on_nonfinite``,
    ``profile_epoch`` (an epoch traced by ``utils.profiling.trace`` under
    ``output_dir/profile``) and ``strict_neighbor_check`` are the
    ``Trainer``'s."""

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
    resolve_fused_tail(tc.fused_tail, model_config, "cpu", None)  # the pruned check
    return aggregation, pruned


def _sample(params, model_config, stats, tc, aggregation, pruned, dtype, pos, temp, tpos,
            ttemp, generator, train: bool, gids=None):
    """One sample's predictions, targets and (cell-block) plan violations;
    ``gids`` the particles' global ids (``arange(N)`` when None) under
    ``partition_invariant_noise``."""
    if train:
        pos, tpos = _augment_axes(generator, pos, tpos, tc.augment_prob)
    noise_gids = None
    if train and tc.partition_invariant_noise:
        noise_gids = gids if gids is not None else torch.arange(pos.shape[1], device=pos.device)
    kw = dict(generator=generator, noise_std=tc.noise_std if train else 0.0,
              num_neighbors=tc.num_neighbors, neighbor_method=tc.neighbor_method,
              neighbor_query_tile=tc.neighbor_query_tile, target_position=tpos,
              target_temperature=ttemp, noise_gids=noise_gids)
    if aggregation == "gather":
        graph = featurize(pos, temp, stats, build_edges=not pruned,
                          build_reverse=train and tc.build_reverse, **kw)
        preds = apply_encode_process_decode(params, graph, model_config, dtype)
        return preds, graph.target_acceleration, graph.target_temp_rate, None
    graph, codes, codes_cap, spill = featurize(pos, temp, stats, build_edges=False,
                                               with_codes=True, codes_only=True, **kw)
    # No codes when another search served: the plan is built from the ids.
    spec = choose_cellblock_spec(pos.shape[1], tc.num_neighbors,
                                 variable=tc.cellblock_variable)
    plan = build_cellblock(graph.positions, graph.neighbors, stats.box_size, spec,
                           with_reverse=train, neighbor_codes=codes, codes_cap=codes_cap,
                           codes_spill=spill)
    graph = graph._replace(nodes=graph.nodes[plan.order], cellblock=plan)
    preds = apply_encode_process_decode(
        params, graph, model_config, dtype, cellblock_spec=spec,
        cellblock_mode="hybrid" if aggregation == "cellblock_hybrid" else "slots")
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
                             generator, train, batch["gids"][b] if "gids" in batch else None)
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

    def upload(key, value):
        # A pinned tensor (the native loader's) goes up without waiting; the
        # pinned allocator keeps its block until the copy is done.
        host = torch.as_tensor(value, dtype=torch.int64 if key == "gids" else torch.float32)
        return host.to(device, non_blocking=host.is_pinned())

    batch = {key: upload(key, value) for key, value in batch.items()}
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
    ``target_temperatures [B, N, 1]`` (arrays or tensors), and optionally
    ``gids [B, N]``, the particles' global ids that
    ``partition_invariant_noise`` keys the noise by (``arange(N)`` without
    them); ``generator`` draws the augmentation and the noise (on its own
    device). ``params``
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


def mean_metrics(metrics) -> Dict[str, float]:
    """Each metric's mean over a list of step metrics (dicts of 0-d tensors
    on the device), read back to the host in one transfer: the loop's one
    read an epoch."""
    keys = list(metrics[0])
    means = torch.stack([torch.stack([m[k] for m in metrics]).double().mean() for k in keys])
    return dict(zip(keys, means.tolist()))


class Trainer:
    """Epoch-driven trainer: per-epoch prints, best / periodic / final
    checkpoints, loss plots and ``training_history.json`` (the JAX
    ``Trainer``'s single-device branch).

    ``device`` is where the steps run (``"cuda"`` unless the caller asks for
    the CPU; no fallback). The initial params are ``init_params`` (a tree of
    arrays or tensors, copied to ``device``) or
    ``init_encode_process_decode`` drawn from
    ``torch.Generator().manual_seed(seed)``. The train generator,
    ``torch.Generator(device).manual_seed(seed)``, draws the augmentation
    and the noise.

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank of it constructs the
    Trainer and calls ``fit``): the steps run index-sharded on
    ``mesh.device``, which replaces ``device``; ``batch_size`` must divide by
    the data-axis size; each step's randomness is keyed by the seed and the
    global step (``parallel/sharded.py``).

    ``halo`` (a ``parallel.halo.HaloConfig``; needs ``mesh``, whose particle
    axis has ``halo.num_shards`` ranks): the halo-sharded steps, with no
    cell-block spec, as the JAX Trainer builds them. The xyz augmentation
    runs on the host in ``partition_batch``, drawn from
    ``np.random.default_rng(seed)``, which every rank advances alike; the
    train generator draws the noise as the single-device step does, so with
    ``partition_invariant_noise`` a halo fit is the single-device fit. As
    in JAX, ``restore`` does not restore that host generator.
    """

    def __init__(
        self,
        model_config: EncodeProcessDecodeConfig,
        stats: NormalizationStats,
        train_config: TrainConfig,
        steps_per_epoch: int,
        init_params: Any = None,
        mesh=None,
        halo=None,
        device="cuda",
    ):
        if halo is not None and mesh is None:
            raise ValueError("halo sharding requires a mesh")
        self.mesh = mesh
        self.halo = halo
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.model_config = model_config
        self.stats = stats.to(self.device)
        self.tc = train_config
        self.generator = torch.Generator(device=self.device).manual_seed(train_config.seed)
        if init_params is None:
            self.params = init_encode_process_decode(
                model_config, torch.Generator().manual_seed(train_config.seed), self.device)
        else:
            self.params = tree_map(
                lambda t: torch.as_tensor(t).detach().to(self.device, torch.float32).clone(),
                init_params)
        self.optimizer = make_optimizer(train_config, steps_per_epoch)
        self.opt_state = self.optimizer.init(self.params)
        if mesh is not None and train_config.batch_size % mesh.shape["data"]:
            raise ValueError(f"batch_size {train_config.batch_size} must divide by "
                             f"data-axis size {mesh.shape['data']}")
        if mesh is None:
            self.train_step = make_train_step(model_config, self.stats, train_config,
                                              self.optimizer)
            self.eval_step = make_eval_step(model_config, self.stats, train_config)
        elif halo is not None:
            from cosmology_gnn_simulation_tpu_torch.parallel import halo as halo_lib

            self.train_step = halo_lib.make_halo_train_step(
                model_config, self.stats, train_config, self.optimizer, mesh, halo)
            self.eval_step = halo_lib.make_halo_eval_step(model_config, self.stats,
                                                          train_config, mesh, halo)
            self._host_rng = np.random.default_rng(train_config.seed)
        else:
            from cosmology_gnn_simulation_tpu_torch.parallel.sharded import (
                make_data_parallel_train_step,
                make_sharded_eval_step,
                shard_batch,
            )

            self.shard_batch = shard_batch

            self.train_step = make_data_parallel_train_step(
                model_config, self.stats, train_config, self.optimizer, mesh)
            # Per-sample metrics, so a tail batch can be padded and masked.
            self.eval_step = make_sharded_eval_step(model_config, self.stats, train_config,
                                                    mesh, per_sample=True)
        self.history: Dict[str, Any] = {
            "train_loss": [],
            "val_loss": [],
            "learning_rates": [],
            "component_losses": {
                "acc_train": [], "acc_val": [],
                "temp_rate_train": [], "temp_rate_val": [],
                "momentum_train": [], "momentum_val": [],
            },
            "best_epoch": -1,
            "best_val_loss": float("inf"),
        }

    def _config_dict(self) -> Dict:
        return {
            "model": self.model_config._asdict(),
            "train": dataclasses.asdict(self.tc),
        }

    def fit(self, train_dataset, val_dataset, *, verbose: bool = True, start_epoch: int = 0):
        """Train epochs ``start_epoch`` to ``num_epochs - 1``; returns the
        final (best) params. The datasets need ``len`` and
        ``SequenceDataset.batches``' contract."""
        tc = self.tc
        main = self._is_main()
        verbose = verbose and main
        plots_dir = os.path.join(tc.output_dir, "plots")
        if main:
            os.makedirs(plots_dir, exist_ok=True)
        gamma = (tc.final_learning_rate / tc.learning_rate) ** (1.0 / tc.num_epochs)
        h = self.history

        self.step_timer = StepTimer()
        self._check_neighbor_exactness(train_dataset, verbose)
        dropped = len(train_dataset) % tc.batch_size
        if dropped and verbose:
            # The reference's train loader keeps the tail; fixed batch
            # shapes drop it. It rotates with the shuffle seed, so no window
            # is left out in every epoch.
            print(
                f"NOTE: {dropped} tail training sample(s) per epoch are "
                f"dropped to keep batch shapes static "
                f"(dataset {len(train_dataset)} % batch_size {tc.batch_size})."
            )

        for epoch in range(start_epoch, tc.num_epochs):
            profiling = tc.profile_epoch == epoch
            current_lr = tc.learning_rate * gamma**epoch
            h["learning_rates"].append(current_lr)
            epoch_metrics = []
            t0 = time.perf_counter()
            batch_iter = train_dataset.batches(tc.batch_size, shuffle=True, seed=tc.seed + epoch)
            bar = None
            if verbose:
                try:  # per-batch progress, as the reference shows
                    from tqdm import tqdm

                    bar = tqdm(batch_iter, desc=f"Epoch {epoch}", leave=False)
                    batch_iter = bar
                except ImportError:
                    pass
            with (trace(os.path.join(tc.output_dir, "profile")) if profiling
                  else contextlib.nullcontext()):
                for count, batch in enumerate(batch_iter, start=1):
                    if self.mesh is None:
                        self.params, self.opt_state, metrics = self.train_step(
                            self.params, self.opt_state, batch, self.generator)
                    elif self.halo is not None:
                        self.params, self.opt_state, metrics = self.train_step(
                            self.params, self.opt_state,
                            self._shard_halo(batch, augment_prob=tc.augment_prob,
                                             rng=self._host_rng),
                            self.generator)
                    else:
                        step = epoch * (len(train_dataset) // tc.batch_size) + count - 1
                        self.params, self.opt_state, metrics = self.train_step(
                            self.params, self.opt_state, self.shard_batch(batch, self.mesh),
                            step)
                    epoch_metrics.append(metrics)
                    if bar is not None and count % 10 == 0:
                        # Reading a metric waits for the device: only every
                        # 10 steps.
                        bar.set_postfix({
                            "loss": float(metrics["loss"]),
                            "acc_loss": float(metrics["acceleration"]),
                            "temp_rate_loss": float(metrics["temp_rate"]),
                        })
                if profiling:
                    block_until_ready(self.params)
            self.step_timer.record("train_epoch", time.perf_counter() - t0)
            if not epoch_metrics:
                raise ValueError(
                    f"Epoch {epoch} produced zero batches: the dataset has "
                    f"{len(train_dataset)} windows but batch_size="
                    f"{tc.batch_size} (the remainder is dropped). Reduce "
                    "batch_size or add data."
                )
            train_avg = mean_metrics(epoch_metrics)
            if tc.halt_on_nonfinite and not math.isfinite(train_avg["loss"]):
                raise FloatingPointError(
                    f"Non-finite training loss at epoch {epoch}: "
                    f"{train_avg} — inspect data/LR; rerun with "
                    "utils.profiling.enable_nan_debugging() to localize."
                )
            if train_avg.get("cellblock_violations", 0.0) > 0:
                msg = (
                    f"Cell-block aggregation certificate failed during epoch "
                    f"{epoch} (column overflow / dropped edges / reverse "
                    f"mismatch > 0): gradients are approximate on this "
                    f"particle distribution. Remedies: aggregation='gather', "
                    f"or a CellBlockSpec with more capacity/window headroom."
                )
                if tc.strict_neighbor_check:
                    raise ValueError(msg)
                print(f"WARNING: {msg}")

            val_avg = self.evaluate(val_dataset)

            h["train_loss"].append(train_avg["loss"])
            h["val_loss"].append(val_avg["loss"])
            cl = h["component_losses"]
            cl["acc_train"].append(train_avg["acceleration"])
            cl["acc_val"].append(val_avg["acceleration"])
            cl["temp_rate_train"].append(train_avg["temp_rate"])
            cl["temp_rate_val"].append(val_avg["temp_rate"])
            cl["momentum_train"].append(train_avg["momentum"])
            cl["momentum_val"].append(val_avg["momentum"])

            if verbose:
                print(
                    f"Epoch {epoch}: training loss = {train_avg['loss']:.6f}, "
                    f"validation loss = {val_avg['loss']:.6f}, "
                    f"learning rate = {current_lr:.2e}, "
                    f"epoch time = {time.perf_counter() - t0:.1f}s"
                )

            if val_avg["loss"] < h["best_val_loss"]:
                h["best_val_loss"] = val_avg["loss"]
                h["best_epoch"] = epoch
                self.save("model_best", epoch)
                if verbose:
                    print(f"New best model saved with validation loss: {val_avg['loss']:.6f}")

            if epoch % 5 == 0 and main:
                self._plot(os.path.join(plots_dir, f"losses_epoch_{epoch}.png"))
            if (epoch + 1) % tc.save_every == 0 or epoch == tc.num_epochs - 1:
                self.save(f"model_epoch_{epoch}", epoch)

        if main:
            self._plot(os.path.join(plots_dir, "losses_final.png"))
        # Reload the best params and save them as the final model. On a mesh
        # rank 0 reads the checkpoint and sends the params to every rank.
        best_path = os.path.join(tc.output_dir, "model_best")
        if main and os.path.exists(best_path):
            self._load_params(ckpt_lib.load_state(best_path)["params"])
        if self.mesh is not None:
            with torch.no_grad():
                for leaf, value in zip(tree_leaves(self.params),
                                       broadcast_flat(tree_leaves(self.params))):
                    leaf.copy_(value)
        self.save("model_final", tc.num_epochs - 1)
        if main:
            with open(os.path.join(tc.output_dir, "training_history.json"), "w") as f:
                json.dump(h, f, indent=4)
        return self.params

    def _shard_halo(self, batch, **augment):
        """This rank's slice of the batch partitioned into slabs
        (``augment``: ``partition_batch``'s augmentation arguments)."""
        from cosmology_gnn_simulation_tpu_torch.parallel.halo import (
            partition_batch,
            shard_halo_batch,
        )

        part = partition_batch(batch, self.halo, self.stats.box_size, **augment)
        return shard_halo_batch(part, self.mesh)

    def _is_main(self) -> bool:
        """Whether this process writes the run's files (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def _check_neighbor_exactness(self, dataset, verbose: bool) -> None:
        """The cell-list search's exactness certificate on the first
        window's last frame, once (``featurize.verify_neighbor_exactness``:
        raises under ``strict_neighbor_check``, else warns)."""
        tc = self.tc
        if tc.neighbor_method == "bruteforce":
            return
        batch = next(iter(dataset.batches(1, shuffle=False)), None)
        if batch is None:
            return
        positions = torch.as_tensor(batch["positions"][0, -1], dtype=torch.float32)
        result = verify_neighbor_exactness(
            positions.to(self.device), tc.num_neighbors, self.stats.box_size,
            method=tc.neighbor_method, strict=tc.strict_neighbor_check,
        )
        if verbose and not result.get("exact", True):
            print("WARNING: neighbor-search exactness certificate failed "
                  f"({result}); see featurize.verify_neighbor_exactness")

    def evaluate(self, dataset) -> Dict[str, float]:
        """Average metrics over the whole validation set, the tail batch
        included (the reference's validation loader keeps it): the mean of
        the batches' means. On a mesh a tail batch is padded to the batch
        size with copies of its last window, and the padding masked out."""
        bs = self.tc.batch_size
        metrics = []
        for batch in dataset.batches(bs, shuffle=False, drop_remainder=False):
            if self.mesh is None:
                metrics.append(self.eval_step(self.params, batch))
                continue
            real = batch["positions"].shape[0]
            batch = {key: np.asarray(v) for key, v in batch.items()}
            batch = {key: np.concatenate([v, np.repeat(v[-1:], bs - real, axis=0)])
                     for key, v in batch.items()}
            local = (self.shard_batch(batch, self.mesh) if self.halo is None
                     else self._shard_halo(batch))
            per_sample = self.eval_step(self.params, local)
            metrics.append({key: v[:real].mean() for key, v in per_sample.items()})
        if not metrics:
            raise ValueError(
                f"Validation produced zero batches: dataset has "
                f"{len(dataset)} windows, batch_size={self.tc.batch_size}."
            )
        return mean_metrics(metrics)

    def save(self, name: str, epoch: int = 0) -> Optional[str]:
        """Write checkpoint ``name`` (rank 0 alone on a mesh; None
        elsewhere)."""
        if not self._is_main():
            return None
        path = ckpt_lib.save_checkpoint(
            self.tc.output_dir, name, self.params, self.opt_state, epoch=epoch,
            generator_state=self.generator.get_state(), config=self._config_dict(),
        )
        with open(os.path.join(path, "history.json"), "w") as f:
            json.dump(self.history, f)
        return path

    def _load_params(self, saved) -> None:
        """Copy a saved param tree into the live leaves (the optimizer holds
        them)."""
        with torch.no_grad():
            for leaf, value in zip(tree_leaves(self.params), tree_leaves(saved), strict=True):
                leaf.copy_(value)

    def restore(self, path: str) -> int:
        """Full resume: params, the optimizer's moments and step count, the
        LR schedule's position, the train generator, the epoch and the
        history (cut to the epochs before the resumed one). Returns the
        epoch to resume from (the saved one + 1)."""
        state = ckpt_lib.load_state(path)
        self._load_params(state["params"])
        self.opt_state.optimizer.load_state_dict(state["optimizer"])
        if self.opt_state.schedule is not None:
            self.opt_state.schedule.load_state_dict(state["schedule"])
        self.generator.set_state(state["generator"])
        start_epoch = state["epoch"] + 1
        history_path = os.path.join(path, "history.json")
        if os.path.exists(history_path):
            with open(history_path) as f:
                self.history = json.load(f)
            # The checkpoint may be older than the last recorded epoch
            # (model_best): cut each per-epoch series to start_epoch entries.
            for series in ("train_loss", "val_loss", "learning_rates"):
                self.history[series] = self.history[series][:start_epoch]
            cl = self.history.get("component_losses", {})
            for name in cl:
                cl[name] = cl[name][:start_epoch]
        return start_epoch

    def _plot(self, path: str) -> None:
        try:
            from cosmology_gnn_simulation_tpu_torch.training.plots import plot_losses

            plot_losses(
                self.history["train_loss"],
                self.history["val_loss"],
                path,
                self.history["component_losses"],
                self.history["learning_rates"],
            )
        except Exception as exc:  # plotting is best-effort observability
            print(f"plotting skipped: {exc}")
