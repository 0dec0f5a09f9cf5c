"""Rank functions of ``tests/test_torch_halo.py``,
``tests/test_torch_halo_cellblock.py`` and ``tests/test_torch_halo_trainer.py``:
the port's halo exchange, halo steps and halo entry points run by gloo
ranks (``torch_sharded_workers.Ranks``, which calls each case as
``fn(mesh, **kwargs)``). This module imports no JAX; the tests hold what the
ranks return to their references, and the reference functions here serve
them too (``single_train``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from cosmology_gnn_simulation_tpu_torch.cli import render_rollout
from cosmology_gnn_simulation_tpu_torch.cli import train as train_cli
from cosmology_gnn_simulation_tpu_torch.convert import params_to_numpy
from cosmology_gnn_simulation_tpu_torch.data.dataset import SequenceDataset
from cosmology_gnn_simulation_tpu_torch.parallel import halo
from cosmology_gnn_simulation_tpu_torch.training import plots
from cosmology_gnn_simulation_tpu_torch.parallel.collectives import (
    collectives,
    collectives_bytes,
    ppermute,
    reset_collectives,
)
from cosmology_gnn_simulation_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    make_train_step,
)
from cosmology_gnn_simulation_tpu_torch.types import tree_leaves
from torch_sharded_workers import _setup, optimizer


class Capturing:
    """An optimizer that keeps the gradients of its last step (the step's
    all-reduced gradients on a rank), so one step serves a comparison of
    the update and one of the gradients."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def apply(self, state, grads):
        self.grads = [g.detach().numpy().copy() for g in grads]
        self.inner.apply(state, grads)


def _segment(mesh, hc, array, axis=0):
    """This rank's slab segment of a partitioned array along ``axis``."""
    p, cap = mesh.axis("particle").index, hc.local_capacity
    return np.take(array, np.arange(p * cap, (p + 1) * cap), axis=axis)


def permute_case(mesh, seed, device="cpu"):
    """``ppermute`` both ways on this rank's draws (made on the CPU, moved
    to ``device``): its output and the gradient of ``sum(out * w)``, the
    counts and the host-staged bytes."""
    axis = mesh.axis("particle")
    gen = torch.Generator().manual_seed(seed + axis.index)
    x = torch.randn(5, 3, generator=gen).to(device).requires_grad_(True)
    w = torch.randn(5, 3, generator=gen).to(device)
    out = {"x": x.detach().cpu().numpy(), "w": w.cpu().numpy()}
    reset_collectives()
    for shift in (1, -1):
        y = ppermute(x, axis, shift)
        (g,) = torch.autograd.grad((y * w).sum(), x)
        out[shift] = (y.detach().cpu().numpy(), g.cpu().numpy())
    out["collectives"] = dict(collectives)
    out["staged"] = collectives_bytes["host_staged"]
    return out


def exchange_case(mesh, hc, recent, valid, grid_x):
    """This rank's candidate rows through the exchange (the boundary sends
    and ``expand_candidates``, as ``featurize_halo`` runs them), their
    local slab frame and the sends' overflow."""
    hc = halo.HaloConfig(*hc)
    axis = mesh.axis("particle")
    own = torch.from_numpy(_segment(mesh, hc, recent))
    flags = torch.from_numpy(_segment(mesh, hc, valid))
    sends, overflow = halo._boundary_sends(halo._cell_x(own, hc, 1.0), flags, hc, axis)
    cand = halo.expand_candidates(torch.cat([own, flags[:, None].float()], dim=-1), sends, axis)
    local, box_local = halo._local_frame(cand[:, :3], hc, grid_x, 1.0, axis.index)
    return {"positions": cand[:, :3].numpy(), "valid": (cand[:, 3] > 0.5).numpy(),
            "overflow": int(overflow), "local": local.numpy(), "box_local": box_local.numpy()}


def featurize_case(mesh, model, meta, params, hc, part, k, spec=None):
    """``featurize_halo`` on this rank's segment of a partitioned window with
    its targets (noise 0): the graph's arrays and the diagnostics, and with
    a slab spec the plan."""
    _, stats, _ = _setup(model, meta, params)
    hc = halo.HaloConfig(*hc)
    seg = {key: torch.from_numpy(_segment(mesh, hc, value, axis=1 if value.ndim == 3 else 0))
           for key, value in part.items()}
    graph, sends, diag = halo.featurize_halo(
        seg["positions"], seg["temperatures"], seg["valid"], stats, num_neighbors=k, hc=hc,
        axis=mesh.axis("particle"), target_position=seg["target_positions"],
        target_temperature=seg["target_temperatures"], with_diagnostics=True,
        cellblock_spec=spec)
    out = {key: getattr(graph, key).numpy() for key in
           ("nodes", "neighbors", "edges", "positions", "target_acceleration",
            "target_temp_rate")}
    out["sends"] = [s.numpy() for s in sends]
    out["diag"] = {key: float(value) for key, value in diag.items()}
    if spec is not None:
        plan = graph.cellblock.plan
        out["plan"] = {key: getattr(plan, key).numpy() for key in
                       ("order", "slot_of_sorted", "particle_of_slot", "pad_src",
                        "window_starts", "s_table", "overflow", "dropped_edges",
                        "window_overflow")}
        out["inv_owned"] = graph.cellblock.inv_owned.numpy()
    return out


def rollout_case(mesh, model, meta, params, hc, part, k, steps, spec=None):
    """``make_halo_rollout`` on this rank's segment: its slots' outputs, the
    diagnostics, the certificate and its components, the collectives."""
    cfg, stats, tparams = _setup(model, meta, params)
    hc = halo.HaloConfig(*hc)
    fn = halo.make_halo_rollout(cfg, stats, mesh, steps, hc, num_neighbors=k,
                                with_certificate_components=True, cellblock_spec=spec)
    reset_collectives()
    outs, diag, exact, certs = fn(tparams, *halo.window_segment(part, hc,
                                                                mesh.axis("particle").index))
    return {"outs": {key: v.numpy() for key, v in outs.items()},
            "diag": {key: int(v) for key, v in diag.items()}, "exact": exact.numpy(),
            "certs": {key: v.numpy() for key, v in certs.items()},
            "collectives": dict(collectives)}


def run_rollout_case(mesh, model, meta, params, hc, pos, temp, k, steps, spec=None):
    """``run_halo_rollout``: the reassembled trajectory on this rank."""
    cfg, stats, tparams = _setup(model, meta, params)
    traj, diag = halo.run_halo_rollout(tparams, cfg, pos, temp, stats, steps, mesh,
                                       halo.HaloConfig(*hc), num_neighbors=k, cellblock_spec=spec)
    return {"traj": traj, "diag": diag}


def train_case(mesh, model, meta, params, hc, tc, part, seed, spec=None):
    """One halo train step (Adam) on this rank's slice of the partitioned
    batch, the generator seeded with ``seed``: metrics, params after the
    step, the step's gradients and the collectives."""
    cfg, stats, tparams = _setup(model, meta, params)
    tc = TrainConfig(**tc)
    optim = Capturing(optimizer("adam", tc))
    step = halo.make_halo_train_step(cfg, stats, tc, optim, mesh, halo.HaloConfig(*hc),
                                     cellblock_spec=spec)
    local = halo.shard_halo_batch(part, mesh)
    reset_collectives()
    tparams, _, metrics = step(tparams, optim.init(tparams), local,
                               torch.Generator().manual_seed(seed))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": [t.detach().numpy().copy() for t in tree_leaves(tparams)],
            "grads": optim.grads, "collectives": dict(collectives)}


def eval_case(mesh, model, meta, params, hc, tc, part):
    """The halo eval step's per-sample metrics (global ``[B]`` vectors)."""
    cfg, stats, tparams = _setup(model, meta, params)
    step = halo.make_halo_eval_step(cfg, stats, TrainConfig(**tc), mesh, halo.HaloConfig(*hc))
    metrics = step(tparams, halo.shard_halo_batch(part, mesh))
    return {key: v.numpy() for key, v in metrics.items()}


def card_plan_case(mesh, model, meta, params, hc, part, k, spec):
    """On the card: ``featurize_halo``'s slab plan of this rank's segment
    (K3 once), its S against K3's plain version on the plan's offsets
    (rebuilt from the exchanged candidates) and K4 on it against its plain
    version."""
    from cosmology_gnn_simulation_tpu_torch import kernels
    from cosmology_gnn_simulation_tpu_torch.ops import cellblock

    dev = torch.device("cuda")
    _, stats, _ = _setup(model, meta, params)
    stats = stats.to(dev)
    hc = halo.HaloConfig(*hc)
    axis = mesh.axis("particle")
    seg = {key: torch.from_numpy(_segment(mesh, hc, part[key], axis=1 if key in
                                          ("positions", "temperatures") else 0)).to(dev)
           for key in ("positions", "temperatures", "valid")}
    kernels.reset_launches()
    graph, sends, _ = halo.featurize_halo(seg["positions"], seg["temperatures"], seg["valid"],
                                          stats, num_neighbors=k, hc=hc, axis=axis,
                                          cellblock_spec=spec)
    torch.cuda.synchronize()
    launches = {name: n for name, n in kernels.launches.items() if n}
    plan = graph.cellblock.plan
    cand = halo.expand_candidates(torch.cat([graph.positions, seg["valid"][:, None].float()],
                                            dim=-1), sends, axis)
    local, box_local = halo._local_frame(cand[:, :3], hc, spec.gx, 1.0, axis.index)
    m = cand.shape[0]
    nbr = torch.cat([graph.neighbors, graph.neighbors.new_full((m - hc.local_capacity, k), m)])
    layout = cellblock.cellblock_layout(local, box_local, spec, cand[:, 3] > 0.5)
    offsets, _ = cellblock.aux_offsets(cellblock.aux_slot_senders(layout, nbr, spec), layout,
                                       spec)
    s_ref = cellblock.s_onehot_reference(offsets, width=spec.s_width)
    z_pad = torch.randn(spec.num_padded, 128, generator=torch.Generator().manual_seed(axis.index))
    z_pad = z_pad.bfloat16().to(dev)
    got = cellblock.window_matmul(plan.s_table, z_pad, plan.window_starts, spec=spec)
    want = cellblock.window_matmul_reference(s_ref, z_pad, layout.window_starts, spec=spec)
    return {"launches": launches, "s_equal": bool(torch.equal(plan.s_table, s_ref)),
            "edges": int(s_ref.sum(dtype=torch.int64)), "k4": (got.cpu(), want.cpu()),
            "overflow": (int(plan.overflow), int(plan.dropped_edges))}


def single_train(model, meta, params, tc, batch, seed):
    """The single-device train step (the reference, Adam): metrics, params
    after the step and the step's gradients."""
    cfg, stats, tparams = _setup(model, meta, params)
    tc = TrainConfig(**tc)
    optim = Capturing(optimizer("adam", tc))
    tparams, _, metrics = make_train_step(cfg, stats, tc, optim)(
        tparams, optim.init(tparams), batch, torch.Generator().manual_seed(seed))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": [t.detach().numpy().copy() for t in tree_leaves(tparams)],
            "grads": optim.grads}


def _no_plots():
    """Skip the loss and error plots (seconds each on the CPU; no case
    reads them) in this rank."""
    plots.plot_losses = plots.plot_rollout_errors = lambda *args, **kwargs: None


def _leaves(params):
    return [a.copy() for a in tree_leaves(params_to_numpy(params))]


def _files(path):
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


def halo_trainer_case(mesh, model, meta, params, hc, tc, train_dir, val_dir, out, resume=False):
    """``Trainer(mesh, halo).fit`` over the HDF5 sets, rank r's output
    directory ``out/rank{r}`` (rank 0 alone writes): the params after the
    fit, the history, the files each rank wrote and the collectives. With
    ``resume``, a second Trainer restores rank 0's ``model_epoch_0`` and
    fits the remaining epochs into ``out/resumed{r}``."""
    _no_plots()
    cfg, stats, tparams = _setup(model, meta, params)
    tc = TrainConfig(**dict(tc, output_dir=os.path.join(out, f"rank{mesh.rank}")))
    train = SequenceDataset(train_dir, tc.window_size, meta)
    val = SequenceDataset(val_dir, tc.window_size, meta)
    hc = halo.HaloConfig(*hc)
    trainer = Trainer(cfg, stats, tc, len(train) // tc.batch_size, tparams, mesh=mesh, halo=hc,
                      device="cpu")
    reset_collectives()
    trainer.fit(train, val, verbose=False)
    result = {"params": _leaves(trainer.params), "history": trainer.history,
              "files": _files(tc.output_dir), "collectives": dict(collectives)}
    if resume:
        dist.barrier()
        tc = dataclasses.replace(tc, output_dir=os.path.join(out, f"resumed{mesh.rank}"))
        resumed = Trainer(cfg, stats, tc, len(train) // tc.batch_size, tparams, mesh=mesh,
                          halo=hc, device="cpu")
        start = resumed.restore(os.path.join(out, "rank0", "model_epoch_0"))
        resumed.fit(train, val, verbose=False, start_epoch=start)
        result["resumed"] = {"start": start, "history": resumed.history,
                             "files": _files(tc.output_dir)}
    return result


def cli_train_case(mesh, argv, out):
    """``cli.train`` with ``argv`` (``--spatial_shards``), rank r writing
    under ``out/rank{r}``: the params, history, mesh, halo config and the
    files written."""
    _no_plots()
    out = os.path.join(out, f"rank{dist.get_rank()}")
    trainer = train_cli.main([*argv, "--output_dir", out])
    return {"params": _leaves(trainer.params), "history": trainer.history,
            "mesh": trainer.mesh.shape, "halo": tuple(trainer.halo), "files": _files(out)}


def cli_refusal_case(mesh, argv):
    """The message of the ``ValueError`` that ``cli.train`` with ``argv``
    raises."""
    try:
        train_cli.main(argv)
    except ValueError as err:
        return str(err)
    return None


def render_case(mesh, argv, out):
    """``cli.render_rollout`` with ``argv`` (``--spatial_shards``), rank r
    writing under ``out/rank{r}``: the errors and the files written."""
    _no_plots()
    out = os.path.join(out, f"rank{dist.get_rank()}")
    errors = render_rollout.main([*argv, "--output_dir", out])
    return {"errors": errors, "files": _files(out)}
