"""Rank processes of ``tests/test_torch_sharded.py``: the port's sharded
paths run by gloo ranks spawned with ``torch.multiprocessing`` and joined by
a file store (no TCP port: several test workers run at once). This module
imports no JAX; the test compares what the ranks return with its references.

``Ranks(world, init_file, cases)`` starts ``world`` ranks
(``parallel.local_ranks``), each of which runs every case in order and
returns its results; a rank that raises, a collective that times out or a
rank that dies fails ``results()``. A case's kind names one of ``CASES`` or
is a module-level function of another rank module
(``tests/torch_halo_workers.py``), called as ``fn(mesh, **kwargs)``.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch.cli import train as train_cli
from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax, params_to_numpy
from cosmology_gnn_simulation_tpu_torch.data.dataset import SequenceDataset
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import default_model_config
from cosmology_gnn_simulation_tpu_torch.parallel import sharded
from cosmology_gnn_simulation_tpu_torch.parallel.collectives import collectives, reset_collectives
from cosmology_gnn_simulation_tpu_torch.parallel.local_ranks import LocalRanks
from cosmology_gnn_simulation_tpu_torch.parallel.mesh import make_mesh
from cosmology_gnn_simulation_tpu_torch.training.trainer import (
    Optimizer,
    TrainConfig,
    Trainer,
    make_optimizer,
)
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves

# A hung collective raises after this long instead of gloo's 30 minutes.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)
RANK_TIMEOUT_S = 240


def optimizer(kind: str, tc: TrainConfig) -> Optimizer:
    """``"sgd"``: SGD with lr 1 (the update is the gradient); ``"adam"``:
    the training optimizer."""
    if kind == "sgd":
        return Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
    return make_optimizer(tc, steps_per_epoch=1)


def _setup(model, meta, params):
    return (default_model_config(**model), NormalizationStats.from_metadata(meta, device="cpu"),
            params_from_jax(params, device="cpu"))


def train_case(mesh, model, meta, params, tc, batch, opt):
    """One data-parallel train step on this rank's slice of ``batch``: the
    metrics, the params after the step and the step's collective counts."""
    cfg, stats, tparams = _setup(model, meta, params)
    tc = TrainConfig(**tc)
    optim = optimizer(opt, tc)
    step = sharded.make_data_parallel_train_step(cfg, stats, tc, optim, mesh)
    reset_collectives()
    tparams, _, metrics = step(tparams, optim.init(tparams), sharded.shard_batch(batch, mesh), 0)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": [t.detach().numpy().copy() for t in tree_leaves(tparams)],
            "collectives": dict(collectives)}


def eval_case(mesh, model, meta, params, tc, batch):
    """The per-sample sharded eval step on ``batch`` (global ``[B]``
    vectors) and the batch-mean one."""
    cfg, stats, tparams = _setup(model, meta, params)
    tc = TrainConfig(**tc)
    local = sharded.shard_batch(batch, mesh)
    per_sample = sharded.make_sharded_eval_step(cfg, stats, tc, mesh, per_sample=True)(
        tparams, local)
    means = sharded.make_sharded_eval_step(cfg, stats, tc, mesh)(tparams, local)
    return {"per_sample": {k: v.numpy() for k, v in per_sample.items()},
            "means": {k: float(v) for k, v in means.items()}}


def _rows(mesh, array):
    """This rank's particle rows of ``[T, N, D]``."""
    p = mesh.axis("particle")
    n = array.shape[1] // p.size
    return array[:, p.index * n:(p.index + 1) * n]


def forward_case(mesh, model, meta, params, pos, temp, k):
    """The particle-sharded forward on this rank's rows."""
    cfg, stats, tparams = _setup(model, meta, params)
    forward = sharded.make_particle_sharded_forward(cfg, stats, mesh, num_neighbors=k,
                                                    neighbor_query_tile=32)
    reset_collectives()
    out = forward(tparams, _rows(mesh, pos), _rows(mesh, temp))
    return {"out": {key: v.numpy() for key, v in out.items()},
            "collectives": dict(collectives)}


def rollout_case(mesh, model, meta, params, pos, temp, k, steps, reneighbor_every):
    """A particle-sharded rollout on this rank's rows."""
    cfg, stats, tparams = _setup(model, meta, params)
    rollout = sharded.make_sharded_rollout(cfg, stats, mesh, steps, num_neighbors=k,
                                           neighbor_query_tile=32,
                                           reneighbor_every=reneighbor_every)
    reset_collectives()
    out = rollout(tparams, _rows(mesh, pos), _rows(mesh, temp))
    return {"out": {key: v.numpy() for key, v in out.items()},
            "collectives": dict(collectives)}


def trainer_case(mesh, model, meta, params, tc, train_dir, val_dir):
    """``Trainer(mesh=...).fit`` over the HDF5 sets: the returned (best)
    params and the history."""
    cfg, stats, tparams = _setup(model, meta, params)
    tc = TrainConfig(**tc)
    train = SequenceDataset(train_dir, tc.window_size, meta)
    val = SequenceDataset(val_dir, tc.window_size, meta)
    trainer = Trainer(cfg, stats, tc, len(train) // tc.batch_size, tparams, mesh=mesh,
                      device="cpu")
    reset_collectives()
    best = trainer.fit(train, val, verbose=False)
    return {"params": [t.detach().numpy().copy() for t in tree_leaves(best)],
            "history": trainer.history, "collectives": dict(collectives)}


def cli_case(mesh, argv):
    """``cli.train`` with ``argv`` (``--distributed --data_parallel``): it
    joins this process group and trains on a mesh of every rank."""
    trainer = train_cli.main(argv)
    return {"params": [a.copy() for a in tree_leaves(params_to_numpy(trainer.params))],
            "mesh": trainer.mesh.shape, "history": trainer.history}


CASES = {"train": train_case, "eval": eval_case, "forward": forward_case,
         "rollout": rollout_case, "trainer": trainer_case, "cli": cli_case}


def run_cases(cases):
    """One rank: every case in order (a mesh of its shape on the CPU),
    ``{name: result}``."""
    torch.set_num_threads(1)
    out = {}
    for name, kind, shape, kwargs in cases:
        mesh = make_mesh(shape, device="cpu") if shape else None
        out[name] = (CASES[kind] if isinstance(kind, str) else kind)(mesh, **kwargs)
    return out


class Ranks(LocalRanks):
    """``world`` gloo ranks running ``cases`` (``(name, kind, mesh shape or
    None, kwargs)``), started at construction so the caller can compute its
    references meanwhile; ``results()`` waits for them and returns, per
    rank, ``{name: result}``."""

    def __init__(self, world: int, init_file: str, cases):
        super().__init__(world, run_cases, (cases,), device="cpu", timeout_s=RANK_TIMEOUT_S,
                         collective_timeout=COLLECTIVE_TIMEOUT, init_file=init_file)


def equal_on_every_rank(values) -> bool:
    """Whether a list of per-rank numpy trees hold the same values."""
    first = values[0]
    return all(all(np.array_equal(a, b) for a, b in zip(first, other)) for other in values[1:])
