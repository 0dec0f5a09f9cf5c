"""Process meshes over ``torch.distributed`` (counterpart of
``parallel/mesh.py``).

One process (rank) per GPU, on ``cuda:{LOCAL_RANK}`` over NCCL, or per CPU
process on the ``gloo`` backend. Ranks that share one card ask for it
explicitly: ``backend="gloo"`` with ``device="cuda:0"`` (the collectives
then stage CUDA tensors through pinned host buffers, counted); nothing falls
back to it. A ``Mesh`` lays the world's ranks out on named axes:

* ``data``: batch (sample) data parallelism;
* ``particle``: particles sharded over ranks (the index-sharded path:
  positions and projected latents all-gathered each step; the halo path:
  slabs whose boundary rows go to the ring neighbours).

Each axis has one process group per line of ranks along it, and a rank
reaches its own through ``Mesh.axis(name)`` (its group, size and this
rank's coordinate), which the collectives (``parallel/collectives.py``)
take. Across nodes the data axis spans nodes and the other axes stay inside
one (``hybrid_device_order``), as the JAX package lays its data axis over
DCN.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cosmology_gnn_simulation_tpu_torch.types import resolve_device

DATA_AXIS = "data"
PARTICLE_AXIS = "particle"


def device_count() -> int:
    """The GPUs this process sees."""
    return torch.cuda.device_count()


def default_backend(device: torch.device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> bool:
    """Join the process group: by default NCCL for a ``cuda`` device, gloo
    for the CPU; ``backend`` names another (``"gloo"`` for ranks that share
    one card). No other backend is tried if that one fails. Call once on
    every rank before building a mesh.

    With no ``init_method`` it reads torchrun's environment (``MASTER_ADDR``,
    ``RANK``, ``WORLD_SIZE``); where that is absent it does nothing and
    returns False: the single-process path needs no process group. Returns
    True once this process is in a group. A rank on a card uses
    ``cuda:{LOCAL_RANK}``, or the card ``device`` names (``"cuda:0"``).
    ``timeout`` bounds each collective (the backend's default otherwise), so
    a hung peer fails the call instead of waiting."""
    if dist.is_initialized():
        return True
    env = all(os.environ.get(var) for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if init_method is None and not env:
        return False
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank() if device.index is None else device.index)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend or default_backend(device),
                            init_method=init_method or "env://", world_size=world_size,
                            rank=rank, **kw)
    return True


def local_rank() -> int:
    """This rank's index on its node (torchrun's ``LOCAL_RANK``; 0 alone)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def spatial_mesh(num_shards: int, device="cuda", backend: Optional[str] = None) -> "Mesh":
    """The ``(world // P, P)`` mesh of a CLI's halo run (``--spatial_shards
    P``; JAX lays out its devices so): joins torchrun's process group
    (``initialize_distributed`` with ``backend``) unless this process is in
    one. Raises ``ValueError`` without a process group, or when P does not
    divide the world size."""
    initialize_distributed(device=device, backend=backend)
    if not dist.is_initialized():
        raise ValueError(f"--spatial_shards {num_shards} runs one rank per shard: launch it "
                         f"with torchrun --nproc_per_node={num_shards} (or a multiple); this "
                         "process has no process group (MASTER_ADDR, RANK, WORLD_SIZE unset)")
    world = dist.get_world_size()
    if world % num_shards:
        raise ValueError(f"--spatial_shards {num_shards} must divide the world size {world} "
                         "(torchrun --nproc_per_node)")
    return make_mesh((world // num_shards, num_shards), device=device)


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """A rank and the node it runs on (the layout logic's view of a device:
    the JAX package's ``id`` and ``process_index``)."""

    rank: int
    node: int


def hybrid_device_order(ranks: Sequence[RankInfo], axis_sizes: Sequence[int],
                        data_axis: int = 0) -> np.ndarray:
    """Order ranks into a mesh array so the ``data`` axis spans nodes (the
    gradient all-reduce tolerates the slower network) while every other
    axis (the particle all-gathers) stays within a node's ranks. Pure layout
    logic over ``RankInfo`` records."""
    ranks = list(ranks)
    n = len(ranks)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis_sizes {tuple(axis_sizes)} must multiply to rank count {n}")
    nodes = sorted({r.node for r in ranks})
    per_node = n // len(nodes)
    by_node: Dict[int, list] = {node: [] for node in nodes}
    for r in ranks:
        by_node[r.node].append(r)
    if any(len(v) != per_node for v in by_node.values()):
        raise ValueError("ranks are not evenly distributed over nodes")
    if axis_sizes[data_axis] % len(nodes) != 0:
        raise ValueError(f"data axis size {axis_sizes[data_axis]} not divisible by node count "
                         f"{len(nodes)} — the data axis must span nodes")
    inner_sizes = list(axis_sizes)
    inner_sizes[data_axis] //= len(nodes)
    if int(np.prod(inner_sizes)) != per_node:
        raise ValueError(f"per-node axis sizes {tuple(inner_sizes)} must multiply to the "
                         f"ranks per node {per_node}")
    # Nodes in order along the data axis; within a node, ranks by index.
    blocks = []
    for node in nodes:
        block = np.empty(per_node, dtype=object)
        block[:] = sorted(by_node[node], key=lambda r: r.rank)
        blocks.append(block.reshape(inner_sizes))
    return np.concatenate(blocks, axis=data_axis)


class MeshAxis(NamedTuple):
    """One mesh axis as this rank sees it: the process group of its line of
    ranks along the axis, the axis size and this rank's coordinate."""

    name: str
    group: dist.ProcessGroup
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world's ranks on named axes: ``ranks`` is the mesh array of
    global ranks (axis order ``axis_names``); ``axes`` maps each name to this
    rank's ``MeshAxis``; ``device`` is where this rank computes."""

    axis_names: tuple
    ranks: np.ndarray
    rank: int
    axes: Dict[str, MeshAxis]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def axis(self, name: str) -> MeshAxis:
        return self.axes[name]


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data", "particle"),
    device=None,
) -> Mesh:
    """A mesh over every rank of the process group. Default: all ranks on
    the ``data`` axis. E.g. ``(1, P)`` shards particles over P ranks, ``(D,
    P)`` is D-way data x P-way particle parallelism.

    Without a process group (a single process, no ``initialize_distributed``)
    it makes a group of one over an in-memory store. Across nodes
    (``LOCAL_WORLD_SIZE`` below the world size) the data axis, or else the
    first axis the node count divides, spans nodes (``hybrid_device_order``).
    ``device``: ``cuda:{LOCAL_RANK}`` by default, another card
    (``"cuda:0"`` for ranks that share it) or the CPU."""
    device = resolve_device(f"cuda:{local_rank()}" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    if not dist.is_initialized():
        dist.init_process_group(default_backend(device), store=dist.HashStore(),
                                world_size=1, rank=0)
    world, rank = dist.get_world_size(), dist.get_rank()
    axis_names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(axis_names) - 1)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"axis_sizes {tuple(axis_sizes)} do not match axis_names {axis_names}")
    if int(np.prod(axis_sizes)) != world:
        raise ValueError(f"axis_sizes {tuple(axis_sizes)} must multiply to the world size "
                         f"{world}")
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    num_nodes = world // per_node
    if num_nodes > 1:
        span = axis_names.index("data") if "data" in axis_names else 0
        if axis_sizes[span] % num_nodes:
            fits = [i for i, s in enumerate(axis_sizes) if s % num_nodes == 0]
            if not fits:
                raise ValueError(f"no mesh axis in {tuple(axis_sizes)} is divisible by the "
                                 f"node count {num_nodes}")
            span = fits[0]
        order = hybrid_device_order([RankInfo(r, r // per_node) for r in range(world)],
                                    axis_sizes, data_axis=span)
        ranks = np.vectorize(lambda r: r.rank, otypes=[np.int64])(order)
    else:
        ranks = np.arange(world).reshape(axis_sizes)
    coords = [int(c[0]) for c in np.nonzero(ranks == rank)]
    axes = {}
    for dim, name in enumerate(axis_names):
        # Every rank creates every group, in the same order (new_group's
        # contract); each keeps its own line's.
        lines = np.moveaxis(ranks, dim, -1).reshape(-1, ranks.shape[dim])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                axes[name] = MeshAxis(name, group, int(ranks.shape[dim]), coords[dim])
    return Mesh(axis_names, ranks, rank, axes, device)
