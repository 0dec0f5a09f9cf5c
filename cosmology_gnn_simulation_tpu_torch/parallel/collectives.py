"""Autograd-aware collectives over one mesh axis (the JAX package's
``lax.all_gather(tiled=True)``, ``psum``, ``pmean`` and ``axis_index``
inside ``shard_map``).

Every rank evaluates the same replicated loss and the step sums the
parameter gradients over all ranks (``all_reduce_flat``). The transposes
below fit that convention, as JAX's do for a result replicated over the
axis:

* ``all_gather``: each rank's gathered rows feed its own share of the loss,
  so a row's cotangent is the sum of every rank's: ``all_reduce`` of the
  gathered gradient, then this rank's rows. (gloo has no reduce-scatter;
  the all-reduce is exact and moves P times the bytes.) A reduced-precision
  gradient is summed in float32.
* ``psum``: the result is replicated, each rank backpropagates the same
  cotangent into its own summand: the identity.
* ``pmean``: likewise, scaled by ``1 / size``.

Each call to the backend adds one to ``collectives[kind]``
(``"all_gather"``, ``"all_reduce"`` or ``"broadcast"``), forward and
backward alike, so a caller can zero the counts, drive a step and hold the
count exact (as ``kernels.launches`` does for kernels). Every collective
runs, also on an axis of one rank.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from cosmology_gnn_simulation_tpu_torch.parallel.mesh import MeshAxis

collectives: Dict[str, int] = {"all_gather": 0, "all_reduce": 0, "broadcast": 0}

# torch 2.13 renamed all_gather_into_tensor; the signature is the same.
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def reset_collectives() -> None:
    for kind in collectives:
        collectives[kind] = 0


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (float32 for reduced precision)."""
    wide = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    dist.all_reduce(wide, group=group)
    collectives["all_reduce"] += 1
    if wide is not t:
        t.copy_(wide)
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: MeshAxis):
        ctx.axis = axis
        x = x.contiguous()
        out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
        _gather_into(out, x, group=axis.group)
        collectives["all_gather"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        g = _all_reduce(g.contiguous().clone(), axis.group)
        rows = g.shape[0] // axis.size
        return g[axis.index * rows:(axis.index + 1) * rows], None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: MeshAxis):
        return _all_reduce(x.detach().clone(), axis.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The axis's ranks' ``x`` concatenated along dim 0 in coordinate order
    (``lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, axis)


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum of ``x`` over the axis, on every rank of it."""
    return _PSum.apply(x, axis)


def pmean(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The mean of ``x`` over the axis, on every rank of it."""
    return psum(x, axis) / axis.size


def axis_index(axis: MeshAxis) -> int:
    """This rank's coordinate on the axis."""
    return axis.index


def all_reduce_flat(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Sum every tensor over ``group`` (default: the world) with one
    all-reduce of a flat float32 buffer of them, in their order."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    return _split(_all_reduce(flat, group), tensors)


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``flat`` cut back into tensors shaped and typed as ``like``."""
    out, start = [], 0
    for t in like:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


def broadcast_flat(tensors: Sequence[torch.Tensor], src: int = 0) -> List[torch.Tensor]:
    """Rank ``src``'s values of every tensor, on every rank of the world:
    one broadcast of a flat float32 buffer of them."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.broadcast(flat, src=src)
    collectives["broadcast"] += 1
    return _split(flat, tensors)
