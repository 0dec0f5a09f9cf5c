"""Autograd-aware collectives over one mesh axis (the JAX package's
``lax.all_gather(tiled=True)``, ``psum``, ``pmean``, ``ppermute`` and
``axis_index`` inside ``shard_map``).

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
* ``ppermute``: the rows a rank receives came from one other rank, so the
  cotangent goes back the reverse way (JAX's ``ppermute`` transpose).

Each call to the backend adds one to ``collectives[kind]``
(``"all_gather"``, ``"all_reduce"``, ``"broadcast"`` or ``"ppermute"``),
forward and backward alike, so a caller can zero the counts, drive a step
and hold the count exact (as ``kernels.launches`` does for kernels). Every
collective runs, also on an axis of one rank.

Backends. NCCL moves CUDA tensors on the device (the permute through
``batch_isend_irecv``). gloo moves host memory: it serves CPU tensors as
they are, and a CUDA tensor only when the group was asked for gloo (ranks
that share one card, ``parallel.mesh``), through pinned host buffers: a
copy down (which waits for the stream), the exchange, a ``non_blocking``
copy up. Every staged byte, down and up, adds to
``collectives_bytes["host_staged"]``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from cosmology_gnn_simulation_tpu_torch.parallel.mesh import MeshAxis

collectives: Dict[str, int] = {"all_gather": 0, "all_reduce": 0, "broadcast": 0,
                               "ppermute": 0}
collectives_bytes: Dict[str, int] = {"host_staged": 0}

# torch 2.13 renamed all_gather_into_tensor; the signature is the same.
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def reset_collectives() -> None:
    for kind in collectives:
        collectives[kind] = 0
    collectives_bytes["host_staged"] = 0


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through host buffers: a CUDA tensor
    on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _down(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t`` (it waits for the
    stream)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    collectives_bytes["host_staged"] += host.numel() * host.element_size()
    return host


def _up(host: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``host`` copied into the CUDA tensor ``out`` without waiting (the
    pinned block is not reused before the copy ends)."""
    out.copy_(host, non_blocking=True)
    collectives_bytes["host_staged"] += host.numel() * host.element_size()
    return out


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (float32 for reduced precision)."""
    wide = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    if _staged(wide, group):
        host = _down(wide)
        dist.all_reduce(host, group=group)
        _up(host, wide)
    else:
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
        if _staged(x, axis.group):
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            _gather_into(host, _down(x), group=axis.group)
            _up(host, out)
        else:
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


def _permute(x: torch.Tensor, axis: MeshAxis, shift: int) -> torch.Tensor:
    """``x`` sent to the rank ``shift`` places along the axis ring; what
    the rank ``shift`` places back sent. Each rank issues one send and one
    receive; on a ring of two both go to the one peer, told apart by their
    direction, and successive calls match in the order every rank issues
    them."""
    x = x.contiguous()
    collectives["ppermute"] += 1
    if axis.size == 1:
        return x.clone()
    dst = dist.get_global_rank(axis.group, (axis.index + shift) % axis.size)
    src = dist.get_global_rank(axis.group, (axis.index - shift) % axis.size)
    if dist.get_backend(axis.group) == "nccl":
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, dst, axis.group),
               dist.P2POp(dist.irecv, out, src, axis.group)]
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        return out
    staged = _staged(x, axis.group)
    send = _down(x) if staged else x
    recv = torch.empty(x.shape, dtype=x.dtype, pin_memory=staged)
    requests = [dist.isend(send, dst, group=axis.group), dist.irecv(recv, src, group=axis.group)]
    for request in requests:
        request.wait()
    return _up(recv, torch.empty_like(x)) if staged else recv


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: MeshAxis, shift: int):
        ctx.axis, ctx.shift = axis, shift
        return _permute(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.axis, -ctx.shift), None, None


def ppermute(x: torch.Tensor, axis: MeshAxis, shift: int) -> torch.Tensor:
    """The ring permute of the axis (``lax.ppermute`` with the permutation
    ``i -> (i + shift) % size``): ``x`` goes to the rank at ``(index +
    shift) % size`` and the result is what arrives from ``(index - shift) %
    size``. Its backward is the reverse permute of the cotangent."""
    return _PPermute.apply(x, axis, shift)


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
    if _staged(flat, None):
        host = _down(flat)
        dist.broadcast(host, src=src)
        _up(host, flat)
    else:
        dist.broadcast(flat, src=src)
    collectives["broadcast"] += 1
    return _split(flat, tensors)
