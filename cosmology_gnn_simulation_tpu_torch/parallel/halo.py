"""The halo decomposition's host half (counterpart of ``parallel/halo.py``):
its geometry and the host-side partition of the particles, in numpy, with
no collective.

The periodic box is split into P slabs along x; shard d owns the particles
of slab layers ``[d * L, (d + 1) * L)`` of a cell grid ``G = P * L`` whose
edge keeps the 27-cell search exact, and sees ``halo_layers`` boundary
layers of each ring neighbour. Every buffer has a static capacity
(``HaloConfig``); a slab past ``local_capacity`` is refused loudly.

Here: ``HaloConfig`` and ``choose_halo_config`` (with the measured-occupancy
sizing), ``partition_windows`` / ``partition_batch`` (one sample's, or a
batch's, windows laid out in P slab segments with validity masks and global
ids) and ``reassemble_trajectory`` (per-slot rollout outputs back in the
original particle order); and the host mirror of one shard's boundary
exchange, ``shard_candidates`` (the JAX ``_boundary_sends`` and
``expand_candidates`` of shard d, from every shard's rows), with
``slab_frame``, the shard's local x frame that its cell-block plan bins in
(``ops.cellblock.choose_cellblock_spec_halo``). These two let one device
build and check a shard's plan with no collective.

Not ported yet: the exchange on ``torch.distributed`` (``exchange_halo``,
``expand_candidates``), ``featurize_halo``, the halo train and eval steps,
migration and ``run_halo_rollout`` (ROADMAP queue 1 item 5b-ii), and
``Trainer(halo=...)``, ``shard_halo_batch`` and ``--spatial_shards``
(item 5b-iii).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

from cosmology_gnn_simulation_tpu_torch.ops.cell_list import (
    choose_cell_grid,
    poisson_occupancy_capacity,
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class HaloConfig(NamedTuple):
    """Static halo-decomposition geometry (the JAX ``HaloConfig``)."""

    num_shards: int  # P: particle-axis size
    grid_size: int  # G = P * slab_layers
    cell_capacity: int  # C: cell-list capacity
    halo_layers: int  # boundary cell layers exchanged per side
    local_capacity: int  # owned-particle slots per shard
    halo_capacity: int  # exchanged-particle slots per side
    migrate_capacity: int  # migration slots per direction per step

    @property
    def slab_layers(self) -> int:
        return self.grid_size // self.num_shards

    @property
    def candidate_count(self) -> int:
        return self.local_capacity + 2 * self.halo_capacity


def choose_halo_config(
    num_particles: int,
    k: int,
    num_shards: int,
    *,
    noise: bool = False,
    local_slack: float = 1.3,
    halo_slack: float = 2.0,
    capacity_multiplier: float = 2.5,
    positions: Optional[np.ndarray] = None,
    box: float = 1.0,
    slab_layers: Optional[int] = None,
) -> HaloConfig:
    """A halo decomposition for data in a box of edge ``box`` (the JAX
    chooser's arithmetic). Without ``positions`` the capacities assume
    about uniform occupancy; a representative frame ``positions [N, 3]``
    sizes the local, halo and cell capacities from its measured slab,
    boundary-layer and cell occupancies instead (never below the uniform
    plan). ``halo_layers`` is 2 with ``noise`` (a noised query can leave its
    slab by a cell), else 1. ``slab_layers`` picks a coarser grid than the
    exactness grid's. Raises for ``num_shards < 2`` (one shard's periodic
    grid already holds its boundary particles) and where P slabs of at
    least ``2 * halo_layers`` exact layers do not fit."""
    if num_shards < 2:
        raise ValueError("halo decomposition needs num_shards >= 2")
    base = choose_cell_grid(num_particles, k, capacity_multiplier=capacity_multiplier)
    halo_layers = 2 if noise else 1
    if slab_layers is None:
        slab_layers = base.grid_size // num_shards
    elif slab_layers > max(base.grid_size // num_shards, 2 * halo_layers):
        raise ValueError(
            f"slab_layers={slab_layers} is FINER than the exactness grid allows "
            f"({base.grid_size // num_shards}); coarser (smaller) values trade throughput "
            "for certificate margin on clustered or drifting data.")
    if slab_layers < 2 * halo_layers:
        raise ValueError(
            f"N={num_particles}, k={k} supports a grid of only {base.grid_size} exact cell "
            f"layers; {num_shards} slabs of >= {2 * halo_layers} layers do not fit. Use fewer "
            "particle shards or parallel.sharded's all-gather path.")
    grid_size = slab_layers * num_shards
    # Larger cells than the exactness grid's: capacity from the new mean
    # occupancy with a Poisson-quantile floor.
    occupancy = num_particles / grid_size**3
    cell_capacity = int(max(k, np.ceil(capacity_multiplier * occupancy),
                            poisson_occupancy_capacity(occupancy, grid_size**3)))
    per_layer = num_particles / grid_size  # expected particles per layer
    local_capacity = _round_up(int(np.ceil(num_particles / num_shards * local_slack)), 8)
    halo_capacity = _round_up(int(np.ceil(halo_layers * per_layer * halo_slack)), 8)
    if positions is not None:
        pos = np.remainder(np.asarray(positions, np.float64), box)
        # Measured slab occupancy (the ownership rule of partition_windows).
        owner = np.clip(np.floor(pos[:, 0] / box * num_shards).astype(np.int64), 0,
                        num_shards - 1)
        slab_max = int(np.bincount(owner, minlength=num_shards).max())
        # Measured boundary-layer mass: the worst sum of halo_layers
        # adjacent layers at a slab edge (what one send carries).
        layer = np.clip(np.floor(pos[:, 0] / box * grid_size).astype(np.int64), 0,
                        grid_size - 1)
        layer_counts = np.bincount(layer, minlength=grid_size)
        edge_max = 0
        for s in range(num_shards):
            lo, hi = s * slab_layers, (s + 1) * slab_layers
            edge_max = max(edge_max, int(layer_counts[lo:lo + halo_layers].sum()),
                           int(layer_counts[hi - halo_layers:hi].sum()))
        # Measured cell occupancy for the shard-local cell lists.
        coords = np.clip(np.floor(pos / box * grid_size).astype(np.int64), 0, grid_size - 1)
        cell_ids = (coords[:, 0] * grid_size + coords[:, 1]) * grid_size + coords[:, 2]
        cell_max = int(np.bincount(cell_ids, minlength=grid_size**3).max())
        # Modest slack over the measurement, floored at the uniform plan.
        local_capacity = max(local_capacity, _round_up(int(np.ceil(slab_max * 1.15)), 8))
        halo_capacity = max(halo_capacity, _round_up(int(np.ceil(edge_max * 1.3)), 8))
        cell_capacity = max(cell_capacity, int(np.ceil(cell_max * 1.3)))
    return HaloConfig(num_shards=num_shards, grid_size=grid_size, cell_capacity=cell_capacity,
                      halo_layers=halo_layers, local_capacity=local_capacity,
                      halo_capacity=halo_capacity, migrate_capacity=halo_capacity)


def partition_windows(
    position_seq: np.ndarray,
    temperature_seq: np.ndarray,
    hc: HaloConfig,
    box: float,
    target_position: Optional[np.ndarray] = None,
    target_temperature: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """One sample's ``[T, N, .]`` windows in P slab segments: arrays of
    ``P * local_capacity`` rows along the particle axis (shard s owns rows
    ``[s * cap, (s + 1) * cap)``, by the last frame's x), with ``valid``
    and ``gid`` (each row's original particle index); padding rows are
    zero. Raises if a slab exceeds ``local_capacity``."""
    p, cap = hc.num_shards, hc.local_capacity
    recent = np.asarray(position_seq[-1])
    owner = np.clip(np.floor(recent[:, 0] / box * p).astype(np.int64), 0, p - 1)
    counts = np.bincount(owner, minlength=p)
    if counts.max() > cap:
        raise ValueError(
            f"slab occupancy {counts.max()} exceeds local_capacity {cap} "
            f"(counts={counts.tolist()}) — the data is more clustered than the capacity "
            "plan. Remedies, in order: (a) pass a representative frame as "
            "choose_halo_config(positions=...) so capacities are sized from measured "
            "occupancies; (b) raise local_slack; (c) use fewer particle shards; (d) fall back "
            "to parallel.sharded's all-gather path.")
    t = position_seq.shape[0]
    out_pos = np.zeros((t, p * cap, 3), np.float32)
    out_temp = np.zeros((t, p * cap, temperature_seq.shape[-1]), np.float32)
    valid = np.zeros((p * cap,), bool)
    gid = np.zeros((p * cap,), np.int32)
    out_tpos = np.zeros((p * cap, 3), np.float32) if target_position is not None else None
    out_ttemp = (np.zeros((p * cap, target_temperature.shape[-1]), np.float32)
                 if target_temperature is not None else None)
    for s in range(p):
        idx = np.nonzero(owner == s)[0]
        seg = slice(s * cap, s * cap + len(idx))
        out_pos[:, seg] = position_seq[:, idx]
        out_temp[:, seg] = temperature_seq[:, idx]
        valid[seg] = True
        gid[seg] = idx
        if out_tpos is not None:
            out_tpos[seg] = target_position[idx]
        if out_ttemp is not None:
            out_ttemp[seg] = target_temperature[idx]
    result = {"positions": out_pos, "temperatures": out_temp, "valid": valid, "gid": gid}
    if out_tpos is not None:
        result["target_positions"] = out_tpos
    if out_ttemp is not None:
        result["target_temperatures"] = out_ttemp
    return result


def partition_batch(
    batch: Dict[str, np.ndarray],
    hc: HaloConfig,
    box: float,
    *,
    augment_prob: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """``partition_windows`` of each sample of a ``[B, T, N, .]`` training
    batch, stacked. The xyz permutation augmentation runs here, on the host
    and before the partition (the slabs follow the permuted x), drawn from
    ``rng`` with probability ``augment_prob``."""
    parts = []
    for i in range(batch["positions"].shape[0]):
        pos = np.asarray(batch["positions"][i])
        tpos = np.asarray(batch["target_positions"][i])
        temp = np.asarray(batch["temperatures"][i])
        ttemp = np.asarray(batch["target_temperatures"][i])
        if rng is not None and augment_prob > 0 and rng.random() < augment_prob:
            perm = rng.permutation(3)
            pos = pos[..., perm]
            tpos = tpos[..., perm]
        parts.append(partition_windows(pos, temp, hc, box, target_position=tpos,
                                       target_temperature=ttemp))
    return {key: np.stack([p[key] for p in parts]) for key in parts[0]}


def reassemble_trajectory(
    outs: Dict[str, np.ndarray],
    seed_positions: np.ndarray,
    seed_temperatures: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Per-slot rollout outputs (``positions [S, P * cap, 3]``,
    ``temperatures``, ``valid`` and ``gid`` ``[S, P * cap]``) back in the
    original particle order through the carried global ids, after the
    ground-truth seed window (``rollout``'s trajectory layout)."""
    w, n = seed_positions.shape[0], seed_positions.shape[1]
    steps = outs["positions"].shape[0]
    coords = np.zeros((w + steps, n, 3), np.float32)
    temps = np.zeros((w + steps, n, seed_temperatures.shape[-1]), np.float32)
    coords[:w] = seed_positions
    temps[:w] = seed_temperatures
    valid = np.asarray(outs["valid"])
    gid = np.asarray(outs["gid"])
    pos = np.asarray(outs["positions"])
    temp = np.asarray(outs["temperatures"])
    # One vectorized scatter over every (step, slot) pair.
    m = valid.reshape(-1)
    step_idx = np.repeat(np.arange(w, w + steps), valid.shape[1])[m]
    part_idx = gid.reshape(-1)[m]
    coords[step_idx, part_idx] = pos.reshape(-1, 3)[m]
    temps[step_idx, part_idx] = temp.reshape(-1, temp.shape[-1])[m]
    return {"Coordinates": coords, "InternalEnergy": temps}


def _sends(recent: np.ndarray, valid: np.ndarray, hc: HaloConfig, box: float, shard: int):
    """Shard ``shard``'s boundary send sets from its owned rows (the JAX
    ``_boundary_sends``): ``(send_left, send_right, overflow)``, each send
    the first ``halo_capacity`` rows of its mask in row order, the sentinel
    ``local_capacity`` past them. Layers count from the slab's first with
    periodic centering, so a particle wrapped across x = 0 sends left."""
    g, layers = hc.grid_size, hc.slab_layers
    cell_x = np.clip(np.floor(recent[:, 0] * np.float32(g / box)).astype(np.int32), 0, g - 1)
    rel = np.mod(cell_x - shard * layers, g)
    rel = np.where(rel > g // 2, rel - g, rel)
    sends, overflow = [], 0
    for mask in (valid & (rel < hc.halo_layers), valid & (rel >= layers - hc.halo_layers)):
        order = np.argsort(~mask, kind="stable")[:hc.halo_capacity]
        sends.append(np.where(mask[order], order, hc.local_capacity))
        overflow += max(int(mask.sum()) - hc.halo_capacity, 0)
    return sends[0], sends[1], overflow


def shard_candidates(recent: np.ndarray, valid: np.ndarray, hc: HaloConfig, box: float,
                     shard: int):
    """Shard ``shard``'s candidate set ``[own; halo_from_left;
    halo_from_right]`` on the host, as the exchange builds it (the JAX
    ``_boundary_sends`` and ``expand_candidates``): ``recent [P * cap, 3]``
    float32 and ``valid [P * cap]`` are every shard's wrapped last-frame
    rows (``partition_windows``' layout). Returns ``(positions [cap + 2 *
    halo_cap, 3] float32, valid [cap + 2 * halo_cap] bool, overflow)``:
    sentinel send slots arrive as zero, invalid rows; ``overflow`` counts
    the boundary rows the two neighbours' sends left out."""
    p, cap = hc.num_shards, hc.local_capacity
    recent = np.asarray(recent, np.float32).reshape(p, cap, 3)
    valid = np.asarray(valid, bool).reshape(p, cap)
    left, right = (shard - 1) % p, (shard + 1) % p
    _, to_right, over_l = _sends(recent[left], valid[left], hc, box, left)
    to_left, _, over_r = _sends(recent[right], valid[right], hc, box, right)

    def received(s, send):  # a sentinel slot reads the appended zero row
        return (np.concatenate([recent[s], np.zeros((1, 3), np.float32)])[send],
                np.append(valid[s], False)[send])

    (l_pos, l_valid), (r_pos, r_valid) = received(left, to_right), received(right, to_left)
    positions = np.concatenate([recent[shard], l_pos, r_pos])
    flags = np.concatenate([valid[shard], l_valid, r_valid])
    return positions, flags, over_l + over_r


def slab_frame(cand_positions: np.ndarray, hc: HaloConfig, grid_x: int, box: float,
               shard: int):
    """Shard ``shard``'s candidates in its slab's local x frame (the JAX
    ``featurize_halo``'s, float32): x measured from ``halo_layers`` cells
    below the owned slab, modulo the box, so wrapped halo rows land in
    ``[0, grid_x * edge)``; y and z unchanged. Returns ``(positions [M, 3],
    box_local [3])``, the per-dimension box ``[grid_x * edge, box, box]``
    the plan bins over (``grid_x`` the slab spec's ``gx``)."""
    edge = box / hc.grid_size
    lo = np.float32(shard * hc.slab_layers - hc.halo_layers) * np.float32(edge)
    local = np.array(cand_positions, np.float32)
    local[:, 0] = np.remainder(local[:, 0] - lo, np.float32(box))
    return local, np.asarray([grid_x * edge, box, box], np.float32)
