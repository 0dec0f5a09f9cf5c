"""Halo-exchange spatial sharding (counterpart of ``parallel/halo.py``).

The periodic box is split into P slabs along x; shard d owns the particles
of slab layers ``[d * L, (d + 1) * L)`` of a cell grid ``G = P * L`` whose
edge keeps the 27-cell search exact, and sees ``halo_layers`` boundary
layers of each ring neighbour. The only traffic between ranks is the
boundary rows: their positions once a graph (``featurize_halo``), their
projected latents each message-passing step (``expand_candidates``, the
ring permute of ``parallel.collectives``), and in a rollout the particles
that leave their slab (``_migrate``). Every buffer has a static capacity
(``HaloConfig``) and its overflow is counted, never dropped silently; a
slab past ``local_capacity`` is refused loudly.

The host half, in numpy: ``HaloConfig`` and ``choose_halo_config`` (with the
measured-occupancy sizing), ``partition_windows`` / ``partition_batch`` (one
sample's, or a batch's, windows laid out in P slab segments with validity
masks and global ids; ``window_segment`` cuts one shard's out),
``reassemble_trajectory`` (per-slot rollout outputs back in the original
particle order), and the host mirror of one shard's exchange,
``shard_candidates`` with ``slab_frame`` (one device builds and checks a
shard's plan with no collective).

The device half, run by every rank of a ``(data, particle)`` mesh whose
particle axis has ``num_shards`` ranks: ``exchange_halo`` /
``expand_candidates``; ``featurize_halo`` (the shard's graph over its
candidate set, on the masked cell list with separate queries, and with a
slab spec its local cell-block plan, ``HaloCellBlock``);
``make_halo_train_step`` and ``shard_halo_batch``; ``make_halo_eval_step``;
``make_halo_rollout`` with migration and its per-step global certificate,
and ``run_halo_rollout``. The losses are masked means over the real
particles, summed over the particle axis, and the momentum penalty squares
the global impulse, so the halo step's gradient is the single-device
step's (the collectives' convention, ``parallel/collectives.py``).

Ranks that share one card run over a gloo group (``parallel.mesh``): every
exchange then goes through pinned host buffers, counted. The entry points
are ``Trainer(halo=...)`` and ``--spatial_shards`` in ``cli.train`` and
``cli.render_rollout``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch.featurize import window_features, window_targets
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import (
    CellGrid,
    cell_list_knn,
    choose_cell_grid,
    f32,
    poisson_occupancy_capacity,
    window_margin_sq,
)
from cosmology_gnn_simulation_tpu_torch.ops.periodic import (
    min_image_displacement,
    wrap_positions,
)
from cosmology_gnn_simulation_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_flat,
    ppermute,
    psum,
)
from cosmology_gnn_simulation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    PARTICLE_AXIS,
    Mesh,
    MeshAxis,
)
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, ParticleGraph


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


def window_segment(part: Dict[str, np.ndarray], hc: HaloConfig, shard: int):
    """Shard ``shard``'s segment of a ``partition_windows`` output: the
    ``make_halo_rollout`` arguments ``(positions [W, cap, 3], temperatures
    [W, cap, D], valid [cap], gid [cap])``."""
    seg = slice(shard * hc.local_capacity, (shard + 1) * hc.local_capacity)
    return (part["positions"][:, seg], part["temperatures"][:, seg], part["valid"][seg],
            part["gid"][seg])


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


# ---------------------------------------------------------------------------
# The exchange
# ---------------------------------------------------------------------------


class HaloCellBlock(NamedTuple):
    """One shard's cell-block state (the JAX ``HaloCellBlock``): ``plan``, a
    local ``ops.cellblock.CellBlockGraph`` over the candidate set ``[own;
    halo_left; halo_right]`` on the open slab grid
    (``choose_cellblock_spec_halo``), whose queries are the owned rows (halo
    and padding rows carry sentinel neighbor lists and own zero S rows); and
    ``inv_owned [local_capacity]``, the plan-order position of each owned
    row, the map back to the owned rows each step."""

    plan: object
    inv_owned: torch.Tensor


class HaloSends(NamedTuple):
    """One graph's boundary send sets (the JAX ``HaloSends``): the owned
    rows shipped to the left and right ring neighbours, ``[halo_capacity]``
    int64 each, ``local_capacity`` in an empty slot. Every message-passing
    step's exchange of the graph reuses them."""

    send_left: torch.Tensor
    send_right: torch.Tensor


def exchange_halo(values: torch.Tensor, halo: HaloSends, axis: MeshAxis):
    """Ship the boundary rows of ``values [local_capacity, ...]`` to the
    ring neighbours: returns ``(from_left, from_right)``, the rows this
    shard receives from its left and right neighbour (``[halo_capacity,
    ...]`` each; an empty send slot arrives as a zero row). Differentiable:
    the backward is the reverse permute and a scatter-add into the sent
    rows."""
    padded = torch.cat([values, values.new_zeros((1, *values.shape[1:]))])
    left_buf = padded.index_select(0, halo.send_left)
    right_buf = padded.index_select(0, halo.send_right)
    from_right = ppermute(left_buf, axis, -1)
    from_left = ppermute(right_buf, axis, 1)
    return from_left, from_right


def expand_candidates(values: torch.Tensor, halo: HaloSends, axis: MeshAxis) -> torch.Tensor:
    """``[own; halo_from_left; halo_from_right]``: the candidate rows every
    neighbor index of ``featurize_halo``'s graph points into."""
    from_left, from_right = exchange_halo(values, halo, axis)
    return torch.cat([values, from_left, from_right])


def _cell_x(recent: torch.Tensor, hc: HaloConfig, box: float) -> torch.Tensor:
    """Each row's x cell layer on the halo grid."""
    g = hc.grid_size
    return torch.clamp(torch.floor(recent[:, 0] * f32(g / box, recent.device)).long(), 0, g - 1)


def _first_rows(mask: torch.Tensor, capacity: int):
    """The rows where ``mask`` holds, in row order, then those where it does
    not, cut at ``capacity``: ``(rows, taken, left_out)``, ``taken`` whether
    ``mask`` holds at each and ``left_out`` the count of mask rows past the
    capacity."""
    rows = torch.argsort((~mask).to(torch.uint8), stable=True)[:capacity]
    return rows, mask[rows], torch.clamp(mask.sum() - capacity, min=0)


def _boundary_sends(cell_x: torch.Tensor, valid: torch.Tensor, hc: HaloConfig, axis: MeshAxis):
    """The boundary send sets from the owned rows' x layers: ``(HaloSends,
    overflow)``. Layers count from the slab's first with periodic centering,
    so a particle that wrapped across x = 0 is sent left."""
    g, layers = hc.grid_size, hc.slab_layers
    rel = torch.remainder(cell_x - axis.index * layers, g)
    rel = torch.where(rel > g // 2, rel - g, rel)  # centered: [-G/2, G/2)
    sends, overflow = [], 0
    for mask in (valid & (rel < hc.halo_layers), valid & (rel >= layers - hc.halo_layers)):
        rows, taken, left_out = _first_rows(mask, hc.halo_capacity)
        sends.append(torch.where(taken, rows, hc.local_capacity))
        overflow = overflow + left_out
    return HaloSends(*sends), overflow


def _local_frame(cand_pos: torch.Tensor, hc: HaloConfig, grid_x: int, box: float, shard: int):
    """``slab_frame`` on the device: the candidates in the slab's local x
    frame and the per-dimension box, float32 tensors with ``slab_frame``'s
    bits."""
    dev = cand_pos.device
    edge = box / hc.grid_size
    lo = f32(shard * hc.slab_layers - hc.halo_layers, dev) * f32(edge, dev)
    local = torch.cat([wrap_positions(cand_pos[:, :1] - lo, box), cand_pos[:, 1:]], dim=1)
    return local, torch.tensor([grid_x * edge, box, box], dtype=torch.float32, device=dev)


def featurize_halo(
    position_seq: torch.Tensor,
    temperature_seq: torch.Tensor,
    valid: torch.Tensor,
    stats: NormalizationStats,
    *,
    num_neighbors: int,
    hc: HaloConfig,
    axis: MeshAxis,
    generator: Optional[torch.Generator] = None,
    noise_std=0.0,
    query_tile: int = 2048,
    target_position: Optional[torch.Tensor] = None,
    target_temperature: Optional[torch.Tensor] = None,
    with_diagnostics: bool = False,
    noise_gids: Optional[torch.Tensor] = None,
    cellblock_spec=None,
    cellblock_reverse: bool = False,
):
    """One shard's graph with the halo exchange (the JAX ``featurize_halo``).

    ``featurize``'s semantics (noise-then-wrap, minimum-image velocities,
    raw-displacement edges, noise-shifted targets) over this shard's window
    ``[T, local_capacity, .]`` (its ``partition_windows`` segment; padding
    rows arbitrary, ``valid [local_capacity]`` the real ones); only the
    neighbor candidates differ: the owned rows and the boundary rows of the
    two ring neighbours, exchanged once (positions and validity in one
    payload), searched by the masked cell list with the owned rows as
    queries, so ``graph.neighbors`` index the candidate rows. The noise is
    drawn from ``generator`` and keyed per particle by ``noise_gids`` (the
    partition's ``gid``), which makes it the single-device step's.

    ``cellblock_spec`` (``choose_cellblock_spec_halo``): also the shard's
    local slab plan over the candidates (``graph.cellblock``, a
    ``HaloCellBlock``): x measured from ``halo_layers`` cells below the
    owned slab modulo the box (``slab_frame``'s frame), halo and padding
    rows with the no-edge sentinel lists, the validity mask;
    ``cellblock_reverse`` builds the reverse table (training).

    Returns ``(graph, halo, diagnostics)``: ``halo`` (``HaloSends``) goes
    to ``apply_encode_process_decode(..., particle_axis=axis, halo=halo)``;
    ``diagnostics`` (None unless ``with_diagnostics``) holds
    ``halo_overflow``, ``cell_overflow``, ``max_kth_d2`` (over the real
    queries), ``max_excess_sq`` (the largest k-th squared distance less its
    query's window margin; <= 0 certifies), ``cell_edge_sq`` and, with a
    spec, the plan's ``cb_overflow`` and ``cb_dropped``.
    """
    box = stats.box_size
    dev = position_seq.device
    valid = valid.to(dev, torch.bool)
    pos_seq, temp_seq, velocity_seq, nodes, position_noise, temperature_noise = window_features(
        position_seq, temperature_seq, stats, generator, noise_std, noise_gids)
    recent = pos_seq[:, -1]

    # The halo from the noised positions (the coordinates the search uses;
    # two halo layers cover sub-cell noise drift).
    halo, halo_overflow = _boundary_sends(_cell_x(recent, hc, box), valid, hc, axis)
    # One exchange of positions and validity (an empty slot arrives as a
    # zero, invalid row).
    cand = expand_candidates(torch.cat([recent, valid[:, None].float()], dim=-1), halo, axis)
    cand_pos, cand_valid = cand[:, :3], cand[:, 3] > 0.5
    grid = CellGrid(hc.grid_size, hc.cell_capacity)
    neighbors, (cell_overflow, _, _) = cell_list_knn(
        cand_pos, num_neighbors, box, grid, queries=recent, query_tile=max(query_tile, 4096),
        valid=cand_valid, return_diagnostics=True)

    # Raw (not minimum-image) displacement: halo rows carry the sender's
    # wrapped global coordinate, so these are the single-device features.
    disp = cand_pos[neighbors] - recent[:, None, :]
    edges = torch.cat([disp, torch.linalg.norm(disp, dim=-1, keepdim=True)], dim=-1)
    target_acceleration, target_temp_rate = window_targets(
        target_position, target_temperature, pos_seq, temp_seq, velocity_seq, position_noise,
        temperature_noise, stats)

    cb_state = None
    if cellblock_spec is not None:
        from cosmology_gnn_simulation_tpu_torch.ops.cellblock import build_cellblock

        cand_local, box_local = _local_frame(cand_pos, hc, cellblock_spec.gx, box, axis.index)
        n_cand, n_own = cand_pos.shape[0], neighbors.shape[0]
        # Halo rows query nothing: sentinel entries (>= n_cand) name no edge.
        nbr_full = torch.cat([neighbors, neighbors.new_full((n_cand - n_own, num_neighbors),
                                                            n_cand)])
        plan = build_cellblock(cand_local, nbr_full, box_local, cellblock_spec,
                               with_reverse=cellblock_reverse, valid=cand_valid)
        inv = torch.empty_like(plan.order)
        inv[plan.order] = torch.arange(n_cand, device=dev)
        cb_state = HaloCellBlock(plan=plan, inv_owned=inv[:n_own])

    graph = ParticleGraph(nodes=nodes, neighbors=neighbors, edges=edges, positions=recent,
                          cellblock=cb_state, target_acceleration=target_acceleration,
                          target_temp_rate=target_temp_rate)
    diagnostics = None
    if with_diagnostics:
        d2 = (min_image_displacement(recent[:, None, :] - cand_pos[neighbors], box) ** 2).sum(-1)
        kth = d2.max(dim=1).values
        margin_sq = window_margin_sq(recent, f32(box, dev), grid)
        diagnostics = {
            "halo_overflow": halo_overflow,
            "cell_overflow": cell_overflow,
            "max_kth_d2": torch.where(valid[:, None], d2, 0.0).max(),
            "max_excess_sq": torch.where(valid, kth - margin_sq, -torch.inf).max(),
            "cell_edge_sq": (box / hc.grid_size) ** 2,
        }
        if cb_state is not None:
            diagnostics["cb_overflow"] = cb_state.plan.overflow
            diagnostics["cb_dropped"] = cb_state.plan.dropped_edges
    return graph, halo, diagnostics


# ---------------------------------------------------------------------------
# The halo train and eval steps
# ---------------------------------------------------------------------------

_WINDOW_KEYS = ("positions", "temperatures")
_HALO_KEYS = (*_WINDOW_KEYS, "target_positions", "target_temperatures", "valid", "gid")


def _check_mesh(mesh: Mesh, hc: HaloConfig) -> None:
    if mesh.shape[PARTICLE_AXIS] != hc.num_shards:
        raise ValueError(f"mesh particle axis {mesh.shape[PARTICLE_AXIS]} != halo num_shards "
                         f"{hc.num_shards}")


def shard_halo_batch(batch, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of a ``partition_batch`` output (``positions [B, T,
    P * cap, 3]``, ``temperatures``, ``target_positions [B, P * cap, 3]``,
    ``target_temperatures``, ``valid`` and ``gid [B, P * cap]``): its
    samples along ``data`` and its slab segment along ``particle``, on
    ``mesh.device`` (``valid`` bool, ``gid`` int32, the rest float32)."""
    data, particle = mesh.axis(DATA_AXIS), mesh.axis(PARTICLE_AXIS)
    b, rows = batch["valid"].shape
    if b % data.size:
        raise ValueError(f"global batch size {b} not divisible by data-axis size {data.size}")
    if rows % particle.size:
        raise ValueError(f"{rows} partitioned rows not divisible by particle-axis size "
                         f"{particle.size}")
    bl, cap = b // data.size, rows // particle.size
    samples = slice(data.index * bl, (data.index + 1) * bl)
    segment = slice(particle.index * cap, (particle.index + 1) * cap)
    dtypes = {"valid": torch.bool, "gid": torch.int32}
    out = {}
    for key in _HALO_KEYS:
        value = torch.as_tensor(np.asarray(batch[key]))[samples]
        value = value[:, :, segment] if key in _WINDOW_KEYS else value[:, segment]
        out[key] = value.to(mesh.device, dtypes.get(key, torch.float32)).contiguous()
    return out


def _masked_sums(preds, graph: ParticleGraph, valid: torch.Tensor, dt: float) -> torch.Tensor:
    """One sample's shard-local sums over its real particles: ``[acc_sse,
    temp_sse, impulse (3), count]``."""
    mask = valid[:, None]
    acc_sse = torch.where(mask, (preds["acceleration"] - graph.target_acceleration) ** 2,
                          0.0).sum()
    temp_sse = torch.where(mask, (preds["temp_rate"] - graph.target_temp_rate) ** 2, 0.0).sum()
    impulse = torch.where(mask, preds["acceleration"] * dt, 0.0).sum(dim=0)
    return torch.cat([torch.stack([acc_sse, temp_sse]), impulse,
                      valid.sum().to(impulse.dtype)[None]])


def _global_terms(sums, particle: MeshAxis):
    """Per local sample, from the stacked ``_masked_sums`` summed over the
    particle axis (one reduction): the acceleration and temperature-rate
    MSEs over every real particle and the squared global impulse."""
    total = psum(torch.stack(sums), particle)
    count = total[:, 5]
    return total[:, 0] / (count * 3), total[:, 1] / count, (total[:, 2:5] ** 2).sum(dim=1)


def _step_setup(model_config, tc, mesh: Mesh, hc: HaloConfig):
    """The checks of a halo step; its compute dtype and model config (the
    fused tail resolved for the mesh's device)."""
    from cosmology_gnn_simulation_tpu_torch.ops.fused_step import resolve_fused_tail

    _check_mesh(mesh, hc)
    dtype = getattr(torch, tc.compute_dtype) if tc.compute_dtype else None
    cfg = model_config._replace(
        fused_tail=resolve_fused_tail(tc.fused_tail, model_config, mesh.device, dtype))
    return dtype, cfg


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {key: torch.as_tensor(batch[key]).to(device) for key in _HALO_KEYS}


def make_halo_train_step(model_config, stats: NormalizationStats, train_config, optimizer,
                         mesh: Mesh, hc: HaloConfig, cellblock_spec=None):
    """The halo-sharded train step ``(params, opt_state, batch, generator)
    -> (params, opt_state, metrics)`` (the JAX ``make_halo_train_step``),
    run on every rank of a ``(data, particle)`` mesh whose particle axis has
    ``hc.num_shards`` ranks. ``batch`` is this rank's ``shard_halo_batch``
    slice; ``params`` (on ``mesh.device``) and ``opt_state`` are updated in
    place, identically on every rank; ``metrics`` (``loss``,
    ``acceleration``, ``temp_rate``, ``momentum``) are the same on every
    rank.

    The losses are the single-device step's: masked sums over the real
    particles, summed over the particle axis with the global count, the
    momentum penalty of the global impulse, means over the batch; the
    gradients take one all-reduce, and equal the single-device step's.
    ``generator``, seeded alike on every rank, makes the single-device
    step's draws in its order: for each sample of the global batch the
    augmentation draw (unused: ``partition_batch`` augments on the host)
    and the noise keys, which the noise keys per particle by the batch's
    ``gid``: with the same generator the noised step is
    ``make_train_step``'s with ``partition_invariant_noise=True``.

    Without a spec the aggregation gathers over the candidate rows, and
    with ``build_reverse`` (as the single-device step) its backward is the
    sorted-edge segment sum over them, deterministic where autograd's
    scatter-add is not. ``cellblock_spec`` (``choose_cellblock_spec_halo``):
    the aggregation runs on each shard's slab plan (built with its reverse
    table; K4, and K4^T with the exchange's reverse in the backward)."""
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        apply_encode_process_decode,
    )
    from cosmology_gnn_simulation_tpu_torch.ops.aggregation import build_sorted_edges
    from cosmology_gnn_simulation_tpu_torch.ops.noise import gid_key
    from cosmology_gnn_simulation_tpu_torch.parallel.sharded import _sharded_loss
    from cosmology_gnn_simulation_tpu_torch.training.trainer import _axis_draw
    from cosmology_gnn_simulation_tpu_torch.types import tree_leaves

    tc = train_config
    dtype, cfg = _step_setup(model_config, tc, mesh, hc)
    data, particle = mesh.axis(DATA_AXIS), mesh.axis(PARTICLE_AXIS)

    def train_step(params, opt_state, batch, generator):
        batch = _to_device(batch, mesh.device)
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        b_local = batch["valid"].shape[0]
        sums = []
        for b in range(b_local * data.size):
            _axis_draw(generator, mesh.device)
            local = b - data.index * b_local
            if not 0 <= local < b_local:  # another data rank's sample: its keys
                if float(tc.noise_std) != 0.0:
                    gid_key(generator, mesh.device), gid_key(generator, mesh.device)
                continue
            valid = batch["valid"][local]
            graph, halo, _ = featurize_halo(
                batch["positions"][local], batch["temperatures"][local], valid, stats,
                num_neighbors=tc.num_neighbors, hc=hc, axis=particle, generator=generator,
                noise_std=tc.noise_std, query_tile=tc.neighbor_query_tile,
                target_position=batch["target_positions"][local],
                target_temperature=batch["target_temperatures"][local],
                noise_gids=batch["gid"][local], cellblock_spec=cellblock_spec,
                cellblock_reverse=cellblock_spec is not None)
            if cellblock_spec is None and tc.build_reverse:
                graph = graph._replace(sorted_edges=build_sorted_edges(graph.neighbors,
                                                                       hc.candidate_count))
            preds = apply_encode_process_decode(params, graph, cfg, dtype,
                                                cellblock_spec=cellblock_spec,
                                                cellblock_mode="hybrid", particle_axis=particle,
                                                halo=halo)
            sums.append(_masked_sums(preds, graph, valid, stats.dt))
        loss, components = _sharded_loss(*_global_terms(sums, particle), tc, mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        optimizer.apply(opt_state, all_reduce_flat(grads))
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in components.items()}}
        return params, opt_state, metrics

    return train_step


def make_halo_eval_step(model_config, stats: NormalizationStats, train_config, mesh: Mesh,
                        hc: HaloConfig):
    """The halo-sharded validation step ``(params, batch) -> metrics`` (the
    JAX ``make_halo_eval_step``): noise 0, no augmentation, no gradient,
    gather aggregation; ``metrics`` maps ``loss``, ``acceleration``,
    ``temp_rate`` and ``momentum`` to ``[B]`` vectors over the global batch
    (gathered over ``data``), as ``make_sharded_eval_step(per_sample=True)``,
    so a caller can pad a tail batch and mask the padding out."""
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        apply_encode_process_decode,
    )

    tc = train_config
    dtype, cfg = _step_setup(model_config, tc, mesh, hc)
    particle = mesh.axis(PARTICLE_AXIS)

    @torch.no_grad()
    def eval_step(params, batch) -> Dict[str, torch.Tensor]:
        batch = _to_device(batch, mesh.device)
        sums = []
        for b in range(batch["valid"].shape[0]):
            valid = batch["valid"][b]
            graph, halo, _ = featurize_halo(
                batch["positions"][b], batch["temperatures"][b], valid, stats,
                num_neighbors=tc.num_neighbors, hc=hc, axis=particle,
                query_tile=tc.neighbor_query_tile, target_position=batch["target_positions"][b],
                target_temperature=batch["target_temperatures"][b])
            preds = apply_encode_process_decode(params, graph, cfg, dtype, particle_axis=particle,
                                                halo=halo)
            sums.append(_masked_sums(preds, graph, valid, stats.dt))
        acc_se, temp_se, momentum = _global_terms(sums, particle)
        momentum = tc.momentum_loss_weight * momentum
        total = tc.acc_loss_weight * acc_se + tc.temp_rate_loss_weight * temp_se + momentum
        rows = all_gather(torch.stack([total, acc_se, temp_se, momentum], dim=1),
                          mesh.axis(DATA_AXIS))
        return dict(zip(("loss", "acceleration", "temp_rate", "momentum"), rows.unbind(1)))

    return eval_step


# ---------------------------------------------------------------------------
# The rollout with migration between slabs
# ---------------------------------------------------------------------------


def _migrate(pos_window, temp_window, valid, gid, hc: HaloConfig, box: float, axis: MeshAxis):
    """Ship the particles whose integrated position left the slab to the
    ring neighbour that owns them now, and compact survivors and immigrants
    into the ``local_capacity`` slots (the JAX ``_migrate``). A step moves a
    particle one slab at most; one that went farther stays and is counted in
    ``stranded``, and slots past a capacity in ``overflow``: both 0 for an
    exact rollout. Both directions' ``migrate_capacity`` buffers go every
    step, empty or not. Returns ``(pos_window, temp_window, valid, gid,
    {"overflow", "stranded"})``."""
    p, d = hc.num_shards, axis.index
    n_cap, t = hc.local_capacity, pos_window.shape[0]
    owner = _cell_x(pos_window[-1], hc, box) // hc.slab_layers
    go_left = valid & (owner == (d - 1) % p) & (owner != d)
    go_right = valid & (owner == (d + 1) % p) & (owner != d) & ~go_left
    keep = valid & ~go_left & ~go_right
    stranded = (valid & (owner != d) & ~go_left & ~go_right).sum()

    # One int32 row a particle (its window's bits, its id, its flag), so
    # one gather and one permute move it whole and bit for bit.
    def rows_of(flags):
        return torch.cat([pos_window.transpose(0, 1).reshape(n_cap, -1).view(torch.int32),
                          temp_window.transpose(0, 1).reshape(n_cap, -1).view(torch.int32),
                          gid[:, None], flags[:, None].to(torch.int32)], dim=1)

    own = rows_of(keep)

    def buffer(mask):
        picked, sent, overflow = _first_rows(mask, hc.migrate_capacity)
        buf = own[torch.where(sent, picked, 0)]
        buf[:, -1] = sent.to(torch.int32)
        return buf, overflow

    left_buf, left_over = buffer(go_left)
    right_buf, right_over = buffer(go_right)
    from_right = ppermute(left_buf, axis, -1)
    from_left = ppermute(right_buf, axis, 1)
    every = torch.cat([own, from_left, from_right])
    all_valid = every[:, -1] != 0
    order = torch.argsort((~all_valid).to(torch.uint8), stable=True)[:n_cap]
    overflow = torch.clamp(all_valid.sum() - n_cap, min=0) + left_over + right_over
    every = every[order]
    dt_ = temp_window.shape[-1]
    pos = every[:, :t * 3].contiguous().view(torch.float32).reshape(n_cap, t, 3)
    temp = every[:, t * 3:t * (3 + dt_)].contiguous().view(torch.float32).reshape(n_cap, t, dt_)
    return (pos.transpose(0, 1).contiguous(), temp.transpose(0, 1).contiguous(),
            every[:, -1] != 0, every[:, -2].contiguous(),
            {"overflow": overflow, "stranded": stranded})


# The per-step certificate components (the JAX ``make_halo_rollout``'s),
# and how each combines over the particle axis.
_CERT_SUMS = ("halo_overflow", "cell_overflow", "migration_overflow", "migration_stranded",
              "cb_overflow", "cb_dropped")
_CERT_MAXES = ("max_excess_sq", "max_kth_d2")


def make_halo_rollout(model_config, stats: NormalizationStats, mesh: Mesh, num_steps: int,
                      hc: HaloConfig, *, num_neighbors: int = 16,
                      min_image_velocity: bool = False, dtype=None, query_tile: int = 2048,
                      with_certificate_components: bool = False, cellblock_spec=None):
    """The halo-sharded rollout (the JAX ``make_halo_rollout``, BASELINE
    config 5's plan), run on every rank of the mesh: ``(params, positions
    [W, cap, 3], temperatures [W, cap, 1], valid [cap], gid [cap]) ->
    (outputs, diag, exactness)`` on this rank's ``partition_windows``
    segment. ``outputs`` holds each step's ``positions [S, cap, 3]``,
    ``temperatures``, ``valid`` and ``gid [S, cap]`` of this rank's slots
    (they change as particles migrate: ``reassemble_trajectory`` puts them
    back in order); ``diag`` the migration ``overflow`` and ``stranded``
    (each shard's largest over the steps, summed over the shards);
    ``exactness [S]`` the global certificate of each step (no halo send,
    cell or migration overflow, no stranded particle, every k-th neighbor
    within its window margin, and with a spec no plan overflow or dropped
    edge), the same on every rank. ``with_certificate_components=True``
    appends a dict of each step's global components ``[S]``.

    Each step exchanges the positions and the latents of the boundary rows,
    then the migrating particles, and gathers the certificate's components
    over the particle axis in one call. ``cellblock_spec``
    (``choose_cellblock_spec_halo``): the aggregation on each shard's slab
    plan. The fused tail where the rollout's default turns it on."""
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        apply_encode_process_decode,
    )
    from cosmology_gnn_simulation_tpu_torch.ops.fused_step import resolve_fused_tail
    from cosmology_gnn_simulation_tpu_torch.rollout import integrate_step

    _check_mesh(mesh, hc)
    particle = mesh.axis(PARTICLE_AXIS)
    cfg = model_config._replace(
        fused_tail=resolve_fused_tail(None, model_config, mesh.device, dtype))
    box = stats.box_size
    names = _CERT_SUMS + _CERT_MAXES

    @torch.no_grad()
    def rollout_fn(params, positions, temperatures, valid, gid):
        dev = mesh.device
        pos_w = torch.as_tensor(positions).to(dev, torch.float32)
        temp_w = torch.as_tensor(temperatures).to(dev, torch.float32)
        valid = torch.as_tensor(valid).to(dev, torch.bool)
        gid = torch.as_tensor(gid).to(dev, torch.int32)
        outs = {"positions": [], "temperatures": [], "valid": [], "gid": []}
        rows = []
        zero = torch.zeros((), device=dev)
        for _ in range(num_steps):
            graph, halo, fdiag = featurize_halo(
                pos_w, temp_w, valid, stats, num_neighbors=num_neighbors, hc=hc, axis=particle,
                query_tile=query_tile, with_diagnostics=True, cellblock_spec=cellblock_spec)
            preds = apply_encode_process_decode(params, graph, cfg, dtype,
                                                cellblock_spec=cellblock_spec,
                                                cellblock_mode="hybrid", particle_axis=particle,
                                                halo=halo)
            new_position, new_temperature = integrate_step(
                pos_w[-1], pos_w[-2], temp_w[-1],
                preds["acceleration"] * stats.acc_std + stats.acc_mean,
                preds["temp_rate"] * stats.temp_rate_std + stats.temp_rate_mean, stats,
                min_image_velocity=min_image_velocity)
            pos_w = torch.cat([pos_w[1:], new_position[None]])
            temp_w = torch.cat([temp_w[1:], new_temperature[None]])
            pos_w, temp_w, valid, gid, mdiag = _migrate(pos_w, temp_w, valid, gid, hc, box,
                                                        particle)
            for key, value in (("positions", pos_w[-1]), ("temperatures", temp_w[-1]),
                               ("valid", valid), ("gid", gid)):
                outs[key].append(value)
            local = {**fdiag, "migration_overflow": mdiag["overflow"],
                     "migration_stranded": mdiag["stranded"]}
            row = torch.stack([torch.as_tensor(local.get(name, zero), device=dev).float()
                               for name in names])
            del graph, preds  # the step's plan goes before the next one is built
            # Every rank's components of this step, in one call: the
            # certificate is then the same on every rank.
            rows.append(all_gather(row[None], particle))
        rows = torch.stack(rows)  # [S, P, components]
        sums = len(_CERT_SUMS)
        certs = {name: rows[:, :, i].sum(dim=1) for i, name in enumerate(_CERT_SUMS)}
        certs.update({name: rows[:, :, sums + i].max(dim=1).values
                      for i, name in enumerate(_CERT_MAXES)})
        exactness = (rows[:, :, :sums].sum(dim=(1, 2)) == 0) & (certs["max_excess_sq"] <= 0.0)
        diag = {"overflow": rows[:, :, names.index("migration_overflow")].max(dim=0).values.sum(),
                "stranded": rows[:, :, names.index("migration_stranded")].max(dim=0).values.sum()}
        outs = {key: torch.stack(values) for key, values in outs.items()}
        if with_certificate_components:
            return outs, diag, exactness, certs
        return outs, diag, exactness

    return rollout_fn


def run_halo_rollout(params, model_config, initial_positions, initial_temperatures,
                     stats: NormalizationStats, num_steps: int, mesh: Mesh, hc: HaloConfig, *,
                     num_neighbors: int = 16, min_image_velocity: bool = False, dtype=None,
                     query_tile: int = 2048, cellblock_spec=None):
    """Partition, halo rollout and reassembly (the JAX ``run_halo_rollout``),
    called by every rank with the same global ``[W, N, .]`` seed window:
    ``rollout``'s trajectory layout (numpy ``Coordinates`` and
    ``InternalEnergy`` ``[W + S, N, .]`` and the per-step
    ``neighbor_exactness``) and the migration diagnostics ``{"overflow",
    "stranded"}`` as ints, the same on every rank (the outputs are gathered
    over the particle axis)."""
    init_pos = np.asarray(initial_positions, np.float32)
    init_temp = np.asarray(initial_temperatures, np.float32)
    part = partition_windows(init_pos, init_temp, hc, stats.box_size)
    particle = mesh.axis(PARTICLE_AXIS)
    fn = make_halo_rollout(model_config, stats, mesh, num_steps, hc,
                           num_neighbors=num_neighbors, min_image_velocity=min_image_velocity,
                           dtype=dtype, query_tile=query_tile, cellblock_spec=cellblock_spec)
    outs, diag, exactness = fn(params, *window_segment(part, hc, particle.index))
    # Every shard's slots in one gather: [cap, S, 3 + D + 2] int32 rows.
    d = outs["temperatures"].shape[-1]
    rows = torch.cat([outs["positions"].view(torch.int32), outs["temperatures"].view(torch.int32),
                      outs["gid"][..., None], outs["valid"][..., None].to(torch.int32)], dim=-1)
    rows = all_gather(rows.transpose(0, 1).contiguous(), particle).transpose(0, 1).cpu()
    full = {"positions": rows[..., :3].contiguous().view(torch.float32).numpy(),
            "temperatures": rows[..., 3:3 + d].contiguous().view(torch.float32).numpy(),
            "gid": rows[..., 3 + d].numpy(), "valid": rows[..., 4 + d].numpy() != 0}
    traj = reassemble_trajectory(full, init_pos, init_temp)
    traj["neighbor_exactness"] = exactness.cpu().numpy()
    return traj, {key: int(value) for key, value in diag.items()}
