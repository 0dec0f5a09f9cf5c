"""The selection schedule of the k-NN kernels K1 (``csrc/knn_select.cu``:
ids, codes and dual modes) and K8 (``csrc/dense_select.cu``), emulated in
numpy and held equal, bit for bit, to their unchanged plain versions
(``knn_select_reference``, ``knn_codes_reference``, ``knn_dual_reference``,
``dense_select_reference``), which the other tests hold against the JAX
package. No CUDA and no JAX here.

What is emulated is what the kernels do, step by step
(``csrc/select_common.cuh``):
* the 64-bit key ``bits(d2) << 32 | payload`` (payload: the particle id,
  the candidate lane, or in the dual mode ``id << lane_bits | lane``),
  ordered by one unsigned compare;
* K1's staging: the cell, then its six face neighbors, then the rest, the
  occupied candidate slots compacted 32 at a time in the order the
  warps' atomics happen to reserve them (shuffled here), each keeping its
  original lane for the min-image and the codes;
* K8's scan from the round of 32 candidates around the warp's rows in
  their own column (ring column 4, where the block finds the tile's first
  query by its coordinates) on;
* WarpSelect: a warp queue of ``32 * KW`` keys sorted over (register,
  lane), per-lane thread queues of T keys that admit only keys below the
  k-th (the kernels first vote on ``d2 <= k-th's d2`` and offer keys only
  in rounds where some lane passes: the same admissions), and, when any
  lane's queue is full (every round while the queue
  has no k-th yet) and at the end, the merge of each thread-queue
  register: its keys inserted one at a time where it holds at most
  ``kSerialMax``, else its bitonic sort across the 32 lanes and,
  unless the queue is still empty, its reversal against the warp queue's
  last register and the bitonic merge;
* the outputs: sentinels for exhausted picks and empty rows, K8's padding
  rows.
Every d2 is float32 arithmetic in numpy, one rounding per operation, as the
kernels' ``__fsub_rn``/``__fmul_rn``/``__fadd_rn``: ids, codes, lanes and
the k-th distances (as int32 bits) must be equal.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu_torch.ops import cellblock, pallas_knn
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import (
    CellGrid,
    choose_cell_grid,
    f32,
    host_f32,
    poisson_occupancy_capacity,
)

CSRC = Path(pallas_knn.__file__).resolve().parents[1] / "csrc"
EMPTY = np.uint64(0x7149F2CAFFFFFFFF)  # select_common.cuh's kEmpty
BIG = np.float32(1e30)
LANES = np.arange(32)
NP, K = 2048, 8  # tests/test_torch_dense_search.py's size
# knn_select.cu's kNearFirst: the ring cells in staging order.
NEAR_FIRST = np.array([13, 4, 10, 12, 14, 16, 22] + [j for j in range(27)
                                                    if j not in (13, 4, 10, 12, 14, 16, 22)])


def _constant(source: str, name: str) -> int:
    """A kernel's build constant (``constexpr int name = value;``): the
    thread-queue depth T, K8's rows per warp, or the most keys a register
    inserts one at a time."""
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


SERIAL_MAX = _constant("select_common.cuh", "kSerialMax")
ROWS_PER_WARP = _constant("dense_select.cu", "kRowsPerWarp")


def pack(d2: np.ndarray, payload: np.ndarray) -> np.ndarray:
    return ((d2.astype(np.float32).view(np.uint32).astype(np.uint64) << np.uint64(32))
            | payload.astype(np.uint32).astype(np.uint64))


def key_d2(key: np.ndarray) -> np.ndarray:
    return (key >> np.uint64(32)).astype(np.uint32).view(np.float32)


def key_payload(key: np.ndarray) -> np.ndarray:
    return (key & np.uint64(0xFFFFFFFF)).astype(np.int64)


class WarpSelect:
    """``select_common.cuh``'s WarpSelect for a batch of query rows, one
    warp each: arrays ``[rows, register, lane]``."""

    def __init__(self, rows: int, k: int, t: int):
        self.k, self.t = k, t
        self.kw = 1 if k <= 32 else 2 if k <= 64 else 4
        self.wk = np.full((rows, self.kw, 32), EMPTY)
        self.wv = np.zeros((rows, self.kw, 32), np.int64)
        self.tk = np.full((rows, t, 32), EMPTY)
        self.tv = np.zeros((rows, t, 32), np.int64)
        self.count = np.zeros((rows, 32), np.int64)
        self.thr = np.full(rows, EMPTY)
        self.empty = np.ones(rows, bool)  # the warp queue holds no key yet

    def add(self, key, val, offered):
        admit = offered & (key < self.thr[:, None])
        for i in range(self.t - 1, 0, -1):
            self.tk[:, i] = np.where(admit, self.tk[:, i - 1], self.tk[:, i])
            self.tv[:, i] = np.where(admit, self.tv[:, i - 1], self.tv[:, i])
        self.tk[:, 0] = np.where(admit, key, self.tk[:, 0])
        self.tv[:, 0] = np.where(admit, val, self.tv[:, 0])
        self.count += admit
        assert (self.count <= self.t).all()

    def check(self):
        filling = (self.count > 0).any(1) & (self.thr == EMPTY)
        self._merge((self.count == self.t).any(1) | filling)

    def finish(self):
        self._merge((self.count > 0).any(1))

    @staticmethod
    def _exchange(key, val, j, keep_min):
        other, other_val = key[:, LANES ^ j], val[:, LANES ^ j]
        take = np.where(keep_min, other < key, other > key)
        return np.where(take, other, key), np.where(take, other_val, val)

    def _merge(self, rows):
        """Merge the thread queues of the warps (rows) where ``rows``."""
        idx = np.nonzero(rows)[0]
        if not len(idx):
            return
        for i in range(self.t):
            count = (self.tk[idx, i] != EMPTY).sum(1)
            self._insert(idx[(count > 0) & (count <= SERIAL_MAX)], i)
            self._sort_merge(idx[count > SERIAL_MAX], i)
            self.tk[idx, i] = EMPTY
        self.count[idx] = 0
        self.thr[idx] = self.wk[idx].reshape(len(idx), -1)[:, self.k - 1]

    def _insert(self, rows, i):
        """Insert each warp's keys of thread-queue register i one at a time,
        in lane order: the queue positions from the key's rank on shift up
        by one."""
        m = self.kw * 32
        q = np.arange(m)
        for lane in range(32):
            sub = rows[self.tk[rows, i, lane] != EMPTY]
            if not len(sub):
                continue
            x, xv = self.tk[sub, i, lane][:, None], self.tv[sub, i, lane][:, None]
            wk, wv = self.wk[sub].reshape(len(sub), m), self.wv[sub].reshape(len(sub), m)
            pos = (wk < x).sum(1, keepdims=True)
            prev_k = np.concatenate([wk[:, :1], wk[:, :-1]], 1)
            prev_v = np.concatenate([wv[:, :1], wv[:, :-1]], 1)
            self.wk[sub] = np.where(q < pos, wk, np.where(q == pos, x, prev_k)).reshape(
                -1, self.kw, 32)
            self.wv[sub] = np.where(q < pos, wv, np.where(q == pos, xv, prev_v)).reshape(
                -1, self.kw, 32)
        self.empty[rows] = False

    def _sort_merge(self, rows, i):
        """Bitonic-sort thread-queue register i across the lanes, reverse it
        against the warp queue's last register, bitonic-merge the queue."""
        if not len(rows):
            return
        key, val = self.tk[rows, i], self.tv[rows, i]
        size = 2
        while size <= 32:
            j = size // 2
            while j:
                keep_min = ((LANES & j) == 0) == ((LANES & size) == 0)
                key, val = self._exchange(key, val, j, keep_min)
                j //= 2
            size *= 2
        # Into an empty queue the sorted keys go as they are.
        first = self.empty[rows]
        self.wk[rows[first], 0], self.wv[rows[first], 0] = key[first], val[first]
        self.empty[rows] = False
        rows, key, val = rows[~first], key[~first], val[~first]
        wk, wv = self.wk[rows], self.wv[rows]
        rev, rev_val = key[:, LANES ^ 31], val[:, LANES ^ 31]
        take = rev < wk[:, -1]
        wk[:, -1] = np.where(take, rev, wk[:, -1])
        wv[:, -1] = np.where(take, rev_val, wv[:, -1])
        jr = self.kw // 2
        while jr:
            for r in range(self.kw):
                if r & jr == 0:
                    swap = wk[:, r | jr] < wk[:, r]
                    lo_k, hi_k = wk[:, r].copy(), wk[:, r | jr].copy()
                    lo_v, hi_v = wv[:, r].copy(), wv[:, r | jr].copy()
                    wk[:, r], wk[:, r | jr] = np.where(swap, hi_k, lo_k), np.where(swap, lo_k, hi_k)
                    wv[:, r], wv[:, r | jr] = np.where(swap, hi_v, lo_v), np.where(swap, lo_v, hi_v)
            jr //= 2
        j = 16
        while j:
            for r in range(self.kw):
                wk[:, r], wv[:, r] = self._exchange(wk[:, r], wv[:, r], j, (LANES & j) == 0)
            j //= 2
        self.wk[rows], self.wv[rows] = wk, wv

    def result(self):
        """The first k keys and values, in queue order ``r * 32 + lane``."""
        rows = self.wk.shape[0]
        return (self.wk.reshape(rows, -1)[:, :self.k],
                self.wv.reshape(rows, -1)[:, :self.k])


def _min_image(d, box):
    half = np.float32(0.5) * box
    d = np.where(d > half, d - box, d)
    return np.where(d < -half, d + box, d)


def k1_schedule(table, spill, *, k, n, g, box, mi_start, mode, t, seed=0):
    """K1's kernel, emulated: ``(picks, [codes,] kth)`` as its C entry."""
    tx, ty, tz, tids = (p.numpy() for p in table)
    sx, sy, sz, sids = (p.numpy() for p in spill)
    box = np.float32(box)
    num_cells, cap = tx.shape
    ring, spill_cap = 27 * cap, sx.shape[0]
    ncand = ring + spill_cap
    rng = np.random.default_rng(seed)
    # Staging: each cell's slots in lane order, pre-shifted where the
    # neighbor index wraps.
    cells = np.arange(num_cells)
    ci, cj, cl = cells // (g * g), (cells // g) % g, cells % g
    j27 = np.arange(27)
    raw = np.stack([ci[:, None] + j27 // 9 - 1, cj[:, None] + (j27 // 3) % 3 - 1,
                    cl[:, None] + j27 % 3 - 1], -1)  # [cells, 27, 3]
    wrapped = np.mod(raw, g)
    shift = (raw - wrapped) // g
    ncell = (wrapped[..., 0] * g + wrapped[..., 1]) * g + wrapped[..., 2]
    planes = []
    for d, plane in enumerate((tx, ty, tz)):
        c = plane[ncell]  # [cells, 27, cap]
        s = np.broadcast_to(shift[..., d:d + 1], c.shape)
        c = np.where(s != 0, c + s.astype(np.float32) * box, c).reshape(num_cells, ring)
        planes.append(np.concatenate([c, np.broadcast_to((sx, sy, sz)[d], (num_cells, spill_cap))],
                                     1).astype(np.float32))
    cid = np.concatenate([tids[ncell].reshape(num_cells, ring),
                          np.broadcast_to(sids, (num_cells, spill_cap))], 1)
    # Compaction in three passes, the cell, its face neighbors, the rest (the
    # staging order kNearFirst), each pass's 32-slot chunks reserved in the
    # order of the warps' atomics (any order), a chunk's occupied slots in
    # lane order; each keeps its lane j27 * cap + rank (spill: 27 * cap + s).
    order = np.concatenate([(NEAR_FIRST[:, None] * cap + np.arange(cap)).reshape(-1),
                            np.arange(ring, ncand)])
    lane_lists = []
    for cell in range(num_cells):
        slots = []
        for lo, hi in ((0, cap), (cap, 7 * cap), (7 * cap, ncand)):
            for c in rng.permutation(-(-(hi - lo) // 32)):
                slots.append(order[lo + 32 * c:min(lo + 32 * c + 32, hi)])
        slots = np.concatenate(slots)
        lane_lists.append(slots[cid[cell, slots] < n])
    width = max(1, max(len(x) for x in lane_lists))
    lanes = np.full((num_cells, width), -1)
    for cell, x in enumerate(lane_lists):
        lanes[cell, :len(x)] = x
    count = (lanes >= 0).sum(1)

    # The dual mode packs id and lane into the payload where they fit.
    lane_bits = max(1, int(ncand - 1).bit_length())
    packed = mode == "dual" and n - 1 < 2 ** (32 - lane_bits)
    rows = np.nonzero(tids.reshape(-1) < n)[0]
    rcell = rows // cap
    qx, qy, qz = (p.reshape(-1)[rows][:, None] for p in (tx, ty, tz))
    sel = WarpSelect(len(rows), k, t)
    for base in range(0, width, 32):
        c = base + LANES
        offered = c[None, :] < count[rcell][:, None]
        ln = np.where(offered, lanes[rcell[:, None], np.minimum(c, width - 1)], 0)
        d = [q - planes[i][rcell[:, None], ln] for i, q in enumerate((qx, qy, qz))]
        mi = ln >= mi_start
        d = [np.where(mi, _min_image(x, box), x) for x in d]
        d2 = d[0] * d[0]
        d2 = d2 + d[1] * d[1]
        d2 = d2 + d[2] * d[2]
        payload = ln if mode == "codes" else cid[rcell[:, None], ln]
        if packed:  # the dual mode's id << lane_bits | lane
            payload = (payload << lane_bits) | ln
        sel.add(pack(d2, payload), ln, offered)
        sel.check()
    sel.finish()
    keys, vals = sel.result()
    sentinel = ncand if mode == "codes" else n
    picked = key_d2(keys) < np.float32(0.5) * BIG
    out = np.full((num_cells * cap, k), sentinel, np.int64)
    out[rows] = np.where(picked, key_payload(keys), sentinel)
    kth = np.full(num_cells * cap, BIG, np.float32)
    kth[rows] = key_d2(keys[:, k - 1])
    if mode != "dual":
        return out, kth
    codes = np.full((num_cells * cap, k), ncand, np.int64)
    if packed:
        payload = key_payload(keys)
        out[rows] = np.where(picked, payload >> lane_bits, n)
        vals = payload & ((1 << lane_bits) - 1)
    codes[rows] = np.where(picked, vals, ncand)
    return out, codes, kth


def k8_schedule(table, queries, windows, box, *, k, qb, w_eff, t, rows=None):
    """K8's kernel, emulated: ``(lanes, kth)`` as its C entry."""
    table, queries, windows = table.numpy(), queries.numpy(), windows.numpy().astype(np.int64)
    box = np.float32(box)
    num_tiles, ncand = windows.shape[0], 9 * w_eff
    # Staging: the 9 windows of each tile, x and y shifted on load.
    j = np.arange(ncand) // w_eff
    idx = windows[:, j, 1] + np.arange(ncand) % w_eff  # [T, ncand]
    col = windows[:, j, 0]
    stage = [table[col, d, idx] for d in range(3)]
    stage[0] = stage[0] + windows[:, j, 2].astype(np.float32) * box
    stage[1] = stage[1] + windows[:, j, 3].astype(np.float32) * box
    live = np.full(num_tiles, qb) if rows is None else np.clip(rows.numpy(), 0, qb)
    # Each tile's first query, found among its own column's candidates
    # (ring column 4) by its coordinates; a warp's scan starts at the round
    # of 32 around its first row there (row 0 if not found).
    own = [s[:, 4 * w_eff:5 * w_eff] for s in stage]
    first_q = queries[::qb]
    match = np.logical_and.reduce([own[d] == first_q[:, d:d + 1] for d in range(3)])
    q0 = np.where(match.any(1), match.argmax(1), 0)
    r = np.arange(num_tiles * qb)
    tile = r // qb
    on = r % qb < live[tile]
    q = [queries[:, d][on][:, None] for d in range(3)]
    warp_row = (r % qb)[on] // ROWS_PER_WARP * ROWS_PER_WARP
    tile = tile[on]
    first = 4 * w_eff + np.clip(q0[tile] + warp_row - 15, 0, max(w_eff - 32, 0))
    sel = WarpSelect(int(on.sum()), k, t)
    for base in range(0, ncand, 32):
        offered = np.broadcast_to(base + LANES < ncand, (len(tile), 32))
        c = (first[:, None] + base + LANES) % ncand
        dd = [q[d] - stage[d][tile[:, None], c] for d in range(3)]
        d2 = dd[0] * dd[0] + dd[1] * dd[1]
        d2 = d2 + dd[2] * dd[2]
        sel.add(pack(d2, c), 0, offered)
        sel.check()
    sel.finish()
    keys, _ = sel.result()
    lanes = np.full((num_tiles * qb, k), ncand, np.int64)
    kth = np.full(num_tiles * qb, BIG, np.float32)
    lanes[on] = key_payload(keys)
    kth[on] = key_d2(keys[:, k - 1])
    return lanes, kth


def _equal(got, want):
    want = want.numpy()
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_array_equal(got, want)


# K1 frames (tests/test_torch_knn.py's): name -> (positions, k, grid spec).
def _uniform(seed, n):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)


def _spill(seed):
    rng = np.random.default_rng(seed)
    bg = rng.uniform(0, 1, (2048, 3))
    cram = 0.44 + 0.04 * rng.uniform(0, 1, (40, 3))
    return np.concatenate([bg, cram]).astype(np.float32)


def _lattice(seed, n, cram=0):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 1024, (n, 3))
    pos[:cram] = 450 + rng.integers(0, 40, (cram, 3))
    return (pos / 1024).astype(np.float32)


def _lattice_grid(n):
    return (8, poisson_occupancy_capacity(n / 8**3, 8**3))


# The uncertified regime's two clustered frames: a share of the particles in
# a normal ball of width sigma about the box centre, the rest uniform. The
# spill block overflows and sparse cells leave rows with fewer than k
# candidates (sentinel picks). name -> (share, sigma).
CLUSTERED = {"clustered95": (0.95, 0.01), "clustered30": (0.30, 0.05)}


def clustered_positions(n, name, seed=21):
    share, sigma = CLUSTERED[name]
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3))
    m = int(share * n)
    pos[:m] = 0.5 + sigma * rng.standard_normal((m, 3))
    return np.remainder(pos, 1.0).astype(np.float32)


K1_FRAMES = {
    "uniform-k8": (lambda: _uniform(0, 3000), 8, None),
    "uniform-k16": (lambda: _uniform(0, 3000), 16, None),
    "uniform-k48": (lambda: _uniform(3, 3000), 48, None),
    "spill-k8": (lambda: _spill(1234), 8, (8, 16)),
    "lattice-k8": (lambda: _lattice(11, 4096), 8, _lattice_grid(4096)),
    "lattice-k16": (lambda: _lattice(11, 4096), 16, _lattice_grid(4096)),
    "lattice-k48": (lambda: _lattice(11, 4096), 48, None),
    "lattice_spill-k8": (lambda: _lattice(12, 4096, cram=40), 8, _lattice_grid(4096)),
    "clustered95-k16": (lambda: clustered_positions(3000, "clustered95"), 16, None),
    "clustered30-k16": (lambda: clustered_positions(3000, "clustered30"), 16, None),
}


@pytest.mark.parametrize("mode", ["ids", "codes", "dual"])
@pytest.mark.parametrize("frame", sorted(K1_FRAMES))
def test_k1_schedule_matches_plain_versions(frame, mode):
    make, k, grid_spec = K1_FRAMES[frame]
    pos = torch.from_numpy(make())
    n = pos.shape[0]
    grid = CellGrid(*grid_spec) if grid_spec else choose_cell_grid(n, k)
    cap, _, spill_cap = pallas_knn.spill_layout(n, k, grid)
    box = f32(1.0, "cpu")
    t = pallas_knn.build_table(pos, grid.grid_size, cap, box)
    spill = pallas_knn.build_spill(pos, t.particle_rank, cap, spill_cap)
    table = (t.x, t.y, t.z, t.ids)
    args = dict(k=k, n=n, g=grid.grid_size, mi_start=pallas_knn.min_image_start(cap, spill_cap))
    plain = {"ids": pallas_knn.knn_select_reference, "codes": pallas_knn.knn_codes_reference,
             "dual": pallas_knn.knn_dual_reference}[mode]
    want = plain(table, spill, box=box, **args)
    got = k1_schedule(table, spill, box=1.0, mode=mode,
                      t=_constant("knn_select.cu", "kQueueDepth"), **args)
    for a, b in zip(got, want):
        _equal(a, b)
    if frame.startswith(("spill", "lattice_spill")):
        assert int((t.particle_rank >= cap).sum()) > 0  # the frame spills
    if frame.startswith("clustered"):
        # The spill block overflows, and some rows run out of candidates.
        assert int((t.particle_rank >= cap).sum()) > spill_cap
        assert bool((want[-1] >= BIG).any())


def test_k1_schedule_is_the_same_at_every_queue_depth_and_staging_order():
    """The result does not depend on T or on the order the atomics stage
    the candidates in (the keys are distinct)."""
    pos = torch.from_numpy(_lattice(12, 4096, cram=40))
    n, k = pos.shape[0], 16
    grid = CellGrid(*_lattice_grid(n))
    cap, _, spill_cap = pallas_knn.spill_layout(n, k, grid)
    t = pallas_knn.build_table(pos, grid.grid_size, cap, f32(1.0, "cpu"))
    spill = pallas_knn.build_spill(pos, t.particle_rank, cap, spill_cap)
    args = dict(k=k, n=n, g=grid.grid_size, box=1.0, mode="dual",
                mi_start=pallas_knn.min_image_start(cap, spill_cap))
    table = (t.x, t.y, t.z, t.ids)
    base = k1_schedule(table, spill, t=2, seed=0, **args)
    for depth, seed in ((1, 1), (4, 2), (8, 3)):
        for a, b in zip(k1_schedule(table, spill, t=depth, seed=seed, **args), base):
            np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                          b.view(np.int32) if b.dtype == np.float32 else b)


def _dense_inputs(name):
    rng = np.random.default_rng(7)
    if name == "lattice":
        pos, n, spec_k = (rng.integers(0, 1024, (2 * NP, 3)) / 1024), 2 * NP, K
    elif name in CLUSTERED:
        pos, n, spec_k = clustered_positions(NP, name), NP, K
    else:
        pos, n, spec_k = rng.random((NP, 3)), NP, K
    pos = torch.from_numpy(pos.astype(np.float32))
    spec = cellblock.choose_cellblock_spec(n, spec_k)
    dspec = cellblock.choose_dense_search_spec(n, spec)
    layout = cellblock.cellblock_layout(pos, 1.0, spec)
    ds = cellblock.dense_search_inputs(layout, pos[layout.order], 1.0, spec, dspec)
    return ds, dspec


@pytest.mark.parametrize("k", [8, 16, 48])
@pytest.mark.parametrize("name", ["uniform", "lattice", "clustered95"])
def test_k8_schedule_matches_plain_version(name, k):
    """The live rows equal the plain version's; with the live-row mask the
    padding rows are skipped and get the no-pick lane, as the wrapper's CPU
    path gives them."""
    ds, dspec = _dense_inputs(name)
    args = dict(k=k, query_block=dspec.query_block, w_eff=ds.w_eff)
    want = cellblock.dense_select_reference(ds.table, ds.queries, ds.windows, 1.0, **args)
    wrapped = cellblock.dense_select(ds.table, ds.queries, ds.windows, 1.0, ds.rows, **args)
    got = k8_schedule(ds.table, ds.queries, ds.windows, 1.0, k=k, qb=dspec.query_block,
                      w_eff=ds.w_eff, t=_constant("dense_select.cu", "kQueueDepth"),
                      rows=ds.rows)
    live = (torch.arange(dspec.query_block) < ds.rows[:, None]).reshape(-1)
    assert not live.all()
    for a, b, c in zip(got, want, wrapped):
        _equal(a[live.numpy()], b[live])
        _equal(a, c)
    assert (got[0][~live.numpy()] == 9 * ds.w_eff).all()


def test_packed_key_orders_as_lexicographic_d2_then_payload():
    rng = np.random.default_rng(0)
    tiny = np.float32(np.finfo(np.float32).tiny)
    values = np.array([0.0, 1e-45, 3e-42, tiny * np.float32(0.5), tiny, 1e-30, 0.25,
                       0.5, 1.0, 3.7, 1e20, 1e29, 1e30], np.float32)
    d2 = np.concatenate([values, rng.choice(values, 500),
                         rng.uniform(0, 2, 500).astype(np.float32)])
    payload = rng.integers(0, 2**31, d2.shape[0])
    payload[:13] = 0
    payload[13:30] = 2**32 - 1  # the largest payload (the empty key's)
    keys = pack(d2, payload)
    by_key = np.argsort(keys, kind="stable")
    lexi = np.lexsort((payload, d2))
    np.testing.assert_array_equal(keys[by_key], keys[lexi])
    assert (np.diff(d2[by_key]) >= 0).all()
    np.testing.assert_array_equal(key_d2(keys).view(np.int32), d2.view(np.int32))
    np.testing.assert_array_equal(key_payload(keys), payload)
    # The empty key is the 1e30 sentinel distance with the largest payload,
    # above every key of a real distance.
    assert key_d2(np.array([EMPTY]))[0] == BIG
    assert (pack(values[:-1], np.full(12, 2**32 - 1)) < EMPTY).all()


@pytest.mark.parametrize("box", [1.0, 3.7, 25.0])
def test_host_box_has_the_bits_of_the_f32_box(box):
    """The kernels take the box rounded once on the host; it must have the
    bits of the device scalar the plain versions use."""
    want = f32(box, "cpu").numpy().tobytes()
    assert np.float32(host_f32(box)).tobytes() == want
    assert bytes(ctypes.c_float(host_f32(box))) == want
    assert bytes(ctypes.c_float(host_f32(torch.tensor(box)))) == want
    assert bytes(ctypes.c_float(host_f32(np.float64(box)))) == want
