"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Drives the port's rollout paths, its one-step prediction, its two
train-step paths and its training loop of the default model (latent 128, 10
message-passing steps) at N = 65,536 particles, k = 16, bf16 operands: the
gather rollout, the hybrid cell-block rollout that is the JAX package's main
path, and the hybrid rollout's two other re-neighboring routes (the fused
dense-query search, and the plan from neighbor ids on a spec of another
grid), each re-neighboring every step with the exactness certificate; then
the gather and the hybrid train step (batch 1, noise 3e-4, Adam, the fused
tail); then ``Trainer.fit`` on the hybrid path (epochs, validation,
checkpoints, a resume) and activation checkpointing; then the rollout's
brute-force fallback (K9 gated on the device), its cell-sorted state, and
the evaluation entry points (``validate_one_step``, ``render_rollout``'s
body).
Before that it builds every CUDA kernel from ``csrc/`` and holds each
against its plain PyTorch version at the shapes the paths give it. Phases,
each timed on its own line:

  1. device and build: the card's name and power limit, one nvcc per source
     (all started together), each build's -Xptxas -v report;
  2. K1 (cell-list k-NN), its codes mode K1' and its dual mode K1'' (ids and
     codes) against their plain versions on a uniform frame, on a frame
     with cells past capacity (spill) and on the uniform frame snapped to
     the 2^-10 lattice (many exactly equal distances: the tie order): equal
     ids and codes (the dual mode's ids also equal to the ids mode's),
     bit-equal k-th distances; certificate and brute force as the
     yardstick of exactness on the first two; all three modes again at
     k = 48 on the uniform and lattice frames; the kernels take the box as
     a host number, and each mode is timed by events and from a CUDA graph
     ("graph_ms"), with each instantiation's -Xptxas -v registers and
     spills;
  3. K5 (fused step tail) and K6 (its recompute-backward) against their
     plain versions at [65536, 128], with bf16 and with float32 aggregates;
     K6 also against autograd through the plain forward; both timed, as
     every kernel is, by events around back-to-back wrapper calls, and also
     from a CUDA graph of those calls (the device time alone, reported as
     "graph_ms"), with each agg dtype's bound, and the three (K5) and nine
     (K6) bf16 products alone by torch.matmul;
  4. K2 (particle-order codes -> S offsets and the dropped count, the slot
     gather and normalization inside), K3 (int8 S rows, with and without
     its edge count), K7 (the reverse table and its edge total, from the
     sender packs), K4 (window matmul) and K4^T (its S^T mode) against their
     plain versions at the flagship cell-block spec (K2, K3, K7 on the
     uniform, spill and lattice frames, with the transpose certificate
     reverse_mismatch == 0 from the two counts, and K2, K3, K7 timed by
     events and from a CUDA graph); K7 also on the aux spec (timed the same
     way); K4 and K4^T also on the
     aux spec's plan (grid 14, with its reverse table), each mode's rate
     (its bound's bytes over its time), its registers and spills, and S's
     share of live (32-row, 64-deep) blocks; K8 (the dense-query
     search) against its plain version on the dense plan's inputs of the
     uniform frame, of a frame whose search windows truncate and of the
     lattice frame, at k = 16 and (but the truncating frame) 48, on the
     live rows of the plan's mask (padding rows the no-pick lane), and the
     dense train plan (with its reverse table, K7) on the card against the
     CPU plain path on the first two;
     K8 timed by events and from a CUDA graph;
 4b. the uncertified regime: two clustered frames (95 % of the particles
     in a sigma 0.01 ball, 30 % in a sigma 0.05 ball), where the spill block
     overflows and rows run short of candidates: K1's three modes, K8, K2,
     K3 and K7 against their plain versions, the card's k-NN and plan
     (S, S_rev, overflow, dropped edges, reverse_mismatch) against the CPU
     plain path, whose certificate must be false;
  5. the gather slice: launch counts zeroed, 8 rollout steps, counts read (K1
     once and K5 ten times per step), trajectory finite, certificate true
     every step, ms per step from CUDA events after a warm-up; a 2-step
     full-width rollout at N = 8,192 against the plain path on the CPU;
  6. the hybrid slice: the same for aggregation="cellblock_hybrid" (K1',
     K2, K3 once and K4, K5 ten times per step; the certificate includes no
     column overflow and no dropped edge), its peak device memory, and the
     N = 8,192 check against the CPU plain path and the card's gather path;
  7. the hybrid dense slice: the same for cellblock_search="dense" (K8, K3
     once and K4, K5 ten times per step; the certificate also requires no
     search-window truncation and every k-th neighbor within its margin);
  8. the hybrid aux slice: the same on choose_cellblock_spec(N) (grid 14,
     the k-NN grid 19): K1'' and K3 once, K4 and K5 ten times per step;
  9. one-step prediction on the gather, hybrid (codes) and hybrid aux
     routes against the first frame of a 1-step rollout of the same window;
 10. the gather train slice: launch counts zeroed, 1 warm-up and 4 timed
     train steps, counts read (K1 once, K5 and K6 ten times per step), loss
     finite every step, ms per step from CUDA events, peak device memory;
 11. the hybrid train slice: the same (K1', K2, K3, K7 once, K4, K4^T, K5,
     K6 ten times per step; cellblock_violations 0 every step); then at
     N = 8,192 one train step of each path on the card against the CPU
     plain path (loss and every gradient), and hybrid against gather;
 12a. the Trainer slice: Trainer.fit on aggregation="cellblock_hybrid"
     (bf16, noise 3e-4, augmentation, batch 1, Adam from lr 1e-4 to 1e-5),
     3 epochs over an in-memory dataset of the port's synthetic generator
     (a training simulation of 9 snapshots: 4 windows; a validation one of
     7: 2 windows), save_every 1: launch counts zeroed before fit and read
     after (per train step K1', K2, K3, K7 once and K4, K4^T, K5, K6 ten
     times; per eval step K1', K2, K3 once and K4, K5 ten times; the
     exactness check on the first window runs the plain cell list, no
     kernel), every epoch's losses finite, cellblock_violations 0 every
     step, model_best, model_epoch_{0,1,2}, model_final and
     training_history.json with the JAX Trainer's keys; each epoch's time,
     ms per train step inside fit (CUDA events around each step) against
     phase 11's bare step, ms per step of each epoch's loop, peak memory;
 12b. resume equals continuous: a second Trainer restores model_epoch_0
     (epoch, schedule position and learning rate, generator state checked)
     and fits epochs 1-2; its model_epoch_2 params and Adam state must be
     bit-equal to the first run's, and its history equal;
 12c. remat: one train step (noise 0, no augmentation, SGD with lr 1) at
     N = 65,536 with remat, with remat_chunk=5 and with neither, on the
     hybrid bf16 path with the fused tail and on gather in f32 without it:
     loss and every gradient bit-equal to the run without remat, launches
     as the recomputation implies (K4 and K5 M, 2M and 2M + (M/c)(c-1)
     times; the rest once a step), peak memory of each;
 13a. K9 (the brute-force k-NN gated on the device) against its plain
     version at N = 65,536, k = 16 and 48, on the uniform, clustered30 and
     lattice frames and 10,000 separate queries: ids equal, d2 bit-equal; a
     set gate leaves the output buffers bit for bit, a clear one gives the
     plain version's; timed active, gated (events and CUDA graph) and plain;
 13b. exactness_guard="fallback" on gather, 4 steps at N = 65,536 (bf16,
     fused tail): on a clustered window (certificate false every step) K1,
     K9 once and K5 ten times a step, the trajectory equal to the
     brute-force rollout's (K9 once, K1 never) and unlike the flag guard's;
     on the uniform window K9 gated every step and the trajectory bit-equal
     to the flag guard's; synchronizing calls per step under CUDA's sync
     debug mode, flag against fallback (the fallback adds none); a 2-step
     N = 8,192 clustered fallback rollout against the CPU plain path;
 13c. sorted_state="on": 8 gather steps at N = 65,536 bit-equal to "off",
     at reneighbor_every 1 and 2, ms per step of each;
 13d. evaluation at N = 65,536 on an in-memory synthetic simulation:
     validate_one_step on gather and hybrid (bf16, 4 windows, exact
     launches, each error bit-equal to the MSE of a direct
     one_step_prediction), then render_rollout's body (the CLI after its
     HDF5 read) for 6 steps with --exactness_guard fallback: K1 and K9
     each step, both .npy trajectories, the summary with the JAX CLI's
     lines, finite errors, the plot or the "plotting skipped" line;
 12. one JSON line of every ported kernel: launches on its path, time, bound,
     plain version's time, library yardstick's time.

The last line is the contract line ``{"ok": true, "device": {...}}``. Any
failed check raises before it, so the exit code is then not 0. Without a
CUDA device the script exits non-zero at once and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense), for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

N, K, WINDOW, STEPS = 65536, 16, 5, 8
# One-step prediction against a 1-step rollout: the same operations.
ONE_STEP_TOL = 1e-6
K5_MAX_ABS_TOL, K5_MEAN_ABS_TOL = 5e-2, 2e-3
# K4: exact products (int8 counts x bf16), float32 sums in another order.
K4_MAX_ABS_TOL, K4_MEAN_ABS_TOL = 1e-3, 1e-5
SMALL_N, SMALL_STEPS, SMALL_COORD_TOL = 8192, 2, 2e-4
K1_WIDE_K = 48
# K6: the plain version rounds operands to bf16 where the kernel does; sums
# run in another order, and a last-bit difference can flip a ReLU mask at a
# pre-activation within rounding of 0, which moves that entry of dagg by
# O(1). Per output: at most 1e-5 of its entries off by more than REL of its
# largest magnitude, mean error within MEAN of its mean magnitude. Against
# autograd through the plain forward (bf16 roundings of the gradients at
# other places) the looser pair.
K6_REL, K6_MEAN = 1e-2, 1e-3
K6_AUTOGRAD_REL, K6_AUTOGRAD_MEAN = 3e-2, 1e-2
TRAIN_STEPS, TRAIN_NOISE = 4, 3e-4
# The N = 8,192 train-step check: each gradient leaf within TOL of its
# largest magnitude (bf16 operands through 10 message-passing steps; on the
# CPU the hybrid and gather gradients differ by at most 2.0e-2, the gather
# path rounding each aggregate to bf16), the loss within 1e-3 relative.
TRAIN_GRAD_TOL, TRAIN_LOSS_RTOL = 5e-2, 1e-3
# The Trainer slice: a training simulation of 9 snapshots (4 windows) and a
# validation one of 7 (2 windows), 3 epochs, the learning rate 1e-4 -> 1e-5.
FIT_TRAIN_SNAPSHOTS, FIT_VAL_SNAPSHOTS, FIT_EPOCHS = 9, 7, 3
# The keys of the JAX Trainer's training_history.json.
HISTORY_KEYS = ["best_epoch", "best_val_loss", "component_losses", "learning_rates",
                "train_loss", "val_loss"]
COMPONENT_KEYS = ["acc_train", "acc_val", "momentum_train", "momentum_val",
                  "temp_rate_train", "temp_rate_val"]
# Remat: the recomputed forward runs the same kernels on the same inputs, so
# the loss and every gradient leaf must be bit-equal to the run without it.
REMAT_GRAD_TOL = 0.0
# K9's separate-query frame; the fallback's steps at N; the fallback's
# trajectory against the brute-force rollout's: both run K9's ids through
# the same operations, so 0 is expected, and the JAX test's 1e-6 allowed.
BRUTE_QUERIES, FALLBACK_STEPS, FALLBACK_TOL = 10000, 4, 1e-6
# Evaluation: an in-memory synthetic simulation of 12 snapshots (6 start
# indices), 4 one-step windows, a 6-step render.
EVAL_SNAPSHOTS, EVAL_WINDOWS, RENDER_STEPS = 12, 4, 6

METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": 1.0, "dt": 0.05,
}
PORT_PACKAGE = "cosmology_gnn_simulation_tpu_torch"
SOURCE_DIR = f"{PORT_PACKAGE}/csrc"
# The JAX package (the port's name less "_torch") is named here only as the
# path of the TPU kernels the CUDA kernels replace; nothing of it is imported.
TPU_OPS = f"{PORT_PACKAGE.removesuffix('_torch')}/ops"


def fail(msg: str):
    raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps: int) -> float:
    """Mean device ms per call over ``reps`` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn``'s launches, replayed from a CUDA
    graph of ``reps`` calls (after a warm-up on a side stream): the kernel's
    time without the host's cost of each Python call, which exceeds the
    kernel's where the kernel is short."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def print_ptxas(logs, name):
    """Each kernel instantiation's registers and spills from ``name``'s
    -Xptxas -v log, by its template arguments (the mangled name's
    ``ILi1ELi0EE`` is <1, 0>). ptxas reports a kernel's stack and spills,
    then its registers, after the line that names it."""
    log = logs.get(name)
    if log is None:
        print(f"{name} -Xptxas -v: library already built, no log")
        return
    rows = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
            args = re.search(r"I((?:L[a-z]+\d+E)+)EE", func)
            label = (f"<{', '.join(re.findall(r'L[a-z]+(\d+)E', args.group(1)))}>"
                     if args else func)
            rows.append([label, "", ""])
        elif rows and "registers" in line:
            rows[-1][1] = line.split(": ", 1)[-1].strip()
        elif rows and "spill" in line:
            rows[-1][2] = line.strip()
    print(f"{name} -Xptxas -v per kernel:")
    for label, regs, spills in rows:
        print(f"  {label}: {regs} | {spills}")


def kernel_entry(source, replaces, max_abs_err, ms, plain_ms, nbytes, ops, op_rate,
                 library_ms):
    """One kernel's report: its bound is the larger of its bytes over the
    memory rate and its operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / op_rate
    return dict(route="cuda", source=f"{SOURCE_DIR}/{source}", replaces=f"{TPU_OPS}/{replaces}",
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# The uncertified regime's clustered frames: (label, share of the particles
# in a normal ball about the box centre, the ball's sigma). They and
# clustered_frame must stay the frames of tests/test_torch_knn_select_schedule.py
# (CLUSTERED, clustered_positions: seed 21, this script's --seed 0 + 21), which
# the CPU tests hold against the JAX package.
CLUSTERED = (("clustered95", 0.95, 0.01), ("clustered30", 0.30, 0.05))


def clustered_frame(n: int, share: float, sigma: float, seed: int):
    """A share of the particles in a normal ball of width sigma about the
    box centre, the rest uniform (the frames of the port's tests)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3))
    m = int(share * n)
    pos[:m] = 0.5 + sigma * rng.standard_normal((m, 3))
    return np.remainder(pos, 1.0).astype(np.float32)


def clustered_window(n: int, seed: int):
    """seed_window's drift and temperatures about the clustered30 frame (30 %
    of the particles in a sigma 0.05 ball), where the certificate fails."""
    rng = np.random.default_rng(seed)
    base = clustered_frame(n, 0.30, 0.05, seed)[None]
    drift = rng.normal(0, 5e-4, (WINDOW, n, 3)).cumsum(axis=0)
    pos = np.remainder(base + drift, 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (WINDOW, n, 1))).astype(np.float32)
    return pos, temp


def seed_window(n: int, seed: int):
    """bench.py's seed frames: uniform base + a small random-walk drift."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (1, n, 3))
    drift = rng.normal(0, 5e-4, (WINDOW, n, 3)).cumsum(axis=0)
    pos = np.remainder(base + drift, 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (WINDOW, n, 1))).astype(np.float32)
    return pos, temp


def train_batch(n: int, seed: int):
    """A batch of one: seed_window's positions over WINDOW + 1 frames (the
    last is the target) and slowly drifting temperatures."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (1, n, 3))
    drift = rng.normal(0, 5e-4, (WINDOW + 1, n, 3)).cumsum(axis=0)
    pos = np.remainder(base + drift, 1.0).astype(np.float32)
    temp = (1.0 + rng.normal(0, 1e-3, (WINDOW + 1, n, 1)).cumsum(axis=0)).astype(np.float32)
    return {"positions": pos[None, :WINDOW], "temperatures": temp[None, :WINDOW],
            "target_positions": pos[None, WINDOW], "target_temperatures": temp[None, WINDOW]}


class MemoryDataset:
    """``SequenceDataset.batches``' contract over simulations held in memory
    (the windows and the shuffle of the port's ``data/dataset.py``)."""

    def __init__(self, sims):
        self.sims = [(sim["Coordinates"], sim["InternalEnergy"]) for sim in sims]
        self.per_sim = self.sims[0][0].shape[0] - WINDOW

    def __len__(self):
        return len(self.sims) * self.per_sim

    def batches(self, batch_size, *, shuffle=True, seed=0, drop_remainder=True,
                include_extras=False):
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            chunk = order[i:i + batch_size]
            if drop_remainder and len(chunk) < batch_size:
                break
            windows = []
            for j in chunk:
                (pos, temp), start = self.sims[j // self.per_sim], j % self.per_sim
                end = start + WINDOW
                windows.append({"positions": pos[start:end], "temperatures": temp[start:end],
                                "target_positions": pos[end], "target_temperatures": temp[end]})
            yield {key: np.stack([w[key] for w in windows]) for key in windows[0]}


def mostly_close(a, b, rel, mean_rel):
    """(ok, max abs error): at most 1e-5 of the entries off by more than
    ``rel`` of b's largest magnitude, mean error within ``mean_rel`` of b's
    mean magnitude."""
    a, b = a.detach().float(), b.detach().float()
    err = (a - b).abs()
    off = int((err > rel * float(b.abs().max())).sum())
    ok = off <= 1e-5 * b.numel() and float(err.mean()) <= mean_rel * float(b.abs().mean())
    return ok, float(err.max())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cosmology_gnn_simulation_tpu_torch import kernels
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        default_model_config,
        init_encode_process_decode,
        step_params,
    )
    from cosmology_gnn_simulation_tpu_torch.ops import cellblock, pallas_knn
    from cosmology_gnn_simulation_tpu_torch.ops.cell_list import choose_cell_grid, f32
    from cosmology_gnn_simulation_tpu_torch.ops.fused_step import (
        fused_step_tail,
        fused_step_tail_bwd,
        fused_step_tail_bwd_reference,
        fused_step_tail_reference,
    )
    from cosmology_gnn_simulation_tpu_torch.ops.neighbors import (
        knn_periodic,
        knn_periodic_reference,
    )
    from cosmology_gnn_simulation_tpu_torch.rollout import one_step_prediction, rollout
    from cosmology_gnn_simulation_tpu_torch.cli import render_rollout
    from cosmology_gnn_simulation_tpu_torch.evaluation import validate_one_step
    from cosmology_gnn_simulation_tpu_torch.data.synthetic import generate_synthetic_simulation
    from cosmology_gnn_simulation_tpu_torch.training import (
        TrainConfig,
        Trainer,
        make_optimizer,
        make_train_step,
    )
    from cosmology_gnn_simulation_tpu_torch.training.trainer import Optimizer
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves
    from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib

    dev = torch.device("cuda")
    t_all = time.perf_counter()
    report = {}

    # ---- 1. device and build -------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    logs = kernels.build()
    for name, log in logs.items():
        print(f"--- nvcc -Xptxas -v: {name}\n{log.strip()}")
    print(f"phase 1 device+build: {time.perf_counter() - t0:.1f} s")

    # ---- 2. K1 and K1' against their plain versions ---------------------
    t0 = time.perf_counter()
    pos0 = torch.as_tensor(seed_window(N, args.seed)[0][-1], device=dev)
    grid = choose_cell_grid(N, K)
    cap, _, spill_cap = pallas_knn.spill_layout(N, K, grid)
    g = grid.grid_size
    box = f32(1.0, dev)

    def k1_inputs(pos):
        t = pallas_knn.build_table(pos, g, cap, box)
        spill = pallas_knn.build_spill(pos, t.particle_rank, cap, spill_cap)
        return (t.x, t.y, t.z, t.ids), spill, int((t.particle_rank >= cap).sum())

    # The kernels take the box as a host number; the plain versions its f32 tensor.
    k1_args = dict(k=K, n=N, g=g, box=1.0, mi_start=pallas_knn.min_image_start(cap, spill_cap))
    ref_args = {**k1_args, "box": box}
    crammed = pos0.clone()
    # Spill frame: 40 and 30 particles pulled into two cells of capacity cap.
    crammed[:40] = torch.tensor([0.52, 0.31, 0.77], device=dev) + 0.01 * crammed[:40]
    crammed[40:70] = torch.tensor([0.995, 0.002, 0.5], device=dev) + 0.004 * crammed[40:70]
    crammed = torch.remainder(crammed, 1.0)
    # Lattice frame: the uniform frame snapped to the 2^-10 lattice, where
    # many squared distances are exactly equal (the tie order is tested).
    lattice = torch.remainder(torch.round(pos0 * 1024) / 1024, 1.0)
    frames = (("uniform", pos0), ("spill", crammed), ("lattice", lattice))
    for label, pos in frames:
        table, spill, n_spilled = k1_inputs(pos)
        ids, kth = pallas_knn.knn_select(table, spill, **k1_args)
        ref_ids, ref_kth = pallas_knn.knn_select_reference(table, spill, **ref_args)
        if not torch.equal(ids, ref_ids):
            fail(f"K1 {label}: ids differ from the plain version in "
                 f"{int((ids != ref_ids).any(1).sum())} rows")
        if not torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32)):
            fail(f"K1 {label}: kth not bit-equal to the plain version")
        dual_ids, dual_codes, dkth = pallas_knn.knn_dual(table, spill, **k1_args)
        ref_dids, ref_dcodes, ref_dkth = pallas_knn.knn_dual_reference(table, spill, **ref_args)
        if not (torch.equal(dual_ids, ids) and torch.equal(dual_ids, ref_dids)):
            fail(f"K1'' {label}: ids differ from K1's in "
                 f"{int((dual_ids != ids).any(1).sum())} rows")
        if not torch.equal(dual_codes, ref_dcodes):
            fail(f"K1'' {label}: codes differ from the plain version in "
                 f"{int((dual_codes != ref_dcodes).any(1).sum())} rows")
        if not (torch.equal(dkth.view(torch.int32), ref_dkth.view(torch.int32))
                and torch.equal(dkth.view(torch.int32), kth.view(torch.int32))):
            fail(f"K1'' {label}: kth not bit-equal to the plain version and K1")
        codes, ckth = pallas_knn.knn_codes(table, spill, **k1_args)
        ref_codes, ref_ckth = pallas_knn.knn_codes_reference(table, spill, **ref_args)
        if not torch.equal(codes, ref_codes):
            fail(f"K1' {label}: codes differ from the plain version in "
                 f"{int((codes != ref_codes).any(1).sum())} rows")
        if not torch.equal(ckth.view(torch.int32), ref_ckth.view(torch.int32)):
            fail(f"K1' {label}: kth not bit-equal to the plain version")
        if label == "lattice":
            occupied = kth < 1e29
            print(f"K1 lattice: ids equal, kth bit-equal ({n_spilled} spilled; "
                  f"{int(torch.unique(kth[occupied]).numel())} distinct k-th distances over "
                  f"{int(occupied.sum())} rows); K1' codes equal, kth bit-equal; K1'' ids "
                  f"equal to K1's, codes equal, kth bit-equal")
            continue
        nbr, (ovf, max_d2, excess) = pallas_knn.pallas_cell_list_knn(
            pos, K, 1.0, grid, return_diagnostics=True)
        exact = bool((ovf == 0) & (excess <= 0))
        brute = knn_periodic_reference(pos, K, 1.0, query_tile=1024)
        same = (torch.sort(nbr, 1).values == torch.sort(brute, 1).values).all(1)
        if not exact or not bool(same.all()):
            fail(f"K1 {label}: certificate {exact}, {int((~same).sum())} rows differ "
                 "from brute force")
        if label == "spill" and n_spilled == 0:
            fail("the spill frame spilled no particle")
        print(f"K1 {label}: ids equal, kth bit-equal, certificate true "
              f"(max_d2 {float(max_d2):.6g}, max_excess {float(excess):.6g}, "
              f"{n_spilled} spilled), sets equal to brute force; K1' codes equal, "
              f"kth bit-equal; K1'' ids equal to K1's, codes equal, kth bit-equal")
        if label == "uniform":
            k1_table, k1_spill = table, spill
            k1_err = float((kth - ref_kth).abs().max())
            k1c_err = float((ckth - ref_ckth).abs().max())
            k1d_err = float((dkth - ref_dkth).abs().max())
    kernels.reset_launches()
    k1_ms = time_ms(lambda: pallas_knn.knn_select(k1_table, k1_spill, **k1_args), 50)
    k1_graph_ms = graph_ms(lambda: pallas_knn.knn_select(k1_table, k1_spill, **k1_args), 20)
    k1_plain_ms = time_ms(lambda: pallas_knn.knn_select_reference(k1_table, k1_spill, **ref_args),
                          3)
    k1c_ms = time_ms(lambda: pallas_knn.knn_codes(k1_table, k1_spill, **k1_args), 50)
    k1c_graph_ms = graph_ms(lambda: pallas_knn.knn_codes(k1_table, k1_spill, **k1_args), 20)
    k1c_plain_ms = time_ms(lambda: pallas_knn.knn_codes_reference(k1_table, k1_spill, **ref_args),
                           3)
    k1d_ms = time_ms(lambda: pallas_knn.knn_dual(k1_table, k1_spill, **k1_args), 50)
    k1d_graph_ms = graph_ms(lambda: pallas_knn.knn_dual(k1_table, k1_spill, **k1_args), 20)
    k1d_plain_ms = time_ms(lambda: pallas_knn.knn_dual_reference(k1_table, k1_spill, **ref_args),
                           3)
    occ = (k1_table[3] < N).sum(1)  # per cell
    coords = torch.arange(g**3, device=dev)
    ci, cj, cl = coords // (g * g), (coords // g) % g, coords % g
    ring_occ = torch.zeros_like(occ)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                ring_occ += occ[(((ci + dx) % g) * g + (cj + dy) % g) * g + (cl + dz) % g]
    pairs = int((occ * (ring_occ + int((k1_spill[3] < N).sum()))).sum())
    # In: the four table planes and the spill planes; out: ids or codes
    # [G^3 * cap, k] int32 and kth. Per (query, candidate) pair: 3 sub,
    # 3 mul, 2 add, 1 compare with the k-th.
    k1_bytes = nbytes(*k1_table, *k1_spill) + g**3 * cap * (K + 1) * 4
    k1_ops = 9 * pairs
    report["knn_select"] = kernel_entry(
        "knn_select.cu", "pallas_knn.py:117", k1_err, k1_ms, k1_plain_ms, k1_bytes, k1_ops,
        F32_FLOP_PER_S, None)
    report["knn_codes"] = kernel_entry(
        "knn_select.cu", "pallas_knn.py:167", k1c_err, k1c_ms, k1c_plain_ms, k1_bytes, k1_ops,
        F32_FLOP_PER_S, None)
    # K1'' writes a second [G^3 * cap, k] int32 output (the codes).
    k1d_bytes = k1_bytes + g**3 * cap * K * 4
    report["knn_dual"] = kernel_entry(
        "knn_select.cu", "pallas_knn.py:257", k1d_err, k1d_ms, k1d_plain_ms, k1d_bytes, k1_ops,
        F32_FLOP_PER_S, None)
    for name, gms in (("knn_select", k1_graph_ms), ("knn_codes", k1c_graph_ms),
                      ("knn_dual", k1d_graph_ms)):
        report[name]["graph_ms"] = gms
    print(f"K1 time {k1_ms:.4f} ms (graph {k1_graph_ms:.4f}), plain {k1_plain_ms:.3f} ms; K1' "
          f"time {k1c_ms:.4f} ms (graph {k1c_graph_ms:.4f}), plain {k1c_plain_ms:.3f} ms; K1'' "
          f"time {k1d_ms:.4f} ms (graph {k1d_graph_ms:.4f}), plain {k1d_plain_ms:.3f} ms; "
          f"{pairs} occupied pairs, {k1_ops} operations, {k1_bytes} bytes ({k1d_bytes} K1'')")
    # k above the old register cap of 32: the KT = 64 list, both modes.
    grid48 = choose_cell_grid(N, K1_WIDE_K)
    cap48, _, spill48 = pallas_knn.spill_layout(N, K1_WIDE_K, grid48)
    args48 = dict(k=K1_WIDE_K, n=N, g=grid48.grid_size, box=1.0,
                  mi_start=pallas_knn.min_image_start(cap48, spill48))
    for frame, pos in (("uniform", pos0), ("lattice", lattice)):
        t48 = pallas_knn.build_table(pos, grid48.grid_size, cap48, box)
        sp48 = pallas_knn.build_spill(pos, t48.particle_rank, cap48, spill48)
        planes48 = (t48.x, t48.y, t48.z, t48.ids)
        for label, select, plain in (
                ("K1", pallas_knn.knn_select, pallas_knn.knn_select_reference),
                ("K1'", pallas_knn.knn_codes, pallas_knn.knn_codes_reference),
                ("K1''", pallas_knn.knn_dual, pallas_knn.knn_dual_reference)):
            *picks, kth = select(planes48, sp48, **args48)
            *ref_picks, ref_kth = plain(planes48, sp48, **{**args48, "box": box})
            if not (all(torch.equal(a, b) for a, b in zip(picks, ref_picks))
                    and torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32))):
                fail(f"{label} k={K1_WIDE_K} {frame}: differs from the plain version in "
                     f"{int((picks[0] != ref_picks[0]).any(1).sum())} rows")
        if frame == "uniform":
            k1_48 = [time_ms(lambda f=f: f(planes48, sp48, **args48), 20)
                     for f in (pallas_knn.knn_select, pallas_knn.knn_codes, pallas_knn.knn_dual)]
    print(f"K1, K1' and K1'' k={K1_WIDE_K} (grid {grid48.grid_size}, cap {cap48}), uniform and "
          f"lattice frames: picks equal, kth bit-equal to the plain versions; uniform time "
          f"{k1_48[0]:.4f}, {k1_48[1]:.4f}, {k1_48[2]:.4f} ms")
    print_ptxas(logs, "knn_select")
    print(f"phase 2 K1, K1', K1'': {time.perf_counter() - t0:.1f} s")

    # ---- 3. K5 against its plain version -------------------------------
    t0 = time.perf_counter()
    cfg = default_model_config()
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    node = step_params(params, 0)["node"]
    gen = torch.Generator().manual_seed(args.seed + 1)
    x = torch.randn(N, 128, generator=gen).to(dev)
    agg = torch.randn(N, 128, generator=gen).mul(3.0).bfloat16().to(dev)
    agg32 = agg.float() + 1e-3 * torch.randn(N, 128, generator=gen).to(dev)
    for label, a in (("bf16 agg", agg), ("f32 agg", agg32)):
        err = (fused_step_tail(x, a, node) - fused_step_tail_reference(x, a, node)).abs()
        e_max, e_mean = float(err.max()), float(err.mean())
        if not (e_max <= K5_MAX_ABS_TOL and e_mean <= K5_MEAN_ABS_TOL):
            fail(f"K5 {label}: max abs err {e_max} (tol {K5_MAX_ABS_TOL}), mean {e_mean} "
                 f"(tol {K5_MEAN_ABS_TOL})")
        print(f"K5 [{N}, 128] {label}: max abs err {e_max:.3g} (tol {K5_MAX_ABS_TOL}), "
              f"mean {e_mean:.3g} (tol {K5_MEAN_ABS_TOL})")
        if label == "bf16 agg":
            k5_err = e_max
    # Timed as every kernel is (events around back-to-back calls), and from
    # a CUDA graph of the calls: where the host's cost of a call exceeds the
    # kernel's time, the first reads the host and the second the device.
    k5_ms = time_ms(lambda: fused_step_tail(x, agg, node), 200)
    k5_f32_ms = time_ms(lambda: fused_step_tail(x, agg32, node), 200)
    k5_graph_ms = graph_ms(lambda: fused_step_tail(x, agg, node), 50)
    k5_f32_graph_ms = graph_ms(lambda: fused_step_tail(x, agg32, node), 50)
    k5_plain_ms = time_ms(lambda: fused_step_tail_reference(x, agg, node), 50)
    k5_bytes = N * 128 * (4 + 2 + 4) + (3 * 128 * 128 + 5 * 128) * 4
    k5_f32_bytes = k5_bytes + N * 128 * 2
    k5_ops = 3 * 2 * N * 128 * 128
    report["fused_tail"] = kernel_entry(
        "fused_tail.cu", "fused_step.py:66", k5_err, k5_ms, k5_plain_ms, k5_bytes, k5_ops,
        BF16_TENSOR_FLOP_PER_S, None)
    report["fused_tail"]["graph_ms"] = k5_graph_ms
    k5_f32_bound = max(k5_f32_bytes / HBM_BYTES_PER_S, k5_ops / BF16_TENSOR_FLOP_PER_S) * 1e3
    print(f"K5 time {k5_ms:.4f} ms (graph {k5_graph_ms:.4f}; bound "
          f"{report['fused_tail']['bound_ms']:.4f}), f32 agg {k5_f32_ms:.4f} ms (graph "
          f"{k5_f32_graph_ms:.4f}; bound {k5_f32_bound:.4f}); plain {k5_plain_ms:.4f} ms; "
          f"{k5_ops} operations, {k5_bytes} bytes ({k5_f32_bytes} with f32 agg)")
    g_out = torch.randn(N, 128, generator=gen).to(dev)
    layers = node["layers"]
    for label, a in (("bf16 agg", agg), ("f32 agg", agg32)):
        dx, dagg, grads = fused_step_tail_bwd(x, a, g_out, node)
        rdx, rdagg, rgrads = fused_step_tail_bwd_reference(x, a, g_out, node)
        # Autograd through the plain forward, on copies of the inputs.
        leaves = [t.detach().clone().requires_grad_(True) for t in (
            x, a.float(), layers[0]["w"][:128], layers[0]["b"], layers[1]["w"],
            layers[1]["b"], layers[2]["w"], layers[2]["b"], node["ln"]["scale"],
            node["ln"]["bias"])]
        tnode = {"layers": tuple({"w": leaves[2 + 2 * i], "b": leaves[3 + 2 * i]}
                                 for i in range(3)),
                 "ln": {"scale": leaves[8], "bias": leaves[9]}}
        out = fused_step_tail_reference(leaves[0], leaves[1], tnode)
        auto = torch.autograd.grad(out, leaves, g_out)
        names = ["dx", "dagg", "dw_self", "db0", "dw1", "db1", "dwf", "dbf", "dscale",
                 "dbias"]
        errs = []
        for name, k6, ref, ag in zip(names, [dx, dagg, *grads], [rdx, rdagg, *rgrads], auto):
            ok, err = mostly_close(k6, ref, K6_REL, K6_MEAN)
            ok_auto, err_auto = mostly_close(k6, ag, K6_AUTOGRAD_REL, K6_AUTOGRAD_MEAN)
            if not (ok and ok_auto):
                fail(f"K6 {label} {name}: max abs err {err} against the plain version, "
                     f"{err_auto} against autograd")
            errs.append((err, err_auto))
        print(f"K6 [{N}, 128] {label}: dx, dagg and the 8 weight/bias/LN gradients within "
              f"tolerance; max abs err per output against the plain version "
              f"{[float(f'{e:.3g}') for e, _ in errs]}, against autograd "
              f"{[float(f'{e:.3g}') for _, e in errs]}")
        if label == "bf16 agg":
            k6_err = max(e for e, _ in errs)
    del leaves, tnode, out, auto
    k6_ms = time_ms(lambda: fused_step_tail_bwd(x, agg, g_out, node), 100)
    k6_f32_ms = time_ms(lambda: fused_step_tail_bwd(x, agg32, g_out, node), 100)
    k6_graph_ms = graph_ms(lambda: fused_step_tail_bwd(x, agg, g_out, node), 20)
    k6_f32_graph_ms = graph_ms(lambda: fused_step_tail_bwd(x, agg32, g_out, node), 20)
    k6_plain_ms = time_ms(lambda: fused_step_tail_bwd_reference(x, agg, g_out, node), 20)
    # In: x, agg (bf16), g and the weights; out: dx, dagg and the gradients.
    # Nine 128 x 128 products a row (three recomputed, six backward).
    k6_bytes = N * 128 * (4 + 2 + 4 + 4 + 2) + 2 * (3 * 128 * 128 + 5 * 128) * 4
    k6_f32_bytes = k6_bytes + 2 * N * 128 * 2
    k6_ops = 9 * 2 * N * 128 * 128
    report["fused_tail_bwd"] = kernel_entry(
        "fused_tail_bwd.cu", "fused_step.py:113", k6_err, k6_ms, k6_plain_ms, k6_bytes,
        k6_ops, BF16_TENSOR_FLOP_PER_S, None)
    report["fused_tail_bwd"]["graph_ms"] = k6_graph_ms
    k6_f32_bound = max(k6_f32_bytes / HBM_BYTES_PER_S, k6_ops / BF16_TENSOR_FLOP_PER_S) * 1e3
    print(f"K6 time {k6_ms:.4f} ms (graph {k6_graph_ms:.4f}; bound "
          f"{report['fused_tail_bwd']['bound_ms']:.4f}), f32 agg {k6_f32_ms:.4f} ms (graph "
          f"{k6_f32_graph_ms:.4f}; bound {k6_f32_bound:.4f}); plain {k6_plain_ms:.4f} ms; "
          f"{k6_ops} operations, {k6_bytes} bytes ({k6_f32_bytes} with f32 agg)")
    # A floor for the tails' tensor work, not a yardstick (no single PyTorch
    # call computes a tail): their [N, 128] x [128, 128] bf16 products alone.
    mm_a = torch.randn(N, 128, generator=gen).to(dev).bfloat16()
    mm_w = torch.randn(128, 128, generator=gen).to(dev).bfloat16()
    mm_ms = graph_ms(lambda: torch.matmul(mm_a, mm_w), 50)
    print(f"torch.matmul [{N}, 128] x [128, 128] bf16 (from a CUDA graph): {mm_ms:.4f} ms "
          f"each; the three of K5 {3 * mm_ms:.4f} ms, the nine of K6 {9 * mm_ms:.4f} ms")
    del mm_a, mm_w
    print(f"phase 3 K5, K6: {time.perf_counter() - t0:.1f} s")

    # ---- 4. K2, K3, K4 against their plain versions ----------------------
    t0 = time.perf_counter()
    spec = cellblock.choose_cellblock_spec(N, K)
    codes_cap = pallas_knn.codes_packing_cap(N, K, grid)
    width = spec.s_width

    def plan_kernels(label, pos, certified=True):
        """K2 (from K1''s particle-order codes), K3 with its count and
        without it (the rollouts' mode) and K7 with its total against their
        plain versions on one frame, and the plan build's tables and
        certificate counts against them."""
        layout = cellblock.cellblock_layout(pos, 1.0, spec)
        _, codes, spill = pallas_knn.pallas_cell_list_knn(pos, K, 1.0, grid, codes_only=True)
        offsets, dropped = cellblock.s_decode(codes, spill, layout, spec, codes_cap)
        ref_off = cellblock.s_decode_reference(
            *cellblock.s_decode_inputs(layout, codes, codes_cap, spill, spec), spec=spec,
            codes_cap=codes_cap)
        if not torch.equal(offsets, ref_off) or int(dropped) != int((ref_off == width + 1).sum()):
            fail(f"K2 {label}: offsets differ from the plain version in "
                 f"{int((offsets != ref_off).sum())} entries, dropped {int(dropped)}")
        s_table, s_total = cellblock.s_onehot(offsets, width=width, with_total=True)
        uncounted = cellblock.s_onehot(offsets, width=width)  # the rollouts' mode
        ref_s = cellblock.s_onehot_reference(offsets, width=width)
        if not (torch.equal(s_table, ref_s) and torch.equal(uncounted, ref_s)
                and int(s_total) == int(ref_s.sum(dtype=torch.int64))):
            fail(f"K3 {label}: S table (with or without its count) or its count "
                 f"({int(s_total)}) differs from the plain version")
        packs = cellblock.sender_packs(cellblock.slot_codes(layout, codes, codes_cap, spill, spec),
                                       layout, codes_cap, spec)
        s_rev, rev_total = cellblock.reverse_table(packs, layout, spec)
        ref_rev = cellblock.reverse_table_reference(
            cellblock.reverse_candidates(packs, layout, spec), layout.window_starts, spec=spec)
        if not (torch.equal(s_rev, ref_rev)
                and int(rev_total) == int(ref_rev.sum(dtype=torch.int64))):
            fail(f"K7 {label}: reverse table or its total ({int(rev_total)}) differs from the "
                 "plain version")
        plan = cellblock.build_cellblock(pos, None, 1.0, spec, with_reverse=True,
                                         neighbor_codes=codes, codes_cap=codes_cap,
                                         codes_spill=spill)
        mismatch = int(plan.reverse_mismatch)
        if not (torch.equal(plan.s_table, s_table) and torch.equal(plan.s_rev_table, s_rev)
                and mismatch == int(s_total) - int(rev_total)
                and int(plan.dropped_edges) == int(dropped)):
            fail(f"{label}: the plan's tables or counts differ from the kernels' outputs")
        if certified and mismatch != 0:
            fail(f"K7 {label}: reverse_mismatch {mismatch}")
        print(f"K2 {label}: offsets and dropped ({int(dropped)}) equal; K3: S and its count "
              f"({int(s_total)}) equal; K7: S_rev and its total ({int(rev_total)}) equal; "
              f"reverse_mismatch {mismatch}, overflow {int(layout.overflow)}, window_overflow "
              f"{int(layout.window_overflow)}")
        return dict(layout=layout, codes=codes, spill=spill, offsets=offsets, s_table=s_table,
                    packs=packs, s_rev=s_rev, plan=plan)

    for label, pos in frames:
        out = plan_kernels(label, pos)
        if label == "uniform":
            k2_in = (out["codes"], out["spill"], out["layout"])
            k2_off, k4_s, k4_starts = out["offsets"], out["s_table"], out["layout"].window_starts
            k7_packs, k7_s = out["packs"], out["s_rev"]
        del out
    z_pad = torch.randn(spec.num_padded, 128, generator=gen).bfloat16().to(dev)
    out = cellblock.window_matmul(k4_s, z_pad, k4_starts, spec=spec)
    ref = cellblock.window_matmul_reference(k4_s, z_pad, k4_starts, spec=spec)
    err = (out - ref).abs()
    k4_err, k4_mean = float(err.max()), float(err.mean())
    if not (k4_err <= K4_MAX_ABS_TOL and k4_mean <= K4_MEAN_ABS_TOL):
        fail(f"K4 max abs err {k4_err} (tol {K4_MAX_ABS_TOL}), mean {k4_mean} "
             f"(tol {K4_MEAN_ABS_TOL})")
    print(f"K4 [{spec.num_slots}, {width}] x [{spec.num_padded}, 128]: max abs err "
          f"{k4_err:.3g} (tol {K4_MAX_ABS_TOL}), mean {k4_mean:.3g} (tol {K4_MEAN_ABS_TOL})")

    # K2 as the plan build calls it: particle-order codes to offsets and the
    # dropped count (the parent's torch prologue of slot scatter,
    # normalization and 27-roll start table is inside the kernel now).
    k2_codes, k2_spill, k2_layout = k2_in
    k2 = lambda: cellblock.s_decode(k2_codes, k2_spill, k2_layout, spec, codes_cap)  # noqa: E731
    k2_ms = time_ms(k2, 200)
    k2_graph_ms = graph_ms(k2, 50)
    k2_plain_ms = time_ms(lambda: cellblock.s_decode_reference(
        *cellblock.s_decode_inputs(k2_layout, k2_codes, codes_cap, k2_spill, spec), spec=spec,
        codes_cap=codes_cap), 20)
    # In: the codes, the slot, order and z-cell maps, the start and tile
    # tables, the spill tables; out: the offsets and the count. Per pick
    # ~30 integer operations (one division, compares, selects), counted
    # against the float32 vector rate; far below the bytes either way.
    k2_bytes = nbytes(k2_codes, k2_layout.particle_of_slot, k2_layout.order, k2_layout.sorted_cz,
                      k2_layout.cstart_rel, k2_layout.tile_const, k2_off) + 4
    if k2_spill is not None:
        k2_bytes += nbytes(*k2_spill)
    k2_ops = 30 * k2_off.numel()
    report["s_decode"] = kernel_entry(
        "s_decode.cu", "cellblock.py:546", 0.0, k2_ms, k2_plain_ms, k2_bytes, k2_ops,
        F32_FLOP_PER_S, None)
    report["s_decode"]["graph_ms"] = k2_graph_ms

    k3_ms = time_ms(lambda: cellblock.s_onehot(k2_off, width=width), 200)
    k3_graph_ms = graph_ms(lambda: cellblock.s_onehot(k2_off, width=width), 50)
    k3c_ms = time_ms(lambda: cellblock.s_onehot(k2_off, width=width, with_total=True), 200)
    k3c_graph_ms = graph_ms(lambda: cellblock.s_onehot(k2_off, width=width, with_total=True), 50)
    k3_plain_ms = time_ms(lambda: cellblock.s_onehot_reference(k2_off, width=width), 20)
    # Yardstick: scatter_add_ of ones into a zeroed int32 table with two
    # extra columns that catch the sentinels (width, width + 1).
    off_l = k2_off.long()
    ones = torch.ones_like(off_l, dtype=torch.int32)
    k3_lib_ms = time_ms(lambda: torch.zeros(
        (spec.num_slots, width + 2), dtype=torch.int32, device=dev).scatter_add_(1, off_l, ones), 50)
    report["s_onehot"] = kernel_entry(
        "s_onehot.cu", "cellblock.py:499", 0.0, k3_ms, k3_plain_ms,
        nbytes(k2_off, k4_s), k2_off.numel(), F32_FLOP_PER_S, k3_lib_ms)
    report["s_onehot"]["graph_ms"] = k3_graph_ms

    k4_ms = time_ms(lambda: cellblock.window_matmul(k4_s, z_pad, k4_starts, spec=spec), 100)
    k4_plain_ms = time_ms(lambda: cellblock.window_matmul_reference(
        k4_s, z_pad, k4_starts, spec=spec), 5)
    # Yardstick: one torch.bmm of S (as bf16) [T, QB, 9W] with the 9 windows
    # of each tile gathered beforehand [T, 9W, H] (the gather is not timed;
    # the product is dense and its output bf16).
    s_bf16 = k4_s.view(spec.num_tiles, spec.query_block, width).to(torch.bfloat16)
    rows = (k4_starts.long()[:, :, None]
            + torch.arange(spec.window, device=dev)).reshape(spec.num_tiles, width)
    windows = z_pad[rows]
    k4_lib_ms = time_ms(lambda: torch.bmm(s_bf16, windows), 50)
    del s_bf16, windows
    # The product S @ window is sparse: the work this data needs is one
    # multiply-add per nonzero S entry and latent column.
    k4_nnz = int((k4_s != 0).sum())
    k4_ops = 2 * k4_nnz * 128
    k4_live = float((k4_s.view(spec.num_tiles, spec.query_block // 32, 32, width // 64, 64) != 0)
                    .any(4).any(2).float().mean())
    report["window_matmul"] = kernel_entry(
        "window_matmul.cu", "cellblock.py:2607", k4_err, k4_ms, k4_plain_ms,
        nbytes(k4_s, z_pad, k4_starts, out), k4_ops, BF16_TENSOR_FLOP_PER_S, k4_lib_ms)
    print(f"K2 time {k2_ms:.4f} ms (graph {k2_graph_ms:.4f}; bound "
          f"{report['s_decode']['bound_ms']:.5f}), plain {k2_plain_ms:.4f} ms, {k2_bytes} bytes; "
          f"K3 time {k3_ms:.4f} ms (graph {k3_graph_ms:.4f}), with its count {k3c_ms:.4f} (graph "
          f"{k3c_graph_ms:.4f}), plain {k3_plain_ms:.4f} ms, scatter_add_ {k3_lib_ms:.4f} ms; "
          f"K4 time {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, bmm {k4_lib_ms:.4f} ms, "
          f"{k4_nnz} nonzero S entries of {k4_s.numel()} ({100 * (1 - k4_nnz / k4_s.numel()):.3f} % "
          f"zeros), {100 * k4_live:.2f} % of (32-row, 64-deep) S blocks live, dense bf16 work "
          f"{2 * spec.num_slots * width * 128} FLOP")
    del out, ref, k4_s, z_pad

    # K7's time; K4^T against its plain version on the uniform frame's S_rev.
    def k7_timing(pspec, layout, packs):
        """K7's events and graph times, its plain version's, and its
        yardstick's: one scatter_add_ of ones into a zeroed int8 table of
        [rows, rev_lanes + 1] from flat indices computed beforehand (the
        edges that do not count go to the extra column), as K3's."""
        fn = lambda: cellblock.reverse_table(packs, layout, pspec)  # noqa: E731
        ms, gms = time_ms(fn, 100), graph_ms(fn, 20)
        # The card's practical store rate: one fill_ of a table of S_rev's
        # size (a floor for the writes alone, not a yardstick).
        table = torch.empty((pspec.num_tiles, pspec.s_width, pspec.rev_lanes), dtype=torch.int8,
                            device=dev)
        fill_ms = graph_ms(lambda: table.fill_(0), 20)
        del table
        plain_ms = time_ms(lambda: cellblock.reverse_table_reference(
            cellblock.reverse_candidates(packs, layout, pspec), layout.window_starts,
            spec=pspec).sum(dtype=torch.int32), 5)
        lanes, w_ = pspec.rev_lanes, pspec.window
        rows_ = (layout.window_starts.long()[:, :, None]
                 + torch.arange(w_, device=dev)).reshape(pspec.num_tiles, -1)  # [T, 9W]
        cand = cellblock.reverse_candidates(packs, layout, pspec).long()
        win = cand[rows_]  # [T, 9W, k + 1]
        starts_ = layout.window_starts.long().repeat_interleave(w_, dim=1)  # [T, 9W]
        main = win[..., -1]
        speaks = (main == rows_) | (main < starts_) | (main >= starts_ + w_)
        local = win[..., :-1] - (torch.arange(pspec.num_tiles, device=dev)
                                 * pspec.query_block)[:, None, None]
        ok = speaks[..., None] & (local >= 0) & (local < pspec.query_block)
        idx = torch.where(ok, local, lanes).reshape(-1, local.shape[-1])
        ones_ = torch.ones_like(idx, dtype=torch.int8)
        lib_ms = time_ms(lambda: torch.zeros((idx.shape[0], lanes + 1), dtype=torch.int8,
                                             device=dev).scatter_add_(1, idx, ones_), 20)
        del cand, win, local, ok, idx, ones_
        # In: the packs, pad_src, c_pre, the window starts; out: S_rev and
        # its total. Per (row, sender): a subtraction and two compares.
        nb = nbytes(packs, layout.pad_src, layout.c_pre, layout.window_starts) + 4 + (
            pspec.num_tiles * pspec.s_width * lanes)
        ops = 3 * pspec.num_tiles * pspec.s_width * packs.shape[1]
        return ms, gms, plain_ms, lib_ms, nb, ops, fill_ms

    k7_ms, k7_graph_ms, k7_plain_ms, k7_lib_ms, k7_bytes, k7_ops, k7_fill_ms = k7_timing(
        spec, k2_layout, k7_packs)
    report["reverse_table"] = kernel_entry(
        "reverse_table.cu", "cellblock.py:2431", 0.0, k7_ms, k7_plain_ms, k7_bytes, k7_ops,
        F32_FLOP_PER_S, k7_lib_ms)
    report["reverse_table"]["graph_ms"] = k7_graph_ms
    g_pad = torch.randn(spec.num_padded, 128, generator=gen).bfloat16().to(dev)
    out = cellblock.window_matmul_t(k7_s, g_pad, k4_starts, spec=spec)
    ref = cellblock.window_matmul_t_reference(k7_s, g_pad, k4_starts, spec=spec)
    err = (out - ref).abs()
    k4t_err, k4t_mean = float(err.max()), float(err.mean())
    if not (k4t_err <= K4_MAX_ABS_TOL and k4t_mean <= K4_MEAN_ABS_TOL):
        fail(f"K4^T max abs err {k4t_err} (tol {K4_MAX_ABS_TOL}), mean {k4t_mean} "
             f"(tol {K4_MEAN_ABS_TOL})")
    print(f"K4^T [{spec.num_tiles}, {width}, {spec.rev_lanes}] x [{spec.num_padded}, 128]: "
          f"max abs err {k4t_err:.3g} (tol {K4_MAX_ABS_TOL}), mean {k4t_mean:.3g} "
          f"(tol {K4_MEAN_ABS_TOL})")
    k4t_ms = time_ms(lambda: cellblock.window_matmul_t(k7_s, g_pad, k4_starts, spec=spec), 100)
    k4t_plain_ms = time_ms(lambda: cellblock.window_matmul_t_reference(
        k7_s, g_pad, k4_starts, spec=spec), 5)
    # Yardstick: one torch.bmm of S_rev^T (bf16) [T, QB, 9W] with the tiles'
    # gathered windows [T, 9W, H] (gather untimed, output bf16).
    s_rev_t = k7_s[:, :, :spec.query_block].transpose(1, 2).to(torch.bfloat16).contiguous()
    windows = g_pad[rows]
    k4t_lib_ms = time_ms(lambda: torch.bmm(s_rev_t, windows), 50)
    del s_rev_t, windows
    k4t_nnz = int((k7_s != 0).sum())
    report["window_matmul_t"] = kernel_entry(
        "window_matmul.cu", "cellblock.py:2607", k4t_err, k4t_ms, k4t_plain_ms,
        nbytes(k7_s, g_pad, k4_starts, out), 2 * k4t_nnz * 128, BF16_TENSOR_FLOP_PER_S,
        k4t_lib_ms)
    print(f"K7 time {k7_ms:.4f} ms (graph {k7_graph_ms:.4f}; bound "
          f"{report['reverse_table']['bound_ms']:.5f}), plain {k7_plain_ms:.4f} ms, scatter_add_ "
          f"{k7_lib_ms:.4f} ms, fill_ of the table {k7_fill_ms:.4f} ms (graph), {k7_bytes} bytes; "
          f"K4^T time {k4t_ms:.4f} ms, "
          f"plain {k4t_plain_ms:.4f} ms, bmm {k4t_lib_ms:.4f} ms, {k4t_nnz} nonzero S_rev "
          f"entries")
    del out, ref, g_pad, k7_s

    # K4 and K4^T on the aux spec (grid 14: QB 224, W 384, S width 3,456),
    # from the plan of K1's neighbor ids with its reverse table; and each
    # mode's rate, registers and spills.
    aux_spec = cellblock.choose_cellblock_spec(N)
    aux_ids = pallas_knn.pallas_cell_list_knn(pos0, K, 1.0, grid)
    aux_plan = cellblock.build_cellblock(pos0, aux_ids, 1.0, aux_spec, with_reverse=True)
    if int(aux_plan.reverse_mismatch) != 0 or int(aux_plan.dropped_edges) != 0:
        fail(f"aux plan: reverse_mismatch {int(aux_plan.reverse_mismatch)}, dropped "
             f"{int(aux_plan.dropped_edges)}")
    # K7 on the aux spec (rev_lanes 256 over QB 224, W 384), from the aux
    # route's sender packs.
    aux_layout = cellblock.cellblock_layout(pos0, 1.0, aux_spec)
    aux_packs = (cellblock.aux_slot_senders(aux_layout, aux_ids, aux_spec)
                 // aux_spec.grid_size).to(torch.int32)
    a_rev, a_total = cellblock.reverse_table(aux_packs, aux_layout, aux_spec)
    a_ref = cellblock.reverse_table_reference(
        cellblock.reverse_candidates(aux_packs, aux_layout, aux_spec), aux_layout.window_starts,
        spec=aux_spec)
    if not (torch.equal(a_rev, a_ref) and torch.equal(a_rev, aux_plan.s_rev_table)
            and int(a_total) == int(a_ref.sum(dtype=torch.int64))):
        fail("K7 aux spec: reverse table or its total differs from the plain version")
    ka_ms, ka_graph_ms, ka_plain_ms, ka_lib_ms, ka_bytes, _, ka_fill_ms = k7_timing(
        aux_spec, aux_layout, aux_packs)
    report["reverse_table"].update(aux_ms=ka_ms, aux_graph_ms=ka_graph_ms)
    print(f"K7 aux spec (G {aux_spec.grid_size}, QB {aux_spec.query_block}, W "
          f"{aux_spec.window}): S_rev and its total ({int(a_total)}) equal to the plain version; "
          f"time {ka_ms:.4f} ms (graph {ka_graph_ms:.4f}; bound "
          f"{ka_bytes / HBM_BYTES_PER_S * 1e3:.5f}), plain {ka_plain_ms:.4f} ms, scatter_add_ "
          f"{ka_lib_ms:.4f} ms, fill_ of the table {ka_fill_ms:.4f} ms (graph), {ka_bytes} bytes")
    del a_rev, a_ref, aux_layout, aux_packs, aux_ids
    a_pad = torch.randn(aux_spec.num_padded, 128, generator=gen).bfloat16().to(dev)
    aux_rows = (aux_plan.window_starts.long()[:, :, None]
                + torch.arange(aux_spec.window, device=dev)).reshape(aux_spec.num_tiles, -1)
    for label, fn, plain, table, s_b in (
            ("K4", cellblock.window_matmul, cellblock.window_matmul_reference, aux_plan.s_table,
             aux_plan.s_table.view(aux_spec.num_tiles, aux_spec.query_block, -1)),
            ("K4^T", cellblock.window_matmul_t, cellblock.window_matmul_t_reference,
             aux_plan.s_rev_table,
             aux_plan.s_rev_table[:, :, :aux_spec.query_block].transpose(1, 2))):
        out = fn(table, a_pad, aux_plan.window_starts, spec=aux_spec)
        ref = plain(table, a_pad, aux_plan.window_starts, spec=aux_spec)
        err = (out - ref).abs()
        e_max, e_mean = float(err.max()), float(err.mean())
        if not (e_max <= K4_MAX_ABS_TOL and e_mean <= K4_MEAN_ABS_TOL):
            fail(f"{label} aux: max abs err {e_max} (tol {K4_MAX_ABS_TOL}), mean {e_mean} "
                 f"(tol {K4_MEAN_ABS_TOL})")
        ms = time_ms(lambda: fn(table, a_pad, aux_plan.window_starts, spec=aux_spec), 100)
        plain_ms = time_ms(lambda: plain(table, a_pad, aux_plan.window_starts, spec=aux_spec), 3)
        s_bf16 = s_b.to(torch.bfloat16).contiguous()
        windows = a_pad[aux_rows]
        bmm_ms = time_ms(lambda: torch.bmm(s_bf16, windows), 50)
        del s_bf16, windows
        a_bytes = nbytes(table, a_pad, aux_plan.window_starts, out)
        print(f"{label} aux spec (G {aux_spec.grid_size}, QB {aux_spec.query_block}, W "
              f"{aux_spec.window}, table {tuple(table.shape)}): max abs err {e_max:.3g}, mean "
              f"{e_mean:.3g} (tol {K4_MAX_ABS_TOL}, {K4_MEAN_ABS_TOL}); time {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bmm {bmm_ms:.4f} ms; {a_bytes} bytes, bound "
              f"{a_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms, {a_bytes / ms / 1e6:.1f} GB/s")
        del out, ref
    for name in ("window_matmul", "window_matmul_t"):
        entry = report[name]
        rate = entry["bound_ms"] / 1e3 * HBM_BYTES_PER_S / (entry["ms"] / 1e3) / 1e9
        print(f"{name} flagship: {entry['ms']:.4f} ms, {rate:.1f} GB/s "
              f"({100 * entry['bound_ms'] / entry['ms']:.1f} % of its bytes bound); "
              f"bmm {entry['library_ms']:.4f} ms")
    print_ptxas(logs, "window_matmul")
    for name in ("s_decode", "reverse_table", "s_onehot"):
        print_ptxas(logs, name)
    del a_pad, aux_plan, aux_rows, table, s_b

    # K8 on the dense plan's inputs: the uniform frame, a frame whose search
    # windows truncate (300 particles in one cell: the windows of its tiles
    # outgrow w_eff), where the certificate must fail alike on the card and
    # on the CPU plain path, and the lattice frame (ties). K8 searches the
    # live rows of the plan's mask (padding rows get the no-pick lane and
    # 1e30).
    dspec = cellblock.choose_dense_search_spec(N, spec)
    truncating = pos0.clone()
    truncating[:300] = torch.tensor([0.41, 0.41, 0.41], device=dev) + 0.05 * truncating[:300]
    for label, pos in (("uniform", pos0), ("truncating", truncating), ("lattice", lattice)):
        layout = cellblock.cellblock_layout(pos, 1.0, spec)
        ds = cellblock.dense_search_inputs(layout, pos[layout.order], 1.0, spec, dspec)
        live = (torch.arange(dspec.query_block, device=dev) < ds.rows[:, None]).reshape(-1)
        for k in (K, K1_WIDE_K) if label != "truncating" else (K,):
            k8_args = dict(k=k, query_block=dspec.query_block, w_eff=ds.w_eff)
            lanes, kth = cellblock.dense_select(ds.table, ds.queries, ds.windows, 1.0, ds.rows,
                                                **k8_args)
            ref_lanes, ref_kth = cellblock.dense_select_reference(
                ds.table, ds.queries, ds.windows, 1.0, **k8_args)
            if not torch.equal(lanes[live], ref_lanes[live]):
                fail(f"K8 {label} k={k}: lanes differ from the plain version in "
                     f"{int((lanes[live] != ref_lanes[live]).any(1).sum())} live rows")
            if not torch.equal(kth[live].view(torch.int32), ref_kth[live].view(torch.int32)):
                fail(f"K8 {label} k={k}: kth not bit-equal to the plain version")
            if not (bool((lanes[~live] == 9 * ds.w_eff).all()) and bool((kth[~live] == 1e30).all())):
                fail(f"K8 {label} k={k}: padding rows not the no-pick lane and 1e30")
            if label == "uniform" and k == K:
                k8_ds, k8_args_u, k8_lanes, k8_kth = ds, k8_args, lanes, kth
                k8_err = float((kth[live] - ref_kth[live]).abs().max())
        print(f"K8 {label}: {ds.windows.shape[0]} tiles, {int(live.sum())} live rows of "
              f"{live.numel()}; k = {K}{'' if label == 'truncating' else f' and {K1_WIDE_K}'}: "
              f"live rows' lanes equal and kth bit-equal to the plain version, padding rows "
              f"the no-pick lane")
        if label == "lattice":
            continue
        # The dense train plan: with its reverse table (K7 from the dense
        # route's sender packs) and the certificate from the two counts.
        plan = cellblock.build_cellblock(pos, None, 1.0, spec, dense_search=dspec,
                                         num_neighbors=K, with_reverse=True)
        cpu_plan = cellblock.build_cellblock(pos.cpu(), None, 1.0, spec, dense_search=dspec,
                                             num_neighbors=K, with_reverse=True)
        for field in ("s_table", "s_rev_table", "overflow", "dropped_edges", "reverse_mismatch",
                      "search_window_overflow", "search_excess"):
            if not torch.equal(getattr(plan, field).cpu(), getattr(cpu_plan, field)):
                fail(f"K8 {label}: the dense plan's {field} differs from the CPU plain path")
        swo, excess = int(plan.search_window_overflow), float(plan.search_excess)
        if label == "uniform" and not (swo == 0 and excess <= 0 and int(plan.overflow) == 0
                                       and int(plan.dropped_edges) == 0
                                       and int(plan.reverse_mismatch) == 0):
            fail(f"K8 uniform: certificate false (search_window_overflow {swo}, "
                 f"search_excess {excess}, reverse_mismatch {int(plan.reverse_mismatch)})")
        if label == "truncating" and swo == 0:
            fail("K8 truncating: the search windows truncated nothing")
        print(f"K8 {label}: the dense train plan equal to the CPU plain path (S, S_rev, "
              f"overflow {int(plan.overflow)}, dropped {int(plan.dropped_edges)}, "
              f"reverse_mismatch {int(plan.reverse_mismatch)}, "
              f"search_window_overflow {swo}, search_excess {excess:.6g})")
        del plan, cpu_plan
    k8 = lambda: cellblock.dense_select(  # noqa: E731
        k8_ds.table, k8_ds.queries, k8_ds.windows, 1.0, k8_ds.rows, **k8_args_u)
    k8_ms = time_ms(k8, 50)
    k8_graph_ms = graph_ms(k8, 20)
    k8_plain_ms = time_ms(lambda: cellblock.dense_select_reference(
        k8_ds.table, k8_ds.queries, k8_ds.windows, 1.0, **k8_args_u), 3)
    # The work this data needs: every live query row against its 9 * w_eff
    # candidate lanes (3 sub, 3 mul, 2 add, 1 compare with the k-th each).
    live_rows = int(k8_ds.rows.sum())
    k8_pairs = live_rows * 9 * k8_ds.w_eff
    k8_bytes = nbytes(k8_ds.table, k8_ds.queries, k8_ds.windows, k8_ds.rows, k8_lanes, k8_kth)
    report["dense_select"] = kernel_entry(
        "dense_select.cu", "cellblock.py:765", k8_err, k8_ms, k8_plain_ms, k8_bytes,
        9 * k8_pairs, F32_FLOP_PER_S, None)
    report["dense_select"]["graph_ms"] = k8_graph_ms
    print(f"K8 time {k8_ms:.4f} ms (graph {k8_graph_ms:.4f}), plain {k8_plain_ms:.3f} ms; "
          f"{live_rows} live query rows of "
          f"{k8_ds.queries.shape[0]}, {k8_pairs} pairs, {k8_bytes} bytes")
    print_ptxas(logs, "dense_select")
    del k8_ds, k8_lanes, k8_kth
    print(f"phase 4 K2, K3, K7, K4, K4^T (flagship and aux), K8: "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 4b. the uncertified regime ----------------------------------------
    # Frames where the certificate is false: the spill block overflows, rows
    # run short of k candidates (sentinel picks), columns overflow. Every
    # kernel is held bit-equal to its plain version there, and the plan's
    # counts to the CPU plain path's; the certificate is what the plain
    # path says (false), never asserted true.
    t0 = time.perf_counter()
    for label, share, sigma in CLUSTERED:
        pos = torch.as_tensor(clustered_frame(N, share, sigma, args.seed + 21), device=dev)
        table, spill, n_spilled = k1_inputs(pos)
        for name, select, plain in (
                ("K1", pallas_knn.knn_select, pallas_knn.knn_select_reference),
                ("K1'", pallas_knn.knn_codes, pallas_knn.knn_codes_reference),
                ("K1''", pallas_knn.knn_dual, pallas_knn.knn_dual_reference)):
            *picks, kth = select(table, spill, **k1_args)
            *ref_picks, ref_kth = plain(table, spill, **ref_args)
            if not (all(torch.equal(a, b) for a, b in zip(picks, ref_picks))
                    and torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32))):
                fail(f"{name} {label}: differs from the plain version in "
                     f"{int((picks[0] != ref_picks[0]).any(1).sum())} rows")
        short_rows = int((kth >= 1e29).sum())
        nbr, diag = pallas_knn.pallas_cell_list_knn(pos, K, 1.0, grid, return_diagnostics=True)
        cpu_nbr, cpu_diag = pallas_knn.pallas_cell_list_knn(pos.cpu(), K, 1.0, grid,
                                                            return_diagnostics=True)
        if not (torch.equal(nbr.cpu(), cpu_nbr)
                and all(torch.equal(a.cpu(), b) for a, b in zip(diag, cpu_diag))):
            fail(f"K1 {label}: neighbors or diagnostics differ from the CPU plain path")
        overflow, excess = int(cpu_diag[0]), float(cpu_diag[2])
        if overflow == 0:
            fail(f"{label}: the CPU plain path certifies the frame (overflow 0)")
        layout = cellblock.cellblock_layout(pos, 1.0, spec)
        ds = cellblock.dense_search_inputs(layout, pos[layout.order], 1.0, spec, dspec)
        live = (torch.arange(dspec.query_block, device=dev) < ds.rows[:, None]).reshape(-1)
        k8_args = dict(k=K, query_block=dspec.query_block, w_eff=ds.w_eff)
        lanes, kth8 = cellblock.dense_select(ds.table, ds.queries, ds.windows, 1.0, ds.rows,
                                             **k8_args)
        ref_lanes, ref_kth8 = cellblock.dense_select_reference(ds.table, ds.queries, ds.windows,
                                                               1.0, **k8_args)
        if not (torch.equal(lanes[live], ref_lanes[live])
                and torch.equal(kth8[live].view(torch.int32), ref_kth8[live].view(torch.int32))):
            fail(f"K8 {label}: live rows differ from the plain version")
        out = plan_kernels(label, pos, certified=False)
        cpu_plan = cellblock.build_cellblock(
            pos.cpu(), None, 1.0, spec, with_reverse=True, neighbor_codes=out["codes"].cpu(),
            codes_cap=codes_cap, codes_spill=tuple(t.cpu() for t in out["spill"]))
        for field in ("s_table", "s_rev_table", "overflow", "dropped_edges",
                      "reverse_mismatch", "window_overflow"):
            mine, theirs = getattr(out["plan"], field), getattr(cpu_plan, field)
            if not (torch.equal(mine.cpu(), theirs) if mine.dim() else int(mine) == int(theirs)):
                fail(f"{label}: the plan's {field} differs from the CPU plain path")
        print(f"uncertified {label} ({share:.0%} in a sigma {sigma} ball): K1, K1', K1'' equal "
              f"to their plain versions ({n_spilled} spilled, {short_rows} rows short of k "
              f"candidates), K8 live rows equal; the CPU plain path's certificate false "
              f"(overflow {overflow}, max_excess {excess:.6g}), the card's equal; the plan's S, "
              f"S_rev, overflow {int(cpu_plan.overflow)}, dropped {int(cpu_plan.dropped_edges)}, "
              f"reverse_mismatch {int(cpu_plan.reverse_mismatch)} equal to the CPU plain path's")
        del out, cpu_plan, layout, ds
    print(f"phase 4b uncertified regime: {time.perf_counter() - t0:.1f} s")

    # ---- 5-8. the rollout slices -----------------------------------------
    stats = NormalizationStats.from_metadata(METADATA, device=dev)
    stats_cpu = NormalizationStats.from_metadata(METADATA, device="cpu")
    params_cpu = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed),
                                            device="cpu")
    pos, temp = seed_window(N, args.seed)
    spos, stemp = seed_window(SMALL_N, args.seed + 2)
    mp = cfg.num_message_passing_steps
    zero = dict.fromkeys(kernels.KERNELS, 0)
    path_launches, path_ms, small_runs = {}, {}, {}
    hybrid = {"aggregation": "cellblock_hybrid"}
    # The aux route: the chooser's spec without k (grid 14 at N, 7 at
    # SMALL_N) is not on the k-NN grid (19, 9), so plans come from ids.
    aux_small_spec = cellblock.choose_cellblock_spec(SMALL_N)
    plan_launches = {"s_onehot": STEPS, "window_matmul": STEPS * mp, "fused_tail": STEPS * mp}
    paths = (
        ("gather", 5, {"aggregation": "gather"}, {}, {"knn_select": STEPS, "fused_tail": STEPS * mp}),
        ("cellblock_hybrid", 6, hybrid, {},
         {"knn_codes": STEPS, "s_decode": STEPS, **plan_launches}),
        ("cellblock_hybrid dense", 7, {**hybrid, "cellblock_search": "dense"}, {},
         {"dense_select": STEPS, **plan_launches}),
        ("cellblock_hybrid aux", 8, {**hybrid, "cellblock_spec": aux_spec},
         {"cellblock_spec": aux_small_spec}, {"knn_dual": STEPS, **plan_launches}),
    )
    for label, phase, path_kw, small_kw, expected in paths:
        t0 = time.perf_counter()
        kw = dict(num_neighbors=K, dtype=torch.bfloat16, exactness_guard="flag",
                  reneighbor_every=1, device=dev, **path_kw)
        rollout(params, cfg, pos, temp, stats, 1, **kw)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = rollout(params, cfg, pos, temp, stats, STEPS, **kw)
        end.record()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        step_ms = start.elapsed_time(end) / STEPS
        coords_out, energy = result["Coordinates"], result["InternalEnergy"]
        if coords_out.shape != (WINDOW + STEPS, N, 3) or energy.shape != (WINDOW + STEPS, N, 1):
            fail(f"{label}: trajectory shapes {tuple(coords_out.shape)}, "
                 f"{tuple(energy.shape)}")
        if not (bool(torch.isfinite(coords_out).all()) and bool(torch.isfinite(energy).all())):
            fail(f"{label}: trajectory not finite")
        if not bool(result["neighbor_exactness"].all()):
            fail(f"{label}: certificate false on steps "
                 f"{result['neighbor_exactness'].tolist()}")
        if launches != {**zero, **expected}:
            fail(f"{label}: launches {launches}, expected {expected}")
        step = coords_out[-1] - coords_out[WINDOW - 1]
        moved = float((step - torch.round(step)).abs().max())  # min-image, box 1
        print(f"slice {label}: N={N} k={K} default model bf16, {STEPS} steps, "
              f"{step_ms:.3f} ms/step ({N / step_ms * 1e3:.0f} particle-steps/s), launches "
              f"{ {k: v for k, v in launches.items() if v} }, certificate true every step, "
              f"max displacement {moved:.3g}, peak memory {peak_gib:.3f} GiB")
        path_launches[label], path_ms[label] = launches, step_ms

        small_kw = {**kw, **small_kw}
        small_gpu = rollout(params, cfg, spos, stemp, stats, SMALL_STEPS, **small_kw)
        small_cpu = rollout(params_cpu, cfg, spos, stemp, stats_cpu, SMALL_STEPS,
                            **{**small_kw, "device": "cpu"}, fused_tail=True)
        small_err = float((small_gpu["Coordinates"].cpu() - small_cpu["Coordinates"]).abs().max())
        if not small_err <= SMALL_COORD_TOL:
            fail(f"{label}: N={SMALL_N} rollout differs from the CPU plain path "
                 f"by {small_err}")
        if not bool(small_gpu["neighbor_exactness"].all()):
            fail(f"{label}: N={SMALL_N} certificate false")
        small_runs[label] = small_gpu["Coordinates"]
        print(f"slice {label} check: N={SMALL_N}, {SMALL_STEPS} steps, card vs CPU plain "
              f"path max coordinate diff {small_err:.3g} (tol {SMALL_COORD_TOL})")
        if label != "gather":
            cross = float((small_runs[label] - small_runs["gather"]).abs().max())
            if not cross <= SMALL_COORD_TOL:
                fail(f"N={SMALL_N} {label} and gather rollouts on the card differ by {cross}")
            print(f"slice check: N={SMALL_N}, {label} vs gather on the card max coordinate "
                  f"diff {cross:.3g} (tol {SMALL_COORD_TOL})")
        print(f"phase {phase} slice {label}: {time.perf_counter() - t0:.1f} s")

    # ---- 9. one-step prediction ------------------------------------------
    t0 = time.perf_counter()
    for label, path_kw in (("gather", {"aggregation": "gather"}), ("cellblock_hybrid", hybrid),
                           ("cellblock_hybrid aux", {**hybrid, "cellblock_spec": aux_spec})):
        kw = dict(num_neighbors=K, dtype=torch.bfloat16, device=dev, **path_kw)
        new_pos, new_temp = one_step_prediction(params, cfg, pos, temp, stats, **kw)
        ref = rollout(params, cfg, pos, temp, stats, 1, **kw)
        if new_pos.shape != (N, 3) or new_temp.shape != (N, 1):
            fail(f"one-step {label}: shapes {tuple(new_pos.shape)}, {tuple(new_temp.shape)}")
        err = max(float((new_pos - ref["Coordinates"][-1]).abs().max()),
                  float((new_temp - ref["InternalEnergy"][-1]).abs().max()))
        if not err <= ONE_STEP_TOL:
            fail(f"one-step {label}: differs from a 1-step rollout by {err}")
        print(f"one-step {label}: N={N}, equal to the first frame of a 1-step rollout "
              f"(max diff {err:.3g}, tol {ONE_STEP_TOL})")
    print(f"phase 9 one-step: {time.perf_counter() - t0:.1f} s")

    # ---- 10, 11. the train slices ----------------------------------------
    tbatch = train_batch(N, args.seed)
    train_paths = (
        ("gather", 10, {"knn_select": 1, "fused_tail": mp, "fused_tail_bwd": mp}),
        ("cellblock_hybrid", 11, {"knn_codes": 1, "s_decode": 1, "s_onehot": 1,
                                 "reverse_table": 1, "window_matmul": mp,
                                 "window_matmul_t": mp, "fused_tail": mp,
                                 "fused_tail_bwd": mp}),
    )
    train_ms = {}
    for aggregation, phase, per_step in train_paths:
        t0 = time.perf_counter()
        tc = TrainConfig(aggregation=aggregation, num_neighbors=K, compute_dtype="bfloat16",
                         noise_std=TRAIN_NOISE)
        tparams = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed),
                                             device=dev)
        optimizer = make_optimizer(tc, steps_per_epoch=TRAIN_STEPS + 1)
        state = optimizer.init(tparams)
        train_step = make_train_step(cfg, stats, tc, optimizer)
        tgen = torch.Generator(device=dev).manual_seed(args.seed)
        train_step(tparams, state, tbatch, tgen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = [train_step(tparams, state, tbatch, tgen)[2] for _ in range(TRAIN_STEPS)]
        end.record()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        step_ms = start.elapsed_time(end) / TRAIN_STEPS
        losses = [float(m["loss"]) for m in metrics]
        if not all(np.isfinite(losses)):
            fail(f"train {aggregation}: loss not finite: {losses}")
        if aggregation == "cellblock_hybrid":
            violations = [float(m["cellblock_violations"]) for m in metrics]
            if any(violations):
                fail(f"train {aggregation}: cellblock_violations {violations}")
        expected = {name: count * TRAIN_STEPS for name, count in per_step.items()}
        if launches != {**zero, **expected}:
            fail(f"train {aggregation}: launches {launches}, expected {expected}")
        print(f"train slice {aggregation}: N={N} k={K} default model bf16, noise "
              f"{TRAIN_NOISE}, batch 1, {TRAIN_STEPS} steps, {step_ms:.3f} ms/step, losses "
              f"{[float(f'{v:.6g}') for v in losses]}, launches "
              f"{ {k: v for k, v in launches.items() if v} }"
              + (", cellblock_violations 0 every step" if aggregation != "gather" else "")
              + f", peak memory {peak_gib:.3f} GiB")
        path_launches[f"train {aggregation}"], train_ms[aggregation] = launches, step_ms
        del tparams, state, optimizer, train_step, metrics
        print(f"phase {phase} train slice {aggregation}: {time.perf_counter() - t0:.1f} s")

    # One train step (noise 0, no augmentation, SGD with lr 1: the update
    # is the gradient) at N = 8,192 on the card and on the CPU plain path.
    t0 = time.perf_counter()
    sbatch = train_batch(SMALL_N, args.seed + 2)
    small_grads = {}
    for aggregation in ("gather", "cellblock_hybrid"):
        runs = {}
        for device in (dev, torch.device("cpu")):
            sgd = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
            # The card resolves fused_tail=None to on; the CPU runs the
            # plain versions of K5 and K6.
            tc = TrainConfig(aggregation=aggregation, num_neighbors=K,
                             compute_dtype="bfloat16", noise_std=0.0, augment_prob=0.0,
                             fused_tail=True if device.type == "cpu" else None)
            sparams = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed),
                                                 device=device)
            before = [t.detach().clone() for t in tree_leaves(sparams)]
            step = make_train_step(cfg, stats if device.type == "cuda" else stats_cpu, tc, sgd)
            sparams, _, m = step(sparams, sgd.init(sparams), sbatch,
                                 torch.Generator(device=device))
            grads = [(b - a.detach()).cpu() for b, a in zip(before, tree_leaves(sparams))]
            runs[device.type] = (float(m["loss"]), grads)
        (loss, grads), (cpu_loss, cpu_grads) = runs["cuda"], runs["cpu"]
        grad_err = max(float((a - b).abs().max()) / float(b.abs().max())
                       for a, b in zip(grads, cpu_grads) if float(b.abs().max()))
        loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
        if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL):
            fail(f"train {aggregation}: N={SMALL_N} card vs CPU plain path: loss rel err "
                 f"{loss_err}, worst gradient rel err {grad_err}")
        print(f"train slice {aggregation} check: N={SMALL_N}, card vs CPU plain path: loss "
              f"{loss:.6g} vs {cpu_loss:.6g} (rel err {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}), "
              f"worst gradient leaf rel err {grad_err:.3g} (tol {TRAIN_GRAD_TOL})")
        small_grads[aggregation] = grads
    cross = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(small_grads["cellblock_hybrid"], small_grads["gather"])
                if float(b.abs().max()))
    if not cross <= TRAIN_GRAD_TOL:
        fail(f"N={SMALL_N} hybrid and gather gradients on the card differ by {cross}")
    print(f"train slice check: N={SMALL_N}, hybrid vs gather gradients on the card: worst "
          f"leaf rel err {cross:.3g} (tol {TRAIN_GRAD_TOL})")
    print(f"phase 11 train check: {time.perf_counter() - t0:.1f} s")

    # ---- 12a. the Trainer slice ------------------------------------------
    t0 = time.perf_counter()
    fit_train = MemoryDataset([generate_synthetic_simulation(
        num_snapshots=FIT_TRAIN_SNAPSHOTS, num_particles=N, seed=args.seed + 10)])
    fit_val = MemoryDataset([generate_synthetic_simulation(
        num_snapshots=FIT_VAL_SNAPSHOTS, num_particles=N, seed=args.seed + 11)])
    train_steps, eval_steps = FIT_EPOCHS * len(fit_train), FIT_EPOCHS * len(fit_val)
    fit_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_fit_")  # removed after 12b
    fit_root = fit_tmp.name
    fit_tc = TrainConfig(aggregation="cellblock_hybrid", num_neighbors=K, batch_size=1,
                         compute_dtype="bfloat16", noise_std=TRAIN_NOISE, num_epochs=FIT_EPOCHS,
                         save_every=1, learning_rate=1e-4, final_learning_rate=1e-5,
                         seed=args.seed, output_dir=os.path.join(fit_root, "continuous"))

    def timed_steps(trainer):
        """Wrap the trainer's train step in CUDA events (no sync): each
        step's (start, end, metrics)."""
        steps, step = [], trainer.train_step

        def timed(*step_args):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            out = step(*step_args)
            end.record()
            steps.append((start, end, out[2]))
            return out

        trainer.train_step = timed
        return steps

    fitter = Trainer(cfg, stats, fit_tc, len(fit_train), device=dev)
    steps = timed_steps(fitter)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    fitter.fit(fit_train, fit_val)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    fit_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    expected = {"knn_codes": train_steps + eval_steps, "s_decode": train_steps + eval_steps,
                "s_onehot": train_steps + eval_steps, "reverse_table": train_steps,
                "window_matmul": mp * (train_steps + eval_steps),
                "window_matmul_t": mp * train_steps,
                "fused_tail": mp * (train_steps + eval_steps), "fused_tail_bwd": mp * train_steps}
    if launches != {**zero, **expected}:
        fail(f"Trainer.fit: launches {launches}, expected {expected}")
    h = fitter.history
    losses = h["train_loss"] + h["val_loss"]
    if len(h["train_loss"]) != FIT_EPOCHS or not all(np.isfinite(losses)):
        fail(f"Trainer.fit: losses {h['train_loss']}, {h['val_loss']}")
    violations = [float(m["cellblock_violations"]) for _, _, m in steps]
    if len(steps) != train_steps or any(violations):
        fail(f"Trainer.fit: {len(steps)} train steps, cellblock_violations {violations}")
    out_dir = fit_tc.output_dir
    artifacts = ["model_best", "model_final", "training_history.json",
                 *(f"model_epoch_{e}" for e in range(FIT_EPOCHS))]
    missing = [a for a in artifacts if not os.path.exists(os.path.join(out_dir, a))]
    with open(os.path.join(out_dir, "training_history.json")) as f:
        saved_history = json.load(f)
    if missing or sorted(saved_history) != HISTORY_KEYS or \
            sorted(saved_history["component_losses"]) != COMPONENT_KEYS:
        fail(f"Trainer.fit artifacts: missing {missing}, history keys {sorted(saved_history)}")
    per_epoch = len(fit_train)
    step_ms = [start.elapsed_time(end) for start, end, _ in steps]
    loop_ms = [steps[e * per_epoch][0].elapsed_time(steps[(e + 1) * per_epoch - 1][1]) / per_epoch
               for e in range(FIT_EPOCHS)]
    fit_step_ms = float(np.mean(step_ms[per_epoch:]))  # after the first epoch
    epoch_s = fitter.step_timer.summary()["train_epoch"]
    print(f"Trainer.fit cellblock_hybrid: N={N} k={K} default model bf16, noise {TRAIN_NOISE}, "
          f"batch 1, {FIT_EPOCHS} epochs of {per_epoch} train + {len(fit_val)} eval steps; "
          f"train losses {[float(f'{v:.6g}') for v in h['train_loss']]}, val losses "
          f"{[float(f'{v:.6g}') for v in h['val_loss']]}, cellblock_violations 0 every step; "
          f"launches { {k: v for k, v in launches.items() if v} }")
    print(f"Trainer.fit times: train loop per epoch (host clock, StepTimer) mean "
          f"{epoch_s['mean_s']:.4f} s, p50 {epoch_s['p50_s']:.4f} s, total "
          f"{epoch_s['total_s']:.4f} s; ms per train step inside fit (events around each "
          f"step, epochs 1-{FIT_EPOCHS - 1}) {fit_step_ms:.4f} against phase 11's bare step "
          f"{train_ms['cellblock_hybrid']:.4f}; ms per step of each epoch's loop (first step's "
          f"start to last step's end, over {per_epoch}) {[round(x, 4) for x in loop_ms]}; "
          f"peak memory {fit_peak_gib:.3f} GiB")
    path_launches["Trainer.fit"] = launches
    print(f"phase 12a Trainer slice: {time.perf_counter() - t0:.1f} s")

    # ---- 12b. resume equals continuous ------------------------------------
    t0 = time.perf_counter()
    resume_tc = dataclasses.replace(fit_tc, output_dir=os.path.join(fit_root, "resumed"))
    resumed = Trainer(cfg, stats, resume_tc, len(fit_train), device=dev)
    saved = ckpt_lib.load_state(os.path.join(out_dir, "model_epoch_0"))
    start_epoch = resumed.restore(os.path.join(out_dir, "model_epoch_0"))
    gamma = (fit_tc.final_learning_rate / fit_tc.learning_rate) ** (1 / FIT_EPOCHS)
    lr = resumed.opt_state.optimizer.param_groups[0]["lr"]
    if (start_epoch != 1 or resumed.opt_state.schedule.last_epoch != per_epoch
            or abs(lr - fit_tc.learning_rate * gamma) > 1e-12 * fit_tc.learning_rate
            or not torch.equal(resumed.generator.get_state(), saved["generator"])):
        fail(f"restore: start epoch {start_epoch}, schedule step "
             f"{resumed.opt_state.schedule.last_epoch}, lr {lr}, generator state restored "
             f"{torch.equal(resumed.generator.get_state(), saved['generator'])}")
    # The resumed fit runs with CUDA's sync debug mode on: every call that
    # makes the host wait for the device warns. The loop must make none
    # between two train steps of an epoch (its reads are once an epoch).
    marks, step = [], resumed.train_step

    def sync_calls():
        return [w for w in caught if "synchronizing CUDA operation" in str(w.message)]

    def marked(*step_args):
        first = len(sync_calls())
        out = step(*step_args)
        marks.append((first, len(sync_calls())))
        return out

    resumed.train_step = marked
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            resumed.fit(fit_train, fit_val, start_epoch=start_epoch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    in_step = [end - begin for begin, end in marks]
    sync_sites = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}"
                                     for w in sync_calls()[marks[0][0]:marks[0][1]])
    between = [marks[i + 1][0] - marks[i][1] for i in range(len(marks) - 1)
               if (i + 1) % per_epoch]
    if any(between):
        fail(f"Trainer.fit: synchronizing calls between train steps {between}")
    a = ckpt_lib.load_state(os.path.join(out_dir, f"model_epoch_{FIT_EPOCHS - 1}"))
    b = ckpt_lib.load_state(os.path.join(resume_tc.output_dir, f"model_epoch_{FIT_EPOCHS - 1}"))
    diffs = [float((x - y).abs().max()) for x, y in zip(tree_leaves(a["params"]),
                                                         tree_leaves(b["params"]))]
    for i, state in a["optimizer"]["state"].items():
        other = b["optimizer"]["state"][i]
        diffs += [float((state[key] - other[key]).abs().max())
                  for key in ("step", "exp_avg", "exp_avg_sq")]
    if max(diffs) != 0 or not torch.equal(a["generator"], b["generator"]) \
            or a["schedule"] != b["schedule"] or resumed.history != fitter.history:
        fail(f"resume differs from the continuous run: largest difference {max(diffs)} over "
             f"params and Adam state; generator equal "
             f"{torch.equal(a['generator'], b['generator'])}, schedule equal "
             f"{a['schedule'] == b['schedule']}")
    print(f"resume: model_epoch_0 restored (epoch 1 next, schedule step {per_epoch}, lr {lr:.6g}, "
          f"generator state equal); model_epoch_{FIT_EPOCHS - 1} params and Adam state "
          f"bit-equal to the continuous run's, history equal; synchronizing calls inside each "
          f"train step {in_step}, between the steps of an epoch {between}, "
          f"{len(sync_calls()) - sum(in_step)} in the fit outside its train steps; the first "
          f"step's at "
          f"{dict(sync_sites)}")
    del fitter, resumed, saved, a, b
    fit_tmp.cleanup()
    print(f"phase 12b resume: {time.perf_counter() - t0:.1f} s")

    # ---- 12c. remat -------------------------------------------------------
    # One train step (noise 0, no augmentation, SGD with lr 1: the update is
    # the gradient) with remat, remat_chunk=5 and neither. The recomputation
    # runs each checkpointed step's forward again before its backward, and
    # each chunk's forward again up to its last step's input (torch's
    # early-stopping recomputation): K4 and K5 run M, 2M and
    # 2M + (M / c)(c - 1) times (tests/test_torch_remat.py).
    t0 = time.perf_counter()
    rbatch = train_batch(N, args.seed + 3)
    chunk = 5
    remat_paths = (
        ("cellblock_hybrid", "bf16, fused tail", dict(compute_dtype="bfloat16", fused_tail=None),
         {"knn_codes": 1, "s_decode": 1, "s_onehot": 1, "reverse_table": 1,
          "window_matmul_t": mp, "fused_tail_bwd": mp}, ("window_matmul", "fused_tail")),
        ("gather", "f32, no fused tail", dict(compute_dtype=None, fused_tail=False),
         {"knn_select": 1}, ()),
    )
    for aggregation, label, tc_kw, fixed, recomputed in remat_paths:
        runs = {}
        for name, model_kw, forwards in (
                ("none", {}, mp), ("remat", {"remat": True}, 2 * mp),
                (f"remat_chunk={chunk}", {"remat_chunk": chunk},
                 2 * mp + (mp // chunk) * (chunk - 1))):
            rcfg = cfg._replace(**model_kw)
            tc = TrainConfig(aggregation=aggregation, num_neighbors=K, noise_std=0.0,
                             augment_prob=0.0, **tc_kw)
            sgd = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
            rparams = init_encode_process_decode(rcfg, torch.Generator().manual_seed(args.seed),
                                                 device=dev)
            before = [t.detach().clone() for t in tree_leaves(rparams)]
            step = make_train_step(rcfg, stats, tc, sgd)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            rparams, _, m = step(rparams, sgd.init(rparams), rbatch, torch.Generator(device=dev))
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
            peak = torch.cuda.max_memory_allocated() / 2**30
            expected = {**fixed, **dict.fromkeys(recomputed, forwards)}
            if launches != {**zero, **expected}:
                fail(f"remat {aggregation} {name}: launches {launches}, expected {expected}")
            grads = [b - a.detach() for b, a in zip(before, tree_leaves(rparams))]
            runs[name] = (float(m["loss"]), grads, peak, forwards)
            del rparams, before, step, sgd
        loss, grads = runs["none"][:2]
        for name, (rloss, rgrads, _, _) in runs.items():
            err = max(float((a - b).abs().max()) for a, b in zip(rgrads, grads))
            if rloss != loss or err > REMAT_GRAD_TOL:
                fail(f"remat {aggregation} {name}: loss {rloss} vs {loss}, largest gradient "
                     f"difference {err}")
        peaks = ", ".join(f"{name} {run[2]:.3f} GiB" for name, run in runs.items())
        counts = (f"; K4 and K5 launches {', '.join(str(run[3]) for run in runs.values())}"
                  if recomputed else "")
        print(f"remat {aggregation} {label}: N={N}, loss and every gradient leaf bit-equal to "
              f"the run without remat; peak memory {peaks}{counts}")
    print(f"phase 12c remat: {time.perf_counter() - t0:.1f} s")

    # ---- 13a. K9 against its plain version --------------------------------
    # K9 (the brute-force k-NN that reads its gate on the device) against
    # knn_periodic_reference (512 queries a tile) on the uniform frame, the
    # clustered frame where the certificate fails (30 % in a sigma 0.05
    # ball), the lattice frame (ties) and 10,000 separate queries against
    # the uniform frame, at k = 16 and 48: ids equal, d2 bit-equal. The
    # plain version's stable sort of all N distances is computed once per
    # frame at k = 48; its first 16 columns are the k = 16 answer.
    t0 = time.perf_counter()
    clustered30 = torch.as_tensor(clustered_frame(N, 0.30, 0.05, args.seed + 21), device=dev)
    queries = torch.rand(BRUTE_QUERIES, 3,
                         generator=torch.Generator().manual_seed(args.seed + 5)).to(dev)
    brute_frames = (("uniform", pos0, None), ("clustered30", clustered30, None),
                    ("lattice", lattice, None), (f"{BRUTE_QUERIES} queries", pos0, queries))
    for label, pos, qs in brute_frames:
        ref_ids, ref_d2 = knn_periodic_reference(pos, K1_WIDE_K, 1.0, queries=qs,
                                                 query_tile=512, return_distances=True)
        for k in (K, K1_WIDE_K):
            ids, d2 = knn_periodic(pos, k, 1.0, queries=qs, return_distances=True)
            if not torch.equal(ids, ref_ids[:, :k]):
                fail(f"K9 {label} k={k}: ids differ from the plain version in "
                     f"{int((ids != ref_ids[:, :k]).any(1).sum())} rows")
            if not torch.equal(d2.view(torch.int32),
                               ref_d2[:, :k].contiguous().view(torch.int32)):
                fail(f"K9 {label} k={k}: d2 not bit-equal to the plain version")
        ties = int((ref_d2[:, 1:] == ref_d2[:, :-1]).sum())
        print(f"K9 {label}: ids equal and d2 bit-equal to the plain version at k = {K} and "
              f"{K1_WIDE_K} ({ties} tied neighbor pairs in the k = {K1_WIDE_K} rows)")
    # The gate: set, the buffers keep every bit; clear, they take the search.
    fill_ids = torch.full((N, K), -7, dtype=torch.int64, device=dev)
    fill_d2 = torch.full((N, K), -1.5, dtype=torch.float32, device=dev)
    held = torch.ones((), dtype=torch.bool, device=dev)
    cleared = torch.zeros((), dtype=torch.bool, device=dev)
    buf = (fill_ids.clone(), fill_d2.clone())
    knn_periodic(clustered30, K, 1.0, return_distances=True, skip_if=held, out=buf)
    if not (torch.equal(buf[0], fill_ids)
            and torch.equal(buf[1].view(torch.int32), fill_d2.view(torch.int32))):
        fail("K9 with the gate set changed its output buffer")
    knn_periodic(clustered30, K, 1.0, return_distances=True, skip_if=cleared, out=buf)
    ref_ids, ref_d2 = knn_periodic_reference(clustered30, K, 1.0, return_distances=True)
    if not (torch.equal(buf[0], ref_ids)
            and torch.equal(buf[1].view(torch.int32), ref_d2.view(torch.int32))):
        fail("K9 with the gate clear differs from the plain version")
    print("K9 gate: set, the output buffer is bit-equal to what it held; clear, it holds the "
          "plain version's ids and d2")
    k9_out = torch.empty((N, K), dtype=torch.int64, device=dev)
    k9_ms = time_ms(lambda: knn_periodic(pos0, K, 1.0, out=k9_out), 3)
    k9_graph_ms = graph_ms(lambda: knn_periodic(pos0, K, 1.0, out=k9_out), 3)
    k9_gated_ms = time_ms(lambda: knn_periodic(pos0, K, 1.0, skip_if=held, out=k9_out), 100)
    k9_gated_graph_ms = graph_ms(
        lambda: knn_periodic(pos0, K, 1.0, skip_if=held, out=k9_out), 100)
    k9_plain_ms = time_ms(lambda: knn_periodic_reference(pos0, K, 1.0, query_tile=512), 1)
    k9_48_ms = time_ms(lambda: knn_periodic(pos0, K1_WIDE_K, 1.0), 3)
    # In: the reference set (12 B a point); out: ids [N, k] int64. Per
    # (query, point) pair the code does 21 float32 operations: per axis a
    # subtraction, a division, a rint, a product and a subtraction, then
    # three squares, two sums and a compare with the k-th.
    k9_bytes = nbytes(pos0) + N * K * 8
    k9_ops = 21 * N * N
    report["knn_brute"] = kernel_entry(
        "knn_brute.cu", "neighbors.py:48", 0.0, k9_ms, k9_plain_ms, k9_bytes, k9_ops,
        F32_FLOP_PER_S, None)
    report["knn_brute"].update(
        graph_ms=k9_graph_ms, gated_ms=k9_gated_ms, gated_graph_ms=k9_gated_graph_ms,
        note="no Pallas counterpart: replaces names the JAX package's XLA brute force, "
             "gated there by lax.cond (rollout.py:295)")
    print(f"K9 N={N} k={K}: active {k9_ms:.4f} ms (graph {k9_graph_ms:.4f}), gated "
          f"{k9_gated_ms:.4f} ms (graph {k9_gated_graph_ms:.4f}), plain {k9_plain_ms:.3f} ms, "
          f"bound {report['knn_brute']['bound_ms']:.4f} ms ({k9_ops} operations); "
          f"k={K1_WIDE_K} active {k9_48_ms:.4f} ms")
    print_ptxas(logs, "knn_brute")
    print(f"phase 13a K9: {time.perf_counter() - t0:.1f} s")

    # ---- 13b. the brute-force fallback -----------------------------------
    # exactness_guard="fallback" on gather: at each step K1 searches and K9,
    # gated by K1's certificate on the device, overwrites K1's ids where it
    # fails. On a clustered seed window (the certificate fails every step)
    # the trajectory must equal the brute-force rollout's and differ from
    # the flag guard's; on the uniform window K9 runs gated every step and
    # the trajectory must equal the flag guard's. The fallback must add no
    # synchronizing call to a step.
    t0 = time.perf_counter()
    gather_kw = dict(num_neighbors=K, dtype=torch.bfloat16, aggregation="gather", device=dev)
    cpos, ctemp = (torch.as_tensor(a, device=dev) for a in clustered_window(N, args.seed + 21))
    upos, utemp = (torch.as_tensor(a, device=dev) for a in seed_window(N, args.seed))

    def counted_rollout(pos_w, temp_w, steps, **kw):
        rollout(params, cfg, pos_w, temp_w, stats, 1, **gather_kw, **kw)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = rollout(params, cfg, pos_w, temp_w, stats, steps, **gather_kw, **kw)
        end.record()
        torch.cuda.synchronize()
        return out, dict(kernels.launches), start.elapsed_time(end) / steps

    fallback_runs = (
        ("clustered fallback", cpos, ctemp, dict(exactness_guard="fallback"),
         {"knn_select": 1, "knn_brute": 1}),
        ("clustered bruteforce", cpos, ctemp, dict(neighbor_method="bruteforce"),
         {"knn_brute": 1}),
        ("clustered flag", cpos, ctemp, {}, {"knn_select": 1}),
        ("uniform fallback", upos, utemp, dict(exactness_guard="fallback"),
         {"knn_select": 1, "knn_brute": 1}),
        ("uniform flag", upos, utemp, {}, {"knn_select": 1}),
    )
    runs = {}
    for label, pos_w, temp_w, kw, searches in fallback_runs:
        out, launches, ms = runs[label] = counted_rollout(pos_w, temp_w, FALLBACK_STEPS, **kw)
        per_step = {**searches, "fused_tail": mp}
        expected = {name: c * FALLBACK_STEPS for name, c in per_step.items()}
        if launches != {**zero, **expected}:
            fail(f"{label}: launches {launches}, expected {expected}")
        if not (bool(torch.isfinite(out["Coordinates"]).all())
                and bool(torch.isfinite(out["InternalEnergy"]).all())):
            fail(f"{label}: trajectory not finite")
    flags = {label: run[0]["neighbor_exactness"].tolist() for label, run in runs.items()}
    if any(flags["clustered fallback"]) or flags["clustered fallback"] != flags["clustered flag"]:
        fail(f"clustered window: certificates {flags['clustered fallback']} (fallback), "
             f"{flags['clustered flag']} (flag): must be false every step on both")
    if not (all(flags["uniform fallback"]) and all(flags["uniform flag"])):
        fail(f"uniform window: certificates {flags['uniform fallback']}, {flags['uniform flag']}")

    def max_diff(a, b):
        """Largest difference of the two trajectories (coordinates min-imaged,
        box 1)."""
        d_pos = runs[a][0]["Coordinates"] - runs[b][0]["Coordinates"]
        d_temp = runs[a][0]["InternalEnergy"] - runs[b][0]["InternalEnergy"]
        return max(float((d_pos - torch.round(d_pos)).abs().max()),
                   float(d_temp.abs().max()))

    def bit_equal(a, b):
        return all(torch.equal(runs[a][0][key], runs[b][0][key])
                   for key in ("Coordinates", "InternalEnergy"))

    brute_diff = max_diff("clustered fallback", "clustered bruteforce")
    if not brute_diff <= FALLBACK_TOL:
        fail(f"clustered fallback differs from the brute-force rollout by {brute_diff}")
    flag_diff = min(max_diff("clustered flag", "clustered fallback"),
                    max_diff("clustered flag", "clustered bruteforce"))
    if not flag_diff > 0:
        fail("clustered window: the flag guard's trajectory equals the exact one")
    if not bit_equal("uniform fallback", "uniform flag"):
        fail(f"uniform fallback differs from the flag guard by "
             f"{max_diff('uniform fallback', 'uniform flag')}")
    brute_equal = bit_equal("clustered fallback", "clustered bruteforce")
    print(f"fallback clustered: N={N}, {FALLBACK_STEPS} steps, certificate false every step, "
          f"launches K1, K9 once and K5 {mp} times a step; trajectory "
          f"{'bit-equal' if brute_equal else f'within {FALLBACK_TOL}'} to "
          f"neighbor_method='bruteforce' (max diff {brute_diff:.3g}; K9 once, K1 never a "
          f"step); the flag guard's differs by {flag_diff:.3g}; ms per step fallback "
          f"{runs['clustered fallback'][2]:.4f}, bruteforce "
          f"{runs['clustered bruteforce'][2]:.4f}, flag {runs['clustered flag'][2]:.4f}")
    print(f"fallback uniform: certificate true every step, K9 launched gated every step, "
          f"trajectory bit-equal to the flag guard's; ms per step fallback "
          f"{runs['uniform fallback'][2]:.4f}, flag {runs['uniform flag'][2]:.4f}")
    path_launches["fallback clustered"] = runs["clustered fallback"][1]
    path_ms["gather fallback clustered"] = runs["clustered fallback"][2]
    path_ms["gather fallback uniform"] = runs["uniform fallback"][2]

    def sync_warnings(fn):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return [w for w in caught if "synchronizing CUDA operation" in str(w.message)]

    syncs = {}
    for guard in ("flag", "fallback"):
        counts = [len(sync_warnings(lambda s=steps: rollout(
            params, cfg, upos, utemp, stats, s, exactness_guard=guard, **gather_kw)))
            for steps in (2, 4)]
        syncs[guard] = (counts, (counts[1] - counts[0]) / 2)
    if syncs["fallback"] != syncs["flag"]:
        fail(f"synchronizing calls (2-step, 4-step rollouts; per step) flag {syncs['flag']}, "
             f"fallback {syncs['fallback']}: the fallback must add none")
    print(f"synchronizing calls in a gather rollout from device tensors (2 and 4 steps; per "
          f"step): flag {syncs['flag'][0]}, {syncs['flag'][1]:g}; fallback "
          f"{syncs['fallback'][0]}, {syncs['fallback'][1]:g}")
    # N = 8,192 on a clustered window: the card against the CPU plain path.
    spos_c, stemp_c = clustered_window(SMALL_N, args.seed + 22)
    small_kw = dict(num_neighbors=K, dtype=torch.bfloat16, exactness_guard="fallback")
    small_gpu = rollout(params, cfg, spos_c, stemp_c, stats, SMALL_STEPS, device=dev, **small_kw)
    small_cpu = rollout(params_cpu, cfg, spos_c, stemp_c, stats_cpu, SMALL_STEPS, device="cpu",
                        fused_tail=True, **small_kw)
    small_err = float((small_gpu["Coordinates"].cpu() - small_cpu["Coordinates"]).abs().max())
    if not small_err <= SMALL_COORD_TOL or not torch.equal(
            small_gpu["neighbor_exactness"].cpu(), small_cpu["neighbor_exactness"]):
        fail(f"N={SMALL_N} clustered fallback: card vs CPU plain path max diff {small_err}, "
             f"certificates {small_gpu['neighbor_exactness'].tolist()} vs "
             f"{small_cpu['neighbor_exactness'].tolist()}")
    print(f"fallback check: N={SMALL_N} clustered, {SMALL_STEPS} steps, certificates "
          f"{small_cpu['neighbor_exactness'].tolist()} on both, card vs CPU plain path max "
          f"coordinate diff {small_err:.3g} (tol {SMALL_COORD_TOL})")
    del runs, cpos, ctemp
    print(f"phase 13b fallback: {time.perf_counter() - t0:.1f} s")

    # ---- 13c. sorted_state="on" -------------------------------------------
    # The gather rollout with its window in cell-sorted order, re-sorted at
    # each re-neighboring: bit-equal to the unsorted rollout on the
    # (tie-free) seed window, at R = 1 and 2.
    t0 = time.perf_counter()
    sorted_ms = {}
    for r in (1, 2):
        expected = {"knn_select": STEPS // r, "fused_tail": STEPS * mp}
        pair = {}
        for state in ("on", "off"):
            out, launches, sorted_ms[(state, r)] = counted_rollout(
                upos, utemp, STEPS, sorted_state=state, reneighbor_every=r)
            if launches != {**zero, **expected}:
                fail(f"sorted_state={state} R={r}: launches {launches}, expected {expected}")
            pair[state] = out
        if not all(torch.equal(pair["on"][key], pair["off"][key]) for key in pair["on"]):
            fail(f"sorted_state on vs off at R={r}: max diff "
                 f"{float((pair['on']['Coordinates'] - pair['off']['Coordinates']).abs().max())}")
    print(f"sorted_state: N={N}, {STEPS} steps, on bit-equal to off at R = 1 and 2 (certificate "
          f"too); ms per step on {sorted_ms[('on', 1)]:.4f}, off {sorted_ms[('off', 1)]:.4f} "
          f"(R=1), on {sorted_ms[('on', 2)]:.4f}, off {sorted_ms[('off', 2)]:.4f} (R=2)")
    print(f"phase 13c sorted_state: {time.perf_counter() - t0:.1f} s")

    # ---- 13d. evaluation at full width -----------------------------------
    # validate_one_step on gather and hybrid over an in-memory synthetic
    # simulation (bf16, 4 windows): exact launch counts, and every error the
    # numpy MSE of a direct one_step_prediction of its window, bit for bit.
    # Then render_rollout's body (the CLI after its HDF5 read) for 6 steps
    # with --exactness_guard fallback into a temporary directory.
    t0 = time.perf_counter()
    eval_sim = generate_synthetic_simulation(num_snapshots=EVAL_SNAPSHOTS, num_particles=N,
                                             seed=args.seed + 12)
    eval_paths = (("gather", {"knn_select": 1, "fused_tail": mp}),
                  ("cellblock_hybrid", {"knn_codes": 1, "s_decode": 1, "s_onehot": 1,
                                        "window_matmul": mp, "fused_tail": mp}))
    for aggregation, per_window in eval_paths:
        kw = dict(num_neighbors=K, dtype=torch.bfloat16, aggregation=aggregation, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        result = validate_one_step(params, cfg, eval_sim, stats, WINDOW,
                                   num_timesteps=EVAL_WINDOWS, seed=args.seed, **kw)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        expected = {name: c * EVAL_WINDOWS for name, c in per_window.items()}
        if launches != {**zero, **expected}:
            fail(f"validate_one_step {aggregation}: launches {launches}, expected {expected}")
        for i, t in enumerate(result["tested_timesteps"]):
            new_pos, new_temp = one_step_prediction(
                params, cfg, eval_sim["Coordinates"][t - WINDOW:t],
                eval_sim["InternalEnergy"][t - WINDOW:t], stats, **kw)
            pos_mse = float(np.mean((new_pos.cpu().numpy() - eval_sim["Coordinates"][t]) ** 2))
            temp_mse = float(np.mean((new_temp.cpu().numpy()
                                      - eval_sim["InternalEnergy"][t]) ** 2))
            if (result["position_errors"][i], result["temperature_errors"][i]) != (pos_mse,
                                                                                   temp_mse):
                fail(f"validate_one_step {aggregation}: timestep {t} errors "
                     f"{result['position_errors'][i]}, {result['temperature_errors'][i]} vs a "
                     f"direct one_step_prediction's {pos_mse}, {temp_mse}")
        if not (np.isfinite(result["position_error"])
                and np.isfinite(result["temperature_error"])):
            fail(f"validate_one_step {aggregation}: errors not finite: {result}")
        path_launches[f"validate_one_step {aggregation}"] = launches
        print(f"validate_one_step {aggregation}: N={N}, timesteps {result['tested_timesteps']}, "
              f"position MSE {result['position_error']:.6e}, temperature MSE "
              f"{result['temperature_error']:.6e}, each the MSE of a direct "
              f"one_step_prediction bit for bit; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_render_") as render_dir:
        render_args = render_rollout.parse_args([
            "--model_path", "in-memory", "--test_data", "in-memory", "--metadata_path",
            "in-memory", "--output_dir", render_dir, "--num_steps", str(RENDER_STEPS),
            "--num_neighbors", str(K), "--exactness_guard", "fallback", "--device", "cuda"])
        ground_truth = {key: eval_sim[key] for key in ("Coordinates", "InternalEnergy")}
        printed = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launches()
        with contextlib.redirect_stdout(printed):
            errors = render_rollout.render(render_args, params, cfg, stats, ground_truth)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        printed = printed.getvalue()
        files = sorted(os.listdir(render_dir))
        coords_npy = np.load(os.path.join(render_dir, "rollout_coordinates.npy"))
        temps_npy = np.load(os.path.join(render_dir, "rollout_temperatures.npy"))
        with open(os.path.join(render_dir, "rollout_summary.txt")) as f:
            summary = f.read()
    # The CLI's own default: float32, so no fused tail (K5 takes bf16 only);
    # the exactness check of the seed frame runs the plain cell list. The
    # random weights bunch the particles within a few steps, so the
    # certificate may fail: the fallback's K9 runs, gated or not, every step.
    expected = {"knn_select": RENDER_STEPS, "knn_brute": RENDER_STEPS}
    if launches != {**zero, **expected}:
        fail(f"render_rollout: launches {launches}, expected {expected}")
    frames = WINDOW + RENDER_STEPS
    plotted = "errors.png" in files
    summary_lines = ("Rollout Summary", "Model: in-memory", f"Number of particles: {N}",
                     f"Window size: {WINDOW}", f"Time steps simulated: {RENDER_STEPS}",
                     "Mean position MSE: ", "Mean temperature MSE: ")
    if (coords_npy.shape != (frames, N, 3) or temps_npy.shape != (frames, N, 1)
            or not np.isfinite(coords_npy).all() or not np.isfinite(temps_npy).all()
            or not all(line in summary for line in summary_lines)
            or not np.isfinite(errors["position_errors"]).all()
            or len(errors["position_errors"]) != frames
            or not re.search(r"kNN exactness certificate held for every rollout step|"
                             r"NOTE: \d+/\d+ steps failed the bucketed-kNN certificate and "
                             r"were rerun with exact brute force", printed)
            or (not plotted and "plotting skipped" not in printed)):
        fail(f"render_rollout: files {files}, shapes {coords_npy.shape}, {temps_npy.shape}, "
             f"summary {summary!r}, printed {printed!r}")
    guard_line = next(line for line in printed.splitlines()
                      if "certificate" in line)
    print(f"render_rollout body: N={N}, {RENDER_STEPS} steps, --exactness_guard fallback "
          f"('{guard_line}'), files {files}, trajectories "
          f"{coords_npy.shape} and {temps_npy.shape} finite, summary with the JAX CLI's lines, "
          f"mean position MSE {errors['mean_position_error']:.6e}, "
          f"{'errors.png written' if plotted else 'plotting skipped (no matplotlib)'}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    path_launches["render_rollout"] = launches
    print(f"phase 13d evaluation: {time.perf_counter() - t0:.1f} s")

    # ---- 12. kernels line ------------------------------------------------
    kernels_line = []
    for name, entry in report.items():
        launches = next((counts[name] for counts in path_launches.values() if counts[name]), 0)
        kernels_line.append({"name": name, **entry, "launches": launches})
    rollout_ms = ", ".join(f"{label} {ms:.4f}" for label, ms in path_ms.items())
    print(f"total: {time.perf_counter() - t_all:.1f} s, ms per rollout step {rollout_ms}; ms "
          f"per train step gather {train_ms['gather']:.4f}, cellblock_hybrid "
          f"{train_ms['cellblock_hybrid']:.4f}")
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
