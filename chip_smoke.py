"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Drives the port's two rollout paths and its two train-step paths of the
default model (latent 128, 10 message-passing steps) at N = 65,536
particles, k = 16, bf16 operands: the gather rollout and the hybrid
cell-block rollout that is the JAX package's main path, re-neighboring
every step with the exactness certificate; then the gather and the hybrid
train step (batch 1, noise 3e-4, Adam, the fused tail). Before that it
builds every CUDA kernel from ``csrc/`` and holds each against its plain
PyTorch version at the shapes the paths give it. Phases, each timed on its
own line:

  1. device and build: the card's name and power limit, one nvcc per source
     (all started together), each build's -Xptxas -v report;
  2. K1 (cell-list k-NN) and its codes mode K1' against their plain versions
     on a uniform frame and on a frame with cells past capacity (spill):
     equal ids / codes, bit-equal k-th distances and certificate; brute
     force as the yardstick of exactness; both modes again at k = 48;
  3. K5 (fused step tail) and K6 (its recompute-backward) against their
     plain versions at [65536, 128], with bf16 and with float32 aggregates;
     K6 also against autograd through the plain forward;
  4. K2 (codes -> S offsets), K3 (int8 S rows), K7 (the reverse table), K4
     (window matmul) and K4^T (its S^T mode) against their plain versions at
     the flagship cell-block spec (K2, K3, K7 on both frames, with the
     transpose certificate reverse_mismatch == 0);
  5. the gather slice: launch counts zeroed, 8 rollout steps, counts read (K1
     once and K5 ten times per step), trajectory finite, certificate true
     every step, ms per step from CUDA events after a warm-up; a 2-step
     full-width rollout at N = 8,192 against the plain path on the CPU;
  6. the hybrid slice: the same for aggregation="cellblock_hybrid" (K1',
     K2, K3 once and K4, K5 ten times per step; the certificate includes no
     column overflow and no dropped edge), its peak device memory, and the
     N = 8,192 check against the CPU plain path and the card's gather path;
  7. the gather train slice: launch counts zeroed, 1 warm-up and 4 timed
     train steps, counts read (K1 once, K5 and K6 ten times per step), loss
     finite every step, ms per step from CUDA events, peak device memory;
  8. the hybrid train slice: the same (K1', K2, K3, K7 once, K4, K4^T, K5,
     K6 ten times per step; cellblock_violations 0 every step); then at
     N = 8,192 one train step of each path on the card against the CPU
     plain path (loss and every gradient), and hybrid against gather;
  9. one JSON line of every ported kernel: launches on its path, time, bound,
     plain version's time, library yardstick's time.

The last line is the contract line ``{"ok": true, "device": {...}}``. Any
failed check raises before it, so the exit code is then not 0. Without a
CUDA device the script exits non-zero at once and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense), for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

N, K, WINDOW, STEPS = 65536, 16, 5, 8
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
    from cosmology_gnn_simulation_tpu_torch.ops.neighbors import knn_periodic
    from cosmology_gnn_simulation_tpu_torch.rollout import rollout
    from cosmology_gnn_simulation_tpu_torch.training import (
        TrainConfig,
        make_optimizer,
        make_train_step,
    )
    from cosmology_gnn_simulation_tpu_torch.training.trainer import Optimizer
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves

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

    k1_args = dict(k=K, n=N, g=g, box=box, mi_start=pallas_knn.min_image_start(cap, spill_cap))
    crammed = pos0.clone()
    # Spill frame: 40 and 30 particles pulled into two cells of capacity cap.
    crammed[:40] = torch.tensor([0.52, 0.31, 0.77], device=dev) + 0.01 * crammed[:40]
    crammed[40:70] = torch.tensor([0.995, 0.002, 0.5], device=dev) + 0.004 * crammed[40:70]
    crammed = torch.remainder(crammed, 1.0)
    frames = (("uniform", pos0), ("spill", crammed))
    for label, pos in frames:
        table, spill, n_spilled = k1_inputs(pos)
        ids, kth = pallas_knn.knn_select(table, spill, **k1_args)
        ref_ids, ref_kth = pallas_knn.knn_select_reference(table, spill, **k1_args)
        if not torch.equal(ids, ref_ids):
            fail(f"K1 {label}: ids differ from the plain version in "
                 f"{int((ids != ref_ids).any(1).sum())} rows")
        if not torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32)):
            fail(f"K1 {label}: kth not bit-equal to the plain version")
        codes, ckth = pallas_knn.knn_codes(table, spill, **k1_args)
        ref_codes, ref_ckth = pallas_knn.knn_codes_reference(table, spill, **k1_args)
        if not torch.equal(codes, ref_codes):
            fail(f"K1' {label}: codes differ from the plain version in "
                 f"{int((codes != ref_codes).any(1).sum())} rows")
        if not torch.equal(ckth.view(torch.int32), ref_ckth.view(torch.int32)):
            fail(f"K1' {label}: kth not bit-equal to the plain version")
        nbr, (ovf, max_d2, excess) = pallas_knn.pallas_cell_list_knn(
            pos, K, 1.0, grid, return_diagnostics=True)
        exact = bool((ovf == 0) & (excess <= 0))
        brute = knn_periodic(pos, K, 1.0, query_tile=1024)
        same = (torch.sort(nbr, 1).values == torch.sort(brute, 1).values).all(1)
        if not exact or not bool(same.all()):
            fail(f"K1 {label}: certificate {exact}, {int((~same).sum())} rows differ "
                 "from brute force")
        if label == "spill" and n_spilled == 0:
            fail("the spill frame spilled no particle")
        print(f"K1 {label}: ids equal, kth bit-equal, certificate true "
              f"(max_d2 {float(max_d2):.6g}, max_excess {float(excess):.6g}, "
              f"{n_spilled} spilled), sets equal to brute force; K1' codes equal, "
              f"kth bit-equal")
        if label == "uniform":
            k1_table, k1_spill = table, spill
            k1_err = float((kth - ref_kth).abs().max())
            k1c_err = float((ckth - ref_ckth).abs().max())
    kernels.reset_launches()
    k1_ms = time_ms(lambda: pallas_knn.knn_select(k1_table, k1_spill, **k1_args), 50)
    k1_plain_ms = time_ms(lambda: pallas_knn.knn_select_reference(k1_table, k1_spill, **k1_args), 3)
    k1c_ms = time_ms(lambda: pallas_knn.knn_codes(k1_table, k1_spill, **k1_args), 50)
    k1c_plain_ms = time_ms(lambda: pallas_knn.knn_codes_reference(k1_table, k1_spill, **k1_args), 3)
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
    print(f"K1 time {k1_ms:.4f} ms, plain {k1_plain_ms:.3f} ms; K1' time {k1c_ms:.4f} ms, "
          f"plain {k1c_plain_ms:.3f} ms; {pairs} occupied pairs, {k1_ops} operations, "
          f"{k1_bytes} bytes")
    # k above the old register cap of 32: the KT = 64 list, both modes.
    grid48 = choose_cell_grid(N, K1_WIDE_K)
    cap48, _, spill48 = pallas_knn.spill_layout(N, K1_WIDE_K, grid48)
    t48 = pallas_knn.build_table(pos0, grid48.grid_size, cap48, box)
    sp48 = pallas_knn.build_spill(pos0, t48.particle_rank, cap48, spill48)
    args48 = dict(k=K1_WIDE_K, n=N, g=grid48.grid_size, box=box,
                  mi_start=pallas_knn.min_image_start(cap48, spill48))
    planes48 = (t48.x, t48.y, t48.z, t48.ids)
    for label, select, plain in (
            ("K1", pallas_knn.knn_select, pallas_knn.knn_select_reference),
            ("K1'", pallas_knn.knn_codes, pallas_knn.knn_codes_reference)):
        picks, kth = select(planes48, sp48, **args48)
        ref_picks, ref_kth = plain(planes48, sp48, **args48)
        if not (torch.equal(picks, ref_picks)
                and torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32))):
            fail(f"{label} k={K1_WIDE_K}: differs from the plain version in "
                 f"{int((picks != ref_picks).any(1).sum())} rows")
    print(f"K1 and K1' k={K1_WIDE_K} (grid {grid48.grid_size}, cap {cap48}): picks equal, "
          f"kth bit-equal to the plain versions")
    print(f"phase 2 K1, K1': {time.perf_counter() - t0:.1f} s")

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
    k5_ms = time_ms(lambda: fused_step_tail(x, agg, node), 200)
    k5_f32_ms = time_ms(lambda: fused_step_tail(x, agg32, node), 200)
    k5_plain_ms = time_ms(lambda: fused_step_tail_reference(x, agg, node), 50)
    k5_bytes = N * 128 * (4 + 2 + 4) + (3 * 128 * 128 + 5 * 128) * 4
    k5_ops = 3 * 2 * N * 128 * 128
    report["fused_tail"] = kernel_entry(
        "fused_tail.cu", "fused_step.py:66", k5_err, k5_ms, k5_plain_ms, k5_bytes, k5_ops,
        BF16_TENSOR_FLOP_PER_S, None)
    print(f"K5 time {k5_ms:.4f} ms (f32 agg {k5_f32_ms:.4f} ms), plain {k5_plain_ms:.4f} ms; "
          f"{k5_ops} operations, {k5_bytes} bytes")
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
    k6_plain_ms = time_ms(lambda: fused_step_tail_bwd_reference(x, agg, g_out, node), 20)
    # In: x, agg (bf16), g and the weights; out: dx, dagg and the gradients.
    # Nine 128 x 128 products a row (three recomputed, six backward).
    k6_bytes = N * 128 * (4 + 2 + 4 + 4 + 2) + 2 * (3 * 128 * 128 + 5 * 128) * 4
    k6_ops = 9 * 2 * N * 128 * 128
    report["fused_tail_bwd"] = kernel_entry(
        "fused_tail_bwd.cu", "fused_step.py:113", k6_err, k6_ms, k6_plain_ms, k6_bytes,
        k6_ops, BF16_TENSOR_FLOP_PER_S, None)
    print(f"K6 time {k6_ms:.4f} ms (f32 agg {k6_f32_ms:.4f} ms), plain {k6_plain_ms:.4f} ms; "
          f"{k6_ops} operations, {k6_bytes} bytes")
    print(f"phase 3 K5, K6: {time.perf_counter() - t0:.1f} s")

    # ---- 4. K2, K3, K4 against their plain versions ----------------------
    t0 = time.perf_counter()
    spec = cellblock.choose_cellblock_spec(N, K)
    codes_cap = pallas_knn.codes_packing_cap(N, K, grid)
    width = spec.s_width
    for label, pos in frames:
        layout = cellblock.cellblock_layout(pos, 1.0, spec)
        _, codes, spill = pallas_knn.pallas_cell_list_knn(pos, K, 1.0, grid, codes_only=True)
        dec_in = cellblock.s_decode_inputs(layout, codes, codes_cap, spill, spec)
        offsets = cellblock.s_decode(*dec_in, spec=spec, codes_cap=codes_cap)
        ref_off = cellblock.s_decode_reference(*dec_in, spec=spec, codes_cap=codes_cap)
        dropped = int((offsets == width + 1).sum())
        if not torch.equal(offsets, ref_off) or dropped != int((ref_off == width + 1).sum()):
            fail(f"K2 {label}: offsets differ from the plain version in "
                 f"{int((offsets != ref_off).sum())} entries")
        s_table = cellblock.s_onehot(offsets, width=width)
        if not torch.equal(s_table, cellblock.s_onehot_reference(offsets, width=width)):
            fail(f"K3 {label}: S table differs from the plain version")
        print(f"K2 {label}: offsets and dropped ({dropped}) equal; K3 {label}: S equal "
              f"({int(s_table.sum(dtype=torch.int64))} edges); overflow "
              f"{int(layout.overflow)}, window_overflow {int(layout.window_overflow)}")
        sc = cellblock.slot_codes(layout, codes, codes_cap, spill, spec)
        packed = cellblock.reverse_candidates(cellblock.sender_packs(sc, codes_cap, spec),
                                              layout, spec)
        s_rev = cellblock.reverse_table(packed, layout.window_starts, spec=spec)
        if not torch.equal(s_rev, cellblock.reverse_table_reference(
                packed, layout.window_starts, spec=spec)):
            fail(f"K7 {label}: reverse table differs from the plain version")
        plan = cellblock.build_cellblock(pos, None, 1.0, spec, with_reverse=True,
                                         neighbor_codes=codes, codes_cap=codes_cap,
                                         codes_spill=spill)
        if not (torch.equal(plan.s_table, s_table) and torch.equal(plan.s_rev_table, s_rev)):
            fail(f"K7 {label}: the plan's tables differ from the kernels' outputs")
        if int(plan.reverse_mismatch) != 0:
            fail(f"K7 {label}: reverse_mismatch {int(plan.reverse_mismatch)}")
        print(f"K7 {label}: S_rev equal to the plain version "
              f"({int(s_rev.sum(dtype=torch.int64))} edges), reverse_mismatch 0")
        del plan
        if label == "uniform":
            k2_in, k2_off, k4_s, k4_starts = dec_in, offsets, s_table, layout.window_starts
            k7_packed, k7_s = packed, s_rev
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

    k2 = lambda: cellblock.s_decode(*k2_in, spec=spec, codes_cap=codes_cap)  # noqa: E731
    k2_ms = time_ms(k2, 200)
    k2_plain_ms = time_ms(lambda: cellblock.s_decode_reference(
        *k2_in, spec=spec, codes_cap=codes_cap), 20)
    # Per edge: ~40 integer operations (divisions, compares, selects),
    # counted against the float32 vector rate (the guide's table has no
    # integer rate); far below the bytes either way.
    k2_bytes = nbytes(*k2_in, k2_off)
    k2_ops = 40 * k2_off.numel()
    report["s_decode"] = kernel_entry(
        "s_decode.cu", "cellblock.py:546", 0.0, k2_ms, k2_plain_ms, k2_bytes, k2_ops,
        F32_FLOP_PER_S, None)

    k3_ms = time_ms(lambda: cellblock.s_onehot(k2_off, width=width), 200)
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
    report["window_matmul"] = kernel_entry(
        "window_matmul.cu", "cellblock.py:2607", k4_err, k4_ms, k4_plain_ms,
        nbytes(k4_s, z_pad, k4_starts, out), k4_ops, BF16_TENSOR_FLOP_PER_S, k4_lib_ms)
    print(f"K2 time {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, {k2_bytes} bytes; "
          f"K3 time {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms, scatter_add_ {k3_lib_ms:.4f} ms; "
          f"K4 time {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, bmm {k4_lib_ms:.4f} ms, "
          f"{k4_nnz} nonzero S entries, dense bf16 work {2 * spec.num_slots * width * 128} FLOP")
    del out, ref, k4_s, z_pad

    # K7's time; K4^T against its plain version on the uniform frame's S_rev.
    k7 = lambda: cellblock.reverse_table(k7_packed, k4_starts, spec=spec)  # noqa: E731
    k7_ms = time_ms(k7, 100)
    k7_plain_ms = time_ms(lambda: cellblock.reverse_table_reference(
        k7_packed, k4_starts, spec=spec), 5)
    # Per window row, k senders matched (a subtraction and two compares
    # each), counted against the float32 vector rate.
    k7_ops = 3 * spec.num_tiles * width * k7_packed.shape[1]
    report["reverse_table"] = kernel_entry(
        "reverse_table.cu", "cellblock.py:2431", 0.0, k7_ms, k7_plain_ms,
        nbytes(k7_packed, k4_starts, k7_s), k7_ops, F32_FLOP_PER_S, None)
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
    print(f"K7 time {k7_ms:.4f} ms, plain {k7_plain_ms:.4f} ms; K4^T time {k4t_ms:.4f} ms, "
          f"plain {k4t_plain_ms:.4f} ms, bmm {k4t_lib_ms:.4f} ms, {k4t_nnz} nonzero S_rev "
          f"entries")
    del out, ref, g_pad, k7_s, k7_packed
    print(f"phase 4 K2, K3, K7, K4, K4^T: {time.perf_counter() - t0:.1f} s")

    # ---- 5, 6. the rollout slices ----------------------------------------
    stats = NormalizationStats.from_metadata(METADATA, device=dev)
    stats_cpu = NormalizationStats.from_metadata(METADATA, device="cpu")
    params_cpu = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed),
                                            device="cpu")
    pos, temp = seed_window(N, args.seed)
    spos, stemp = seed_window(SMALL_N, args.seed + 2)
    mp = cfg.num_message_passing_steps
    zero = dict.fromkeys(kernels.KERNELS, 0)
    path_launches, path_ms, small_runs = {}, {}, {}
    paths = (
        ("gather", 5, {"knn_select": STEPS, "fused_tail": STEPS * mp}),
        ("cellblock_hybrid", 6, {"knn_codes": STEPS, "s_decode": STEPS, "s_onehot": STEPS,
                                 "window_matmul": STEPS * mp, "fused_tail": STEPS * mp}),
    )
    for aggregation, phase, expected in paths:
        t0 = time.perf_counter()
        kw = dict(num_neighbors=K, dtype=torch.bfloat16, aggregation=aggregation,
                  exactness_guard="flag", reneighbor_every=1, device=dev)
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
            fail(f"{aggregation}: trajectory shapes {tuple(coords_out.shape)}, "
                 f"{tuple(energy.shape)}")
        if not (bool(torch.isfinite(coords_out).all()) and bool(torch.isfinite(energy).all())):
            fail(f"{aggregation}: trajectory not finite")
        if not bool(result["neighbor_exactness"].all()):
            fail(f"{aggregation}: certificate false on steps "
                 f"{result['neighbor_exactness'].tolist()}")
        if launches != {**zero, **expected}:
            fail(f"{aggregation}: launches {launches}, expected {expected}")
        step = coords_out[-1] - coords_out[WINDOW - 1]
        moved = float((step - torch.round(step)).abs().max())  # min-image, box 1
        print(f"slice {aggregation}: N={N} k={K} default model bf16, {STEPS} steps, "
              f"{step_ms:.3f} ms/step ({N / step_ms * 1e3:.0f} particle-steps/s), launches "
              f"{ {k: v for k, v in launches.items() if v} }, certificate true every step, "
              f"max displacement {moved:.3g}, peak memory {peak_gib:.3f} GiB")
        path_launches[aggregation], path_ms[aggregation] = launches, step_ms

        small_gpu = rollout(params, cfg, spos, stemp, stats, SMALL_STEPS, **kw)
        small_cpu = rollout(params_cpu, cfg, spos, stemp, stats_cpu, SMALL_STEPS,
                            **{**kw, "device": "cpu"}, fused_tail=True)
        small_err = float((small_gpu["Coordinates"].cpu() - small_cpu["Coordinates"]).abs().max())
        if not small_err <= SMALL_COORD_TOL:
            fail(f"{aggregation}: N={SMALL_N} rollout differs from the CPU plain path "
                 f"by {small_err}")
        if not bool(small_gpu["neighbor_exactness"].all()):
            fail(f"{aggregation}: N={SMALL_N} certificate false")
        small_runs[aggregation] = small_gpu["Coordinates"]
        print(f"slice {aggregation} check: N={SMALL_N}, {SMALL_STEPS} steps, card vs CPU plain "
              f"path max coordinate diff {small_err:.3g} (tol {SMALL_COORD_TOL})")
        if aggregation == "cellblock_hybrid":
            cross = float((small_runs["cellblock_hybrid"] - small_runs["gather"]).abs().max())
            if not cross <= SMALL_COORD_TOL:
                fail(f"N={SMALL_N} hybrid and gather rollouts on the card differ by {cross}")
            print(f"slice check: N={SMALL_N}, hybrid vs gather on the card max coordinate "
                  f"diff {cross:.3g} (tol {SMALL_COORD_TOL})")
        print(f"phase {phase} slice {aggregation}: {time.perf_counter() - t0:.1f} s")

    # ---- 7, 8. the train slices ------------------------------------------
    tbatch = train_batch(N, args.seed)
    train_paths = (
        ("gather", 7, {"knn_select": 1, "fused_tail": mp, "fused_tail_bwd": mp}),
        ("cellblock_hybrid", 8, {"knn_codes": 1, "s_decode": 1, "s_onehot": 1,
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
    print(f"phase 8 train check: {time.perf_counter() - t0:.1f} s")

    # ---- 9. kernels line -------------------------------------------------
    kernels_line = []
    for name, entry in report.items():
        launches = next((counts[name] for counts in path_launches.values() if counts[name]), 0)
        kernels_line.append({"name": name, **entry, "launches": launches})
    print(f"total: {time.perf_counter() - t_all:.1f} s, ms per rollout step gather "
          f"{path_ms['gather']:.4f}, cellblock_hybrid {path_ms['cellblock_hybrid']:.4f}; ms "
          f"per train step gather {train_ms['gather']:.4f}, cellblock_hybrid "
          f"{train_ms['cellblock_hybrid']:.4f}")
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
