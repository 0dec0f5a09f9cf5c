"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Drives the port's main path — the gather rollout of the default model
(latent 128, 10 message-passing steps) at N = 65,536 particles, k = 16, bf16
operands, re-neighboring every step with the exactness certificate — after
building every CUDA kernel of that path from ``csrc/`` and holding each
kernel against its plain PyTorch version at the shapes the path gives it.
Phases, each timed on its own line:

  1. device and build: the card's name and power limit, one nvcc per kernel
     (all started together), each build's -Xptxas -v report;
  2. K1 (cell-list k-NN) against its plain version on a uniform frame and on
     a frame with cells past capacity (spill): equal ids, bit-equal k-th
     distances and certificate; brute force as the yardstick of exactness;
  3. K5 (fused step tail) against its plain version at [65536, 128];
  4. the slice: launch counts zeroed, 8 rollout steps, counts read (K1 once
     and K5 ten times per step), trajectory finite, certificate true every
     step, ms per step from CUDA events after a warm-up; and a 2-step
     full-width rollout at N = 8,192 against the plain path on the CPU;
  5. one JSON line of every ported kernel: launches on the main path, time,
     bound, plain version's time.

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
SMALL_N, SMALL_STEPS, SMALL_COORD_TOL = 8192, 2, 2e-4

METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": 1.0, "dt": 0.05,
}


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


def seed_window(n: int, seed: int):
    """bench.py's seed frames: uniform base + a small random-walk drift."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (1, n, 3))
    drift = rng.normal(0, 5e-4, (WINDOW, n, 3)).cumsum(axis=0)
    pos = np.remainder(base + drift, 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (WINDOW, n, 1))).astype(np.float32)
    return pos, temp


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
    from cosmology_gnn_simulation_tpu_torch.ops import pallas_knn
    from cosmology_gnn_simulation_tpu_torch.ops.cell_list import choose_cell_grid, f32
    from cosmology_gnn_simulation_tpu_torch.ops.fused_step import (
        fused_step_tail,
        fused_step_tail_reference,
    )
    from cosmology_gnn_simulation_tpu_torch.ops.neighbors import knn_periodic
    from cosmology_gnn_simulation_tpu_torch.rollout import rollout
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

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

    # ---- 2. K1 against its plain version ------------------------------
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
    for label, pos in (("uniform", pos0), ("spill", crammed)):
        table, spill, n_spilled = k1_inputs(pos)
        ids, kth = pallas_knn.knn_select(table, spill, **k1_args)
        ref_ids, ref_kth = pallas_knn.knn_select_reference(table, spill, **k1_args)
        if not torch.equal(ids, ref_ids):
            fail(f"K1 {label}: ids differ from the plain version in "
                 f"{int((ids != ref_ids).any(1).sum())} rows")
        if not torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32)):
            fail(f"K1 {label}: kth not bit-equal to the plain version")
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
              f"{n_spilled} spilled), sets equal to brute force")
        if label == "uniform":
            k1_table, k1_spill = table, spill
            k1_err = float((kth - ref_kth).abs().max())
    kernels.reset_launches()
    k1_ms = time_ms(lambda: pallas_knn.knn_select(k1_table, k1_spill, **k1_args), 50)
    k1_plain_ms = time_ms(lambda: pallas_knn.knn_select_reference(k1_table, k1_spill, **k1_args), 3)
    occ = (k1_table[3] < N).sum(1)  # per cell
    coords = torch.arange(g**3, device=dev)
    ci, cj, cl = coords // (g * g), (coords // g) % g, coords % g
    ring_occ = torch.zeros_like(occ)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                ring_occ += occ[(((ci + dx) % g) * g + (cj + dy) % g) * g + (cl + dz) % g]
    pairs = int((occ * (ring_occ + int((k1_spill[3] < N).sum()))).sum())
    k1_bytes = sum(t.numel() * t.element_size() for t in (*k1_table, *k1_spill)) \
        + g**3 * cap * (K + 1) * 4
    # Per (query, candidate) pair: 3 sub, 3 mul, 2 add, 1 compare with the k-th.
    k1_ops = 9 * pairs
    report["knn_select"] = dict(
        route="cuda", source="cosmology_gnn_simulation_tpu_torch/csrc/knn_select.cu",
        replaces="cosmology_gnn_simulation_tpu/ops/pallas_knn.py:117",
        max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
        bound_ms=max(k1_bytes / HBM_BYTES_PER_S, k1_ops / F32_FLOP_PER_S) * 1e3,
        bound_by="bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / F32_FLOP_PER_S else "operations",
        library_ms=None,
    )
    print(f"K1 time {k1_ms:.4f} ms, plain {k1_plain_ms:.3f} ms; {pairs} occupied pairs, "
          f"{k1_ops} operations, {k1_bytes} bytes")
    print(f"phase 2 K1: {time.perf_counter() - t0:.1f} s")

    # ---- 3. K5 against its plain version -------------------------------
    t0 = time.perf_counter()
    cfg = default_model_config()
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    node = step_params(params, 0)["node"]
    gen = torch.Generator().manual_seed(args.seed + 1)
    x = torch.randn(N, 128, generator=gen).to(dev)
    agg = torch.randn(N, 128, generator=gen).mul(3.0).bfloat16().to(dev)
    out = fused_step_tail(x, agg, node)
    ref = fused_step_tail_reference(x, agg, node)
    err = (out - ref).abs()
    k5_err, k5_mean = float(err.max()), float(err.mean())
    if not (k5_err <= K5_MAX_ABS_TOL and k5_mean <= K5_MEAN_ABS_TOL):
        fail(f"K5 max abs err {k5_err} (tol {K5_MAX_ABS_TOL}), mean {k5_mean} "
             f"(tol {K5_MEAN_ABS_TOL})")
    k5_ms = time_ms(lambda: fused_step_tail(x, agg, node), 200)
    k5_plain_ms = time_ms(lambda: fused_step_tail_reference(x, agg, node), 50)
    k5_bytes = N * 128 * (4 + 2 + 4) + (3 * 128 * 128 + 5 * 128) * 4
    k5_ops = 3 * 2 * N * 128 * 128
    report["fused_tail"] = dict(
        route="cuda", source="cosmology_gnn_simulation_tpu_torch/csrc/fused_tail.cu",
        replaces="cosmology_gnn_simulation_tpu/ops/fused_step.py:66",
        max_abs_err=k5_err, ms=k5_ms, plain_ms=k5_plain_ms,
        bound_ms=max(k5_bytes / HBM_BYTES_PER_S, k5_ops / BF16_TENSOR_FLOP_PER_S) * 1e3,
        bound_by="bytes" if k5_bytes / HBM_BYTES_PER_S >= k5_ops / BF16_TENSOR_FLOP_PER_S
        else "operations",
        library_ms=None,
    )
    print(f"K5 [{N}, 128] bf16: max abs err {k5_err:.3g} (tol {K5_MAX_ABS_TOL}), mean "
          f"{k5_mean:.3g} (tol {K5_MEAN_ABS_TOL}); time {k5_ms:.4f} ms, plain {k5_plain_ms:.4f} ms; "
          f"{k5_ops} operations, {k5_bytes} bytes")
    print(f"phase 3 K5: {time.perf_counter() - t0:.1f} s")

    # ---- 4. the slice ---------------------------------------------------
    t0 = time.perf_counter()
    stats = NormalizationStats.from_metadata(METADATA, device=dev)
    pos, temp = seed_window(N, args.seed)
    kw = dict(num_neighbors=K, dtype=torch.bfloat16, aggregation="gather",
              exactness_guard="flag", reneighbor_every=1, device=dev)
    rollout(params, cfg, pos, temp, stats, 1, **kw)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = rollout(params, cfg, pos, temp, stats, STEPS, **kw)
    end.record()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    step_ms = start.elapsed_time(end) / STEPS
    coords, energy = result["Coordinates"], result["InternalEnergy"]
    if coords.shape != (WINDOW + STEPS, N, 3) or energy.shape != (WINDOW + STEPS, N, 1):
        fail(f"trajectory shapes {tuple(coords.shape)}, {tuple(energy.shape)}")
    if not (bool(torch.isfinite(coords).all()) and bool(torch.isfinite(energy).all())):
        fail("trajectory not finite")
    if not bool(result["neighbor_exactness"].all()):
        fail(f"certificate false on steps {result['neighbor_exactness'].tolist()}")
    expected = {"knn_select": STEPS, "fused_tail": STEPS * cfg.num_message_passing_steps}
    if launches != expected:
        fail(f"launches {launches}, expected {expected}")
    step = coords[-1] - coords[WINDOW - 1]
    moved = float((step - torch.round(step)).abs().max())  # min-image, box 1
    print(f"slice: N={N} k={K} default model bf16, {STEPS} steps, {step_ms:.3f} ms/step "
          f"({N / step_ms * 1e3:.0f} particle-steps/s), launches {launches}, "
          f"certificate true every step, max displacement {moved:.3g}")

    spos, stemp = seed_window(SMALL_N, args.seed + 2)
    params_cpu = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed),
                                            device="cpu")
    small_gpu = rollout(params, cfg, spos, stemp, stats, SMALL_STEPS, **kw)
    small_cpu = rollout(params_cpu, cfg, spos, stemp,
                        NormalizationStats.from_metadata(METADATA, device="cpu"),
                        SMALL_STEPS, **{**kw, "device": "cpu"}, fused_tail=True)
    small_err = float((small_gpu["Coordinates"].cpu() - small_cpu["Coordinates"]).abs().max())
    if not small_err <= SMALL_COORD_TOL:
        fail(f"N={SMALL_N} rollout differs from the CPU plain path by {small_err}")
    print(f"slice check: N={SMALL_N}, {SMALL_STEPS} steps, card vs CPU plain path max "
          f"coordinate diff {small_err:.3g} (tol {SMALL_COORD_TOL})")
    print(f"phase 4 slice: {time.perf_counter() - t0:.1f} s")

    # ---- 5. kernels line -------------------------------------------------
    kernels_line = []
    for name, entry in report.items():
        kernels_line.append({"name": name, "route": entry["route"], "source": entry["source"],
                             "replaces": entry["replaces"], "launches": launches[name],
                             "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
                             "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
                             "bound_by": entry["bound_by"], "library_ms": entry["library_ms"]})
    print(f"total: {time.perf_counter() - t_all:.1f} s, ms per step {step_ms:.4f}")
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
