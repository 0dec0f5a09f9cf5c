"""Where a rollout step's time goes on the card.

    python -m cosmology_gnn_simulation_tpu_torch.profile_rollout [--n N] [--steps S]
        [--aggregation gather|cellblock_hybrid]

Runs the rollout of the default model (bf16, k = 16, certificate on) with
the given aggregation once to warm up, times ``--steps`` steps with CUDA
events, then traces the same steps with ``torch.profiler`` and prints the
device time by kernel (largest first), the device's busy share of the
traced window, the device operations (kernels, copies, fills) launched per
step, the peak device memory of the timed run, and the card's name and
power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    default_model_config,
    init_encode_process_decode,
)
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": 1.0, "dt": 0.05,
}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=65536)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--aggregation", default="gather",
                        choices=("gather", "cellblock_hybrid"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_rollout needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    pos = np.remainder(rng.uniform(0, 1, (1, args.n, 3))
                       + rng.normal(0, 5e-4, (5, args.n, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (5, args.n, 1))).astype(np.float32)
    cfg = default_model_config()
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    stats = NormalizationStats.from_metadata(METADATA, device=dev)

    def run():
        return rollout(params, cfg, pos, temp, stats, args.steps, num_neighbors=16,
                       dtype=torch.bfloat16, aggregation=args.aggregation, device=dev)

    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {}
    for e in kernels:
        busy[e.name] = busy.get(e.name, 0.0) + e.device_time / 1e3  # ms
    total = sum(busy.values())
    print(f"{args.aggregation}, N={args.n}, {args.steps} steps: {step_ms:.3f} ms/step (CUDA "
          f"events), peak memory {peak_gib:.3f} GiB; traced window {wall_ms:.1f} ms wall, "
          f"device busy {total:.1f} ms ({100 * total / wall_ms:.1f} %, idle "
          f"{100 - 100 * total / wall_ms:.1f} %), {len(kernels) / args.steps:.1f} device "
          f"operations per step")
    print(f"{'device ms/step':>14} {'share':>6}  kernel")
    for name, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:30]:
        print(f"{ms / args.steps:14.4f} {100 * ms / total:5.1f}%  {name[:110]}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
