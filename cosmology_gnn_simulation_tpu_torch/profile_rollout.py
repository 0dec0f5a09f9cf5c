"""Where a rollout step's (or a train step's) time goes on the card.

    python -m cosmology_gnn_simulation_tpu_torch.profile_rollout [--n N] [--steps S]
        [--aggregation gather|cellblock_hybrid] [--cellblock-search codes|dense]
        [--aux-spec] [--train] [--config4]

Runs the rollout of the default model (bf16, k = 16, certificate on) with
the given aggregation (on the hybrid path: the re-neighboring route of
``--cellblock-search``, and with ``--aux-spec`` the spec of the chooser
without k, on another grid than the k-NN's: plans from neighbor ids) once
to warm up, times ``--steps`` steps with CUDA
events, then traces the same steps with ``torch.profiler`` and prints the
device time of every kernel (largest first), the device's busy share of
the traced window, the device operations (kernels, copies, fills)
launched per step, the peak device memory of the timed run, and the
card's name and power limit. ``--train`` does the same for ``--steps`` train steps (batch
1, noise 3e-4, Adam; the fused tail on) in place of the rollout. ``--config4``
profiles the rollout of BASELINE config 4 instead (N = 500,000, k = 32,
latent = hidden = 256, 15 message-passing steps, bf16, the slot-space
cell-block aggregation on the variable plan: chip_smoke.py's phase 14c).
Needs a CUDA device.
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
from cosmology_gnn_simulation_tpu_torch.ops.cellblock import choose_cellblock_spec
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.training import (
    TrainConfig,
    make_optimizer,
    make_train_step,
)
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
    parser.add_argument("--cellblock-search", default="codes", choices=("codes", "dense"))
    parser.add_argument("--aux-spec", action="store_true")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--config4", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_rollout needs a CUDA device")
    if args.config4 and args.train:
        raise SystemExit("--config4 profiles the rollout only")
    k = 32 if args.config4 else 16
    if args.config4:
        args.n = 500000
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    pos = np.remainder(rng.uniform(0, 1, (1, args.n, 3))
                       + rng.normal(0, 5e-4, (5, args.n, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (5, args.n, 1))).astype(np.float32)
    cfg = (default_model_config(latent_size=256, mlp_hidden_size=256,
                                num_message_passing_steps=15) if args.config4
           else default_model_config())
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    stats = NormalizationStats.from_metadata(METADATA, device=dev)

    spec = choose_cellblock_spec(args.n) if args.aux_spec else None

    def run():
        if args.config4:
            return rollout(params, cfg, pos, temp, stats, args.steps, num_neighbors=k,
                           dtype=torch.bfloat16, aggregation="cellblock",
                           cellblock_variable=True, device=dev)
        return rollout(params, cfg, pos, temp, stats, args.steps, num_neighbors=k,
                       dtype=torch.bfloat16, aggregation=args.aggregation,
                       cellblock_search=args.cellblock_search, cellblock_spec=spec, device=dev)

    if args.train:
        # Six frames: a window of five and its target; temperatures drift.
        tpos = np.remainder(rng.uniform(0, 1, (1, args.n, 3))
                            + rng.normal(0, 5e-4, (6, args.n, 3)).cumsum(0), 1.0)
        ttemp = 1.0 + rng.normal(0, 1e-3, (6, args.n, 1)).cumsum(0)
        batch = {"positions": tpos[None, :5], "temperatures": ttemp[None, :5],
                 "target_positions": tpos[None, 5], "target_temperatures": ttemp[None, 5]}
        tc = TrainConfig(aggregation=args.aggregation, compute_dtype="bfloat16",
                         noise_std=3e-4)
        optimizer = make_optimizer(tc, steps_per_epoch=100)
        state = optimizer.init(params)
        step = make_train_step(cfg, stats, tc, optimizer)
        gen = torch.Generator(device=dev).manual_seed(args.seed)

        def run():  # noqa: F811
            for _ in range(args.steps):
                step(params, state, batch, gen)

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
    what = "train" if args.train else "rollout"
    if args.config4:
        what, args.aggregation = "config-4 rollout (variable plan)", "cellblock"
    elif args.aggregation != "gather" and not args.train:
        what += f" ({args.cellblock_search}{', aux spec' if args.aux_spec else ''})"
    print(f"{what} {args.aggregation}, N={args.n}, {args.steps} steps: {step_ms:.3f} ms/step (CUDA "
          f"events), peak memory {peak_gib:.3f} GiB; traced window {wall_ms:.1f} ms wall, "
          f"device busy {total:.1f} ms ({100 * total / wall_ms:.1f} %, idle "
          f"{100 - 100 * total / wall_ms:.1f} %), {len(kernels) / args.steps:.1f} device "
          f"operations per step")
    print(f"{'device ms/step':>14} {'share':>6}  kernel")
    for name, ms in sorted(busy.items(), key=lambda kv: -kv[1]):
        print(f"{ms / args.steps:14.4f} {100 * ms / total:5.1f}%  {name[:110]}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
