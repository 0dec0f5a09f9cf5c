"""``python -m cosmology_gnn_simulation_tpu_torch.cli.one_step_test`` — the
one-step validation entry point (counterpart of ``cli/one_step_test.py``):
the JAX CLI's flags and report, plus ``--device`` (default ``cuda``, as
``cli.train``; without a CUDA device it raises, nothing falls back).

The model flags stay accepted, but the checkpoint's embedded
``config["model"]`` wins over them. Checkpoints are the port's own
(``state.pt``, ``utils/checkpoint.py``); a JAX Orbax checkpoint is refused,
since its importer is not ported (ROADMAP queue 1 item 2). Flags whose paths
the port lacks (``--aggregation cellblock``, ``--cellblock_variable``)
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from cosmology_gnn_simulation_tpu_torch.config import check_ported
from cosmology_gnn_simulation_tpu_torch.data.hdf5 import read_simulation
from cosmology_gnn_simulation_tpu_torch.evaluation import validate_one_step
from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
    default_model_config,
)
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, resolve_device
from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib


def add_model_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--window_size", type=int, default=5)
    parser.add_argument("--num_neighbors", type=int, default=16)
    parser.add_argument("--latent_size", type=int, default=128)
    parser.add_argument("--mlp_hidden_size", type=int, default=128)
    parser.add_argument("--mlp_num_hidden_layers", type=int, default=2)
    parser.add_argument("--num_message_passing_steps", type=int, default=10)
    parser.add_argument("--output_size", type=int, default=3)
    parser.add_argument("--neighbor_method", type=str, default="auto",
                        choices=["auto", "bruteforce", "celllist", "pallas"])
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the model runs: 'cuda' (default; raises without a "
                             "CUDA device) or 'cpu' (the kernels' plain versions)")


def load_model_from_checkpoint(model_path: str, args, device="cuda"):
    """Restore params on ``device``; prefer the checkpoint's embedded model
    config over the flags."""
    if not os.path.exists(os.path.join(model_path, ckpt_lib.STATE_FILE)):
        if os.path.isdir(model_path):
            raise NotImplementedError(
                f"{model_path} holds no {ckpt_lib.STATE_FILE}: not a checkpoint of the port. "
                "Importing the JAX package's Orbax checkpoints is not ported yet (ROADMAP "
                "queue 1 item 2); on a host with JAX, convert the params with "
                "convert.params_from_jax and save them with utils.checkpoint.save_checkpoint")
        raise FileNotFoundError(f"checkpoint not found: {model_path}")
    restored = ckpt_lib.load_checkpoint(model_path, device)
    params = restored["params"]
    if "config" in restored and "model" in restored["config"]:
        model_config = EncodeProcessDecodeConfig(**restored["config"]["model"])
    else:
        model_config = default_model_config(
            window_size=args.window_size,
            latent_size=args.latent_size,
            mlp_hidden_size=args.mlp_hidden_size,
            mlp_num_hidden_layers=args.mlp_num_hidden_layers,
            num_message_passing_steps=args.num_message_passing_steps,
            output_size=args.output_size,
        )
    return params, model_config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Validate one-step predictions")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--test_data", type=str, required=True)
    parser.add_argument("--metadata_path", type=str, required=True)
    parser.add_argument("--num_timesteps", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0,
                        help="Start-index sampling seed (the reference is "
                             "unseeded here; we default to deterministic)")
    parser.add_argument("--cellblock_variable", action="store_true",
                        help="variable per-column slot capacities (not ported: raises)")
    parser.add_argument("--aggregation", type=str, default="auto",
                        choices=["auto", "gather", "cellblock", "cellblock_hybrid"],
                        help="message-passing aggregation (same surface as "
                             "render_rollout): 'gather' (auto) or the selection-matrix "
                             "path 'cellblock_hybrid' ('cellblock' is not ported: raises)")
    parser.add_argument("--reneighbor_every", type=int, default=1,
                        help="accepted for flag parity with render_rollout; "
                             "one-step evaluation performs exactly one "
                             "neighbor search, so only 1 is valid")
    add_model_flags(parser)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.reneighbor_every != 1:
        parser.error(
            "--reneighbor_every != 1 is meaningless for one-step "
            "evaluation (each window performs exactly one neighbor "
            "search); use render_rollout for neighbor reuse"
        )
    check_ported(args)
    device = resolve_device(args.device)

    with open(args.metadata_path) as f:
        metadata = json.load(f)
    stats = NormalizationStats.from_metadata(metadata, device=device)
    params, model_config = load_model_from_checkpoint(args.model_path, args, device)
    data = read_simulation(args.test_data)

    results = validate_one_step(
        params,
        model_config,
        data,
        stats,
        args.window_size,
        num_neighbors=args.num_neighbors,
        num_timesteps=args.num_timesteps,
        seed=args.seed,
        neighbor_method=args.neighbor_method,
        aggregation=args.aggregation,
        device=device,
    )

    print("\n" + "=" * 50)
    print("ONE-STEP VALIDATION RESULTS")
    print("=" * 50)
    print(f"Number of timesteps tested: {len(results['position_errors'])}")
    print(f"Tested timesteps: {results['tested_timesteps']}")
    print(f"Average position MSE: {results['position_error']:.6e}")
    print(f"Average temperature MSE: {results['temperature_error']:.6e}")
    print(f"Position MSE std: {np.std(results['position_errors']):.6e}")
    print(f"Temperature MSE std: {np.std(results['temperature_errors']):.6e}")
    print("\nPer-timestep breakdown:")
    print(f"{'Timestep':<10} {'Position MSE':<15} {'Temperature MSE'}")
    print("-" * 40)
    for i, ts in enumerate(results["tested_timesteps"]):
        print(f"{ts:<10} {results['position_errors'][i]:<15.6e} "
              f"{results['temperature_errors'][i]:.6e}")
    return results


if __name__ == "__main__":
    main()
